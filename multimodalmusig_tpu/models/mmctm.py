"""Multi-Modal Correlated Topic Model (MMCTM) — the flagship.

Re-implementation of the reference's src/MMCTM.jl (634 LoC Julia): a joint
logistic-normal N(μ, Σ) over the concatenated topic space of all modalities
(MK = ΣK_m dims) with per-modality Dirichlet topic-word distributions, fit by
CAVI. A single-modality MMCTM is the classic CTM (reference README.md:67-73).

Accelerator re-architecture (same math; SURVEY.md §7):
  * The per-document E-step loop (src/MMCTM.jl:463-465 `for d: fitdoc!`) is
    batched over all documents: ζ/θ closed forms become block softmaxes and
    einsums over (D, MK) / (D, V_m, K_m) tensors; the per-document NLopt
    LD_MMA solves for λ and ν (src/MMCTM.jl:127-143, 156-170) become the
    vmapped damped-Newton solvers in ops/solvers.py.
  * M-step sufficient statistics (μ, Σ, γ — src/MMCTM.jl:200-242) are batched
    reductions (matmuls); under jax.sharding these reduce across
    the device mesh with XLA-inserted psums.
  * Counts are dense (D, V_m) tensors; responsibilities θ are dense
    (D, V_m, K_m); zero-count cells never contribute to count-weighted sums.
  * The fit loop runs under jit as a lax.while_loop with the reference's
    convergence rule (max rel. Δll over modalities < tol after iteration 10;
    src/MMCTM.jl:485, src/common.jl:48-56).

Documented divergences from reference behavior (bug fixes, not math changes):
  * `:document` init seeds every topic k (the reference loop `for k in
    model.K[m]` at src/MMCTM.jl:71 only seeds topic K_m).
  * `transform` default tol is 1e-4 (reference has the typo tol=1e4,
    src/MMCTM.jl:512) and the copied Σ is accompanied by its inverse (the
    reference copies Σ but leaves invΣ = I, src/MMCTM.jl:515-520, so its
    transform E-step silently uses an identity precision).
  * `predict_modality_eta` tracks a well-defined log-likelihood (softmax(λ)
    mixture under normalized γ); the reference's convergence metric there
    reads uninitialized memory (obsmodel.props is never written before
    calculate_loglikelihoods at src/MMCTM.jl:612; ϕ holds raw unnormalized γ
    copies from the constructor at src/MMCTM.jl:80).
  * Σ is inverted via Cholesky (`cho_solve` against I) rather than LU `inv`
    (src/MMCTM.jl:211) — Σ is SPD by construction; same result, better
    conditioned.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.solvers import maximize_alpha
from ..ops.special import (
    dirichlet_expectation,
    logmvbeta,
    logmvbeta_symmetric,
    safe_xlogy,
    xlogx,
)
from ..utils.formatting import infer_vocab_size, sparse_to_dense
from .ctm_base import (
    CTMBaseConfig,
    carry_converged,
    calculate_Ndivzeta as _base_Ndivzeta,
    calculate_sumtheta as _base_sumtheta,
    counts_per_doc,
    elbo_eta_z_terms,
    props_from_lam,
    run_cavi as _run_cavi_base,
    solve_eta,
    theta_from as ctm_theta_from,
    theta_moments,
    theta_moments_auto,
    spd_inverse as _spd_inverse,
    update_Sigma_mats,
    update_mu_vec,
    update_zeta as _base_update_zeta,
)

# float32 contractions pin HIGHEST: unpinned, a GPU may run them in TF32
# (10 mantissa bits).
_HI = jax.lax.Precision.HIGHEST

__all__ = [
    "MMCTMConfig",
    "MMCTMState",
    "MMCTMFitResult",
    "MMCTM",
    "CTM",
    "transform",
    "fit_heldout",
    "predict_modality_eta",
]


class MMCTMConfig(CTMBaseConfig):
    """Static configuration: topic counts and vocab sizes per modality
    (K at src/MMCTM.jl:2, V at src/MMCTM.jl:6)."""


class MMCTMState(NamedTuple):
    """Variational state (a pytree; per-modality collections are tuples).

    Reference fields (src/MMCTM.jl:1-27) and their layouts here:
      μ (MK,) · Σ/invΣ (MK, MK) · α (M,) — dynamic because autoα refits it
      γ/Elnϕ per modality (K_m, V_m) — reference nests [m][k] vectors
      λ/ν (D, MK) — reference keeps per-document vectors · ζ (D, M)
    props and the point estimate ϕ are derived (props_from/phi_point).

    The responsibilities θ (reference field at src/MMCTM.jl:18, the largest
    tensor at (D, V_m, K_m) per modality) are deliberately NOT stored:
    θ[d,v,:] = softmax(λ_block[d,:] + logw_m[v,:]) is fully determined by
    the λ and log-weight tables it was computed from, so the state carries
    only the tiny (λ_pre, logw_pre) snapshot of the last E-step. This keeps
    the fit loop's carry free of its dominant tensor (XLA fuses the softmax
    straight into the einsums that consume it) and reconstruction via
    `reconstruct_theta` is bit-exact.
    """

    mu: jnp.ndarray
    Sigma: jnp.ndarray
    invSigma: jnp.ndarray
    alpha: jnp.ndarray
    gamma: Tuple[jnp.ndarray, ...]
    Elnphi: Tuple[jnp.ndarray, ...]
    lam: jnp.ndarray
    nu: jnp.ndarray
    zeta: jnp.ndarray
    lam_pre: jnp.ndarray                 # (D, MK) λ used by the last θ update
    logw_pre: Tuple[jnp.ndarray, ...]    # (V_m, K_m) log-weights used then


class MMCTMFitResult(NamedTuple):
    state: MMCTMState
    ll_history: jnp.ndarray  # (maxiter, M)
    n_iters: jnp.ndarray
    converged: jnp.ndarray
    elbo: jnp.ndarray
    ll: jnp.ndarray          # (M,) final per-modality log-likelihood


# ---------------------------------------------------------------------------
# Initialization (src/MMCTM.jl:29-91)
# ---------------------------------------------------------------------------


def init(
    key: jax.Array,
    config: MMCTMConfig,
    X: Sequence[jnp.ndarray],
    init_method: str = "random",
) -> MMCTMState:
    """μ=0, Σ=I, λ=0, ν=1; γ ~ Uniform{1..100} (`random`) or document-seeded
    (`document`), then consistent ζ (src/MMCTM.jl:47-87)."""
    dt = config.dtype
    MK, D, M = config.MK, config.D, config.M

    gamma: List[jnp.ndarray] = []
    keys = jax.random.split(key, M)
    for m in range(M):
        if init_method == "random":
            g = jax.random.randint(keys[m], (config.K[m], config.V[m]), 1, 101).astype(dt)
        elif init_method == "document":
            # seed each topic with one distinct document's counts
            # (fixes the reference's single-topic seeding bug, src/MMCTM.jl:71;
            # falls back to replacement when K_m > D, where the reference's
            # sample(…, replace=false) would throw)
            docs = jax.random.choice(keys[m], D, (config.K[m],), replace=config.K[m] > D)
            g = 1.0 + X[m][docs, :].astype(dt)
        else:
            raise ValueError("init must be 'random' or 'document'")
        gamma.append(g)
    gamma = tuple(gamma)

    lam = jnp.zeros((D, MK), dt)
    nu = jnp.ones((D, MK), dt)
    state = MMCTMState(
        mu=jnp.zeros((MK,), dt),
        Sigma=jnp.eye(MK, dtype=dt),
        invSigma=jnp.eye(MK, dtype=dt),
        alpha=jnp.asarray([0.0] * M, dt),  # caller fills via wrapper/config
        gamma=gamma,
        Elnphi=tuple(dirichlet_expectation(g, axis=1) for g in gamma),
        lam=lam,
        nu=nu,
        zeta=jnp.ones((D, M), dt),
        # zero log-weights ⇒ reconstruct_theta gives the uniform 1/K init θ
        # of the reference (src/MMCTM.jl:52-58) until the first E-step
        lam_pre=lam,
        logw_pre=tuple(
            jnp.zeros((config.V[m], config.K[m]), dt) for m in range(M)
        ),
    )
    return state._replace(zeta=update_zeta(state, config))


# ---------------------------------------------------------------------------
# E-step quantities (src/MMCTM.jl:110-198)
# ---------------------------------------------------------------------------


# Shared with IMMCTM — defined once in ctm_base, re-exported here for the
# test/consumer surface.
calculate_Ndivzeta = _base_Ndivzeta
calculate_sumtheta = _base_sumtheta


def update_zeta(state: MMCTMState, config: MMCTMConfig) -> jnp.ndarray:
    """ζ_dm = Σ_k exp(λ+ν/2) over modality m's block (src/MMCTM.jl:172-181)."""
    return _base_update_zeta(state.lam, state.nu, config)


# θ[d,v,:] = softmax(λ_block[d,:] + logw_m[v,:]) — shared with IMMCTM
# (ctm_base.theta_from); re-exported here because the test oracle and the
# reconstruction helpers address it through this module.
theta_from = ctm_theta_from


def smoothed_logw(state: MMCTMState) -> Tuple[jnp.ndarray, ...]:
    """Training log-weights E[ln ϕ] as (V_m, K_m) tables (src/MMCTM.jl:183-198)."""
    return tuple(e.T for e in state.Elnphi)


def unsmoothed_logw(phi: Sequence[jnp.ndarray]) -> Tuple[jnp.ndarray, ...]:
    """Inference log-weights ln ϕ from point estimates (src/MMCTM.jl:496-509)."""
    return tuple(jnp.log(p).T for p in phi)


def update_theta(state: MMCTMState, config: MMCTMConfig) -> Tuple[jnp.ndarray, ...]:
    """θ[d,v,:] ∝ exp(λ_block[d,:] + Elnϕ_m[:,v]) (src/MMCTM.jl:183-198),
    computed as a stabilized softmax (identical values)."""
    return theta_from(state.lam, smoothed_logw(state), config)


def reconstruct_theta(state: MMCTMState, config: MMCTMConfig) -> Tuple[jnp.ndarray, ...]:
    """The θ of the last E-step, reconstructed exactly from the carried
    (λ_pre, logw_pre) snapshot (see MMCTMState docstring)."""
    return theta_from(state.lam_pre, state.logw_pre, config)


def unsmoothed_update_theta(
    state: MMCTMState, phi: Sequence[jnp.ndarray], config: MMCTMConfig
) -> Tuple[jnp.ndarray, ...]:
    """Inference-mode θ using the point estimate ϕ (src/MMCTM.jl:496-509)."""
    return theta_from(state.lam, unsmoothed_logw(phi), config)


def e_step(
    state: MMCTMState,
    X: Sequence[jnp.ndarray],
    N: jnp.ndarray,
    config: MMCTMConfig,
    logw_fn=smoothed_logw,
):
    """Batched `fitdoc!` (src/MMCTM.jl:450-455): ζ → θ → ν → λ for all docs.

    Matches the reference's within-iteration data flow exactly: θ uses the
    pre-update λ; both solvers use the ζ from the start of the E-step; the
    ν solve uses the pre-update λ. Returns (state, θ) — θ is a per-iteration
    local, never carried (see MMCTMState docstring).

    This is the materializing form (tests and consumers that want θ itself);
    the fit loops use `e_step_moments`, which computes the θ moments via the
    exact softmax factorization without building the (D, V, K) tensor.
    """
    logw = logw_fn(state)
    theta = theta_from(state.lam, logw, config)
    sumtheta = calculate_sumtheta(theta, X, config)
    zeta, nu, lam = solve_eta(
        state.lam, state.nu, N, sumtheta, state.mu, state.invSigma, config,
        lam_prev=state.lam_pre,
    )
    return (
        state._replace(zeta=zeta, lam_pre=state.lam, logw_pre=logw, nu=nu, lam=lam),
        theta,
    )


def e_step_moments(
    state: MMCTMState,
    X: Sequence[jnp.ndarray],
    N: jnp.ndarray,
    config: MMCTMConfig,
    logw_fn=smoothed_logw,
    want_scatter: bool = True,
):
    """`e_step` computing only the θ moments the CAVI iteration consumes:
    sumθ for the λ solve and (optionally) the γ scatter. Default path is the
    exp-factorized matmul schedule (ctm_base.theta_moments — exact same
    math, ~64× fewer exps on BRCA); `MUSIG_THETA_FACTORIZED=0` pins the
    materializing einsum path for A/B runs. Returns (state, scatters)."""
    logw = logw_fn(state)
    sumtheta, scatters = theta_moments_auto(
        state.lam, logw, X, config, want_scatter
    )
    zeta, nu, lam = solve_eta(
        state.lam, state.nu, N, sumtheta, state.mu, state.invSigma, config,
        lam_prev=state.lam_pre,
    )
    return (
        state._replace(zeta=zeta, lam_pre=state.lam, logw_pre=logw, nu=nu, lam=lam),
        scatters,
    )


# ---------------------------------------------------------------------------
# M-step (src/MMCTM.jl:200-269)
# ---------------------------------------------------------------------------


def update_mu(state: MMCTMState) -> MMCTMState:
    """μ = mean_d λ_d (src/MMCTM.jl:200-202)."""
    return state._replace(mu=update_mu_vec(state.lam))


def update_Sigma(state: MMCTMState, config: MMCTMConfig) -> MMCTMState:
    """Σ = (Σ_d diag(ν_d) + (λ_d-μ)(λ_d-μ)ᵀ) / D, then invΣ
    (src/MMCTM.jl:204-212)."""
    Sigma, invSigma = update_Sigma_mats(state.lam, state.nu, state.mu, config.D)
    return state._replace(Sigma=Sigma, invSigma=invSigma)


def update_gamma(
    state: MMCTMState,
    X: Sequence[jnp.ndarray],
    config: MMCTMConfig,
    theta: Sequence[jnp.ndarray] = None,
    scatter: Sequence[jnp.ndarray] = None,
) -> MMCTMState:
    """γ_m[k,v] = α_m + Σ_d X_m[d,v]·θ_m[d,v,k], then E[ln ϕ]
    (src/MMCTM.jl:224-250, 214-222). θ defaults to the last E-step's
    (reconstructed); `scatter` supplies the (K_m, V_m) count-weighted sums
    directly (the fused θ-moments path) instead of contracting θ here."""
    if scatter is None:
        if theta is None:
            theta = reconstruct_theta(state, config)
        scatter = tuple(
            jnp.einsum(
                "dv,dvk->kv", X[m], theta[m], preferred_element_type=config.dtype,
                precision=_HI,
            )
            for m in range(config.M)
        )
    gamma = tuple(state.alpha[m] + scatter[m] for m in range(config.M))
    return state._replace(
        gamma=gamma,
        Elnphi=tuple(dirichlet_expectation(g, axis=1) for g in gamma),
    )


def update_alpha(state: MMCTMState, config: MMCTMConfig) -> MMCTMState:
    """Per-modality symmetric Dirichlet MLE of α (src/MMCTM.jl:252-269)."""
    alphas = []
    for m in range(config.M):
        sum_Elnphi = jnp.sum(state.Elnphi[m])
        alphas.append(
            maximize_alpha(state.alpha[m], sum_Elnphi, config.K[m], config.V[m])
        )
    return state._replace(alpha=jnp.stack(alphas))


props_from = props_from_lam


def phi_point(gamma: Sequence[jnp.ndarray]) -> Tuple[jnp.ndarray, ...]:
    """Point estimate ϕ_m[k, :] = γ_m[k, :] / Σ_v γ (src/MMCTM.jl:244-250)."""
    return tuple(g / g.sum(axis=1, keepdims=True) for g in gamma)


# ---------------------------------------------------------------------------
# ELBO (src/MMCTM.jl:271-382)
# ---------------------------------------------------------------------------


def elbo_terms(
    state: MMCTMState, X: Sequence[jnp.ndarray], N: jnp.ndarray, config: MMCTMConfig
) -> dict:
    """The 7 named ELBO terms of src/MMCTM.jl:271-370 as a dict
    {ElnPphi, ElnPeta, ElnPZ, ElnPX, ElnQphi, ElnQeta, ElnQZ}; the ELBO is
    P-terms minus Q-terms. Exposed per-term so the reference's pending
    per-term tests (test/mmctm.jl:295-335) run live here. Uses the last
    E-step's θ (reconstructed from the carried snapshot)."""
    from .ctm_base import elbo_eta_z_term_dict

    dt = config.dtype
    theta = reconstruct_theta(state, config)

    # ElnPϕ (src/MMCTM.jl:271-284)
    ElnPphi = jnp.zeros((), dt)
    for m in range(config.M):
        ElnPphi += -config.K[m] * logmvbeta_symmetric(state.alpha[m], config.V[m])
        ElnPphi += (state.alpha[m] - 1.0) * jnp.sum(state.Elnphi[m])

    # ElnPη + ElnPZ − ElnQη (src/MMCTM.jl:286-318, 354-360) — shared base
    terms = elbo_eta_z_term_dict(
        state.lam, state.nu, state.zeta, state.mu, state.invSigma,
        theta, X, N, config,
    )

    # ElnPX (src/MMCTM.jl:320-338)
    ElnPX = jnp.zeros((), dt)
    for m in range(config.M):
        ElnPX += jnp.einsum(
            "dv,dvk,kv->", X[m], theta[m], state.Elnphi[m], precision=_HI
        )

    # ElnQϕ (src/MMCTM.jl:340-352)
    ElnQphi = jnp.zeros((), dt)
    for m in range(config.M):
        ElnQphi += jnp.sum(-logmvbeta(state.gamma[m], axis=1))
        ElnQphi += jnp.sum((state.gamma[m] - 1.0) * state.Elnphi[m])

    # ElnQZ (src/MMCTM.jl:362-370) — count-weighted here (unlike LDA's)
    ElnQZ = jnp.zeros((), dt)
    for m in range(config.M):
        ElnQZ += jnp.einsum("dv,dvk->", X[m], xlogx(theta[m]), precision=_HI)

    return {
        "ElnPphi": ElnPphi,
        "ElnPeta": terms["ElnPeta"],
        "ElnPZ": terms["ElnPZ"],
        "ElnPX": ElnPX,
        "ElnQphi": ElnQphi,
        "ElnQeta": terms["ElnQeta"],
        "ElnQZ": ElnQZ,
    }


def calculate_elbo(
    state: MMCTMState, X: Sequence[jnp.ndarray], N: jnp.ndarray, config: MMCTMConfig
) -> jnp.ndarray:
    """The 7-term logistic-normal + Dirichlet ELBO with the Blei-Lafferty
    ζ bound (src/MMCTM.jl:271-382). Uses the last E-step's θ (reconstructed
    from the carried snapshot), exactly as the reference computes the final
    ELBO from the θ of the last fitdoc! (src/MMCTM.jl:490)."""
    t = elbo_terms(state, X, N, config)
    return (
        t["ElnPphi"] + t["ElnPeta"] + t["ElnPZ"] + t["ElnPX"]
        - t["ElnQphi"] - t["ElnQeta"] - t["ElnQZ"]
    )


# ---------------------------------------------------------------------------
# Log-likelihood (src/MMCTM.jl:384-448)
# ---------------------------------------------------------------------------


def modality_loglikelihoods(
    X: Sequence[jnp.ndarray],
    props: Sequence[jnp.ndarray],
    phi: Sequence[jnp.ndarray],
) -> jnp.ndarray:
    """(M,) per-modality per-word mixture log-likelihood: for each modality,
    Σ_d Σ_v X·log(Σ_k props·ϕ) / Σ_d N_d (src/MMCTM.jl:384-448; the doc-level
    weighting by N_d cancels to this form, and zero-count docs contribute 0)."""
    out = []
    for m in range(len(X)):
        P = jnp.matmul(props[m], phi[m], precision=_HI)  # (D, V_m)
        out.append(jnp.sum(safe_xlogy(X[m], P)) / jnp.sum(X[m]))
    return jnp.stack(out)


def doc_modality_loglikelihood(
    Xdm: jnp.ndarray, props: jnp.ndarray, phi: jnp.ndarray
) -> jnp.ndarray:
    """Single doc x modality log-likelihood / N (src/MMCTM.jl:384-401)."""
    P = jnp.matmul(props, phi, precision=_HI)
    return jnp.sum(safe_xlogy(Xdm, P)) / jnp.sum(Xdm)


def docmodality_loglikelihoods(
    X: Sequence[jnp.ndarray],
    props: Sequence[jnp.ndarray],
    phi: Sequence[jnp.ndarray],
) -> jnp.ndarray:
    """(D, M) per-document per-modality normalized mixture log-likelihood —
    the full matrix behind `calculate_docmodality_loglikelihood`
    (src/MMCTM.jl:384-401), computed batched. Entries for documents with zero
    counts in a modality are NaN (the reference's per-document form divides
    by N_d=0; its modality aggregation skips such docs, as does
    `modality_loglikelihoods` here)."""
    cols = []
    for m in range(len(X)):
        P = jnp.matmul(props[m], phi[m], precision=_HI)  # (D, V_m)
        cols.append(jnp.sum(safe_xlogy(X[m], P), axis=1) / jnp.sum(X[m], axis=1))
    return jnp.stack(cols, axis=1)


# ---------------------------------------------------------------------------
# Fit loops (src/MMCTM.jl:450-634)
# ---------------------------------------------------------------------------


_run_cavi = _run_cavi_base


def fit_step_fn(
    X: Sequence[jnp.ndarray],
    N: jnp.ndarray,
    config: MMCTMConfig,
    autoalpha: bool = False,
    update_sigma: bool = True,
):
    """One full CAVI iteration as a closure (src/MMCTM.jl:463-479):
    batched E-step (ζ/θ/ν/λ ∀d) → μ → Σ (if update_sigma) → γ → α (if
    autoalpha) → per-modality log-likelihoods from softmax(λ) and
    normalized γ.

    The θ moments come from the exp-factorized matmul schedule
    (ctm_base.theta_moments via e_step_moments). A fused Pallas θ-moments
    kernel was built and measured SLOWER than XLA's fused einsums at
    benchmark shapes (1.44 s vs 1.10 s for the 100-restart BRCA fit — XLA
    already avoids materializing θ per restart lane at these sizes, and
    per-modality kernel launches under the vmap batching rule cost more
    than they save); it lives on as a measured experiment in
    tools/pallas_experiments/theta_kernel.py."""

    def step(s):
        s, scatters = e_step_moments(s, X, N, config)
        s = update_mu(s)
        if update_sigma:
            s = update_Sigma(s, config)
        s = update_gamma(s, X, config, scatter=scatters)
        if autoalpha:
            s = update_alpha(s, config)
        ll_i = modality_loglikelihoods(X, props_from(s.lam, config), phi_point(s.gamma))
        return s, ll_i

    return step


def finalize_fit(carry, X, N, config: MMCTMConfig) -> MMCTMFitResult:
    """Turn a finished CAVI carry into an MMCTMFitResult (final ELBO as at
    src/MMCTM.jl:490)."""
    state, ll_buf, n_iters, done = carry
    return MMCTMFitResult(
        state=state,
        ll_history=ll_buf,
        n_iters=n_iters,
        converged=carry_converged(ll_buf, n_iters, done),
        elbo=calculate_elbo(state, X, N, config),
        ll=ll_buf[n_iters - 1],
    )


def fit(
    state: MMCTMState,
    X: Sequence[jnp.ndarray],
    config: MMCTMConfig,
    maxiter: int = 100,
    tol: float = 1e-4,
    verbose: bool = False,
    autoalpha: bool = False,
    update_sigma: bool = True,
) -> MMCTMFitResult:
    """Full MMCTM CAVI (src/MMCTM.jl:457-494). Pure; jit/vmap-safe."""
    X = tuple(X)
    N = counts_per_doc(X)
    step = fit_step_fn(X, N, config, autoalpha, update_sigma)
    carry = _run_cavi(state, config, maxiter, tol, step, verbose)
    return finalize_fit(carry, X, N, config)


def transform_states(
    trained: MMCTMState,
    state: MMCTMState,
    Xnew: Sequence[jnp.ndarray],
    config: MMCTMConfig,
    maxiter: int = 1000,
    tol: float = 1e-4,
    fit_gaussian: bool = False,
    verbose: bool = False,
) -> MMCTMFitResult:
    """Fold in new documents against the trained point estimate ϕ
    (src/MMCTM.jl:511-552). When fit_gaussian is False, μ/Σ/invΣ come from
    the trained model (invΣ included — see module docstring); when True they
    are refit from the new documents each iteration."""
    Xnew = tuple(Xnew)
    N = counts_per_doc(Xnew)
    phi = phi_point(trained.gamma)
    # Copy the trained topic posterior so the returned state (and its ELBO)
    # is coherent — the reference copies only the point estimate ϕ and leaves
    # γ at random init (src/MMCTM.jl:515-517), but it also never computes an
    # ELBO during transform; the round-1 placeholder elbo=0.0 here was a
    # silent wrong-number trap.
    state = state._replace(gamma=trained.gamma, Elnphi=trained.Elnphi)
    if not fit_gaussian:
        state = state._replace(
            mu=trained.mu, Sigma=trained.Sigma, invSigma=_spd_inverse(trained.Sigma)
        )

    logw_phi = unsmoothed_logw(phi)

    def step(s):
        s, _ = e_step_moments(
            s, Xnew, N, config, logw_fn=lambda st: logw_phi, want_scatter=False
        )
        if fit_gaussian:
            s = update_mu(s)
            s = update_Sigma(s, config)
        ll_i = modality_loglikelihoods(Xnew, props_from(s.lam, config), phi)
        return s, ll_i

    state, ll_buf, n_iters, done = _run_cavi(state, config, maxiter, tol, step, verbose)
    return MMCTMFitResult(
        state=state,
        ll_history=ll_buf,
        n_iters=n_iters,
        converged=carry_converged(ll_buf, n_iters, done),
        elbo=calculate_elbo(state, Xnew, N, config),
        ll=ll_buf[n_iters - 1],
    )


def fit_heldout_states(
    trained: MMCTMState,
    state: MMCTMState,
    Xheldout: Sequence[jnp.ndarray],
    config: MMCTMConfig,
    maxiter: int = 100,
    tol: float = 1e-4,
    verbose: bool = False,
) -> MMCTMFitResult:
    """Doc-side refit with copied global posterior (μ/Σ/invΣ/γ/Elnϕ/ϕ),
    smoothed θ updates (src/MMCTM.jl:554-586)."""
    Xheldout = tuple(Xheldout)
    N = counts_per_doc(Xheldout)
    state = state._replace(
        mu=trained.mu,
        Sigma=trained.Sigma,
        invSigma=trained.invSigma,
        gamma=trained.gamma,
        Elnphi=trained.Elnphi,
        alpha=trained.alpha,
    )
    phi = phi_point(trained.gamma)

    def step(s):
        s, _ = e_step_moments(s, Xheldout, N, config, want_scatter=False)
        ll_i = modality_loglikelihoods(Xheldout, props_from(s.lam, config), phi)
        return s, ll_i

    state, ll_buf, n_iters, done = _run_cavi(state, config, maxiter, tol, step, verbose)
    return MMCTMFitResult(
        state=state,
        ll_history=ll_buf,
        n_iters=n_iters,
        converged=carry_converged(ll_buf, n_iters, done),
        elbo=calculate_elbo(state, Xheldout, N, config),
        ll=ll_buf[n_iters - 1],
    )


def predict_modality_eta_states(
    trained: MMCTMState,
    obs_state: MMCTMState,
    Xobs: Sequence[jnp.ndarray],
    m: int,
    config: MMCTMConfig,
    obs_config: MMCTMConfig,
    maxiter: int = 100,
    tol: float = 1e-4,
    verbose: bool = False,
):
    """Cross-modality imputation (src/MMCTM.jl:588-634): fit the remaining
    modalities' document posteriors with the trained topics, then predict the
    held-out modality's η by the reference's linear conditioning
    η = μ_u + Σ_uo · invΣ_oo · (λ_d − μ_o), where invΣ_oo is the [obs,obs]
    slice of the *full* inverse (exactly as src/MMCTM.jl:625-631 — note this
    differs from textbook Gaussian conditioning, which would use inv(Σ_oo);
    we reproduce the reference's estimator).
    """
    MK = config.MK
    o = config.offsets[m]
    unobs = np.arange(o, o + config.K[m])
    obs = np.setdiff1d(np.arange(MK), unobs)

    Xobs = tuple(Xobs)
    N = counts_per_doc(Xobs)
    obs_state = obs_state._replace(
        mu=trained.mu[obs],
        Sigma=trained.Sigma[np.ix_(obs, obs)],
        invSigma=trained.invSigma[np.ix_(obs, obs)],
        gamma=tuple(trained.gamma[i] for i in range(config.M) if i != m),
        Elnphi=tuple(trained.Elnphi[i] for i in range(config.M) if i != m),
    )
    phi = phi_point(obs_state.gamma)

    def step(s):
        s, _ = e_step_moments(s, Xobs, N, obs_config, want_scatter=False)
        ll_i = modality_loglikelihoods(Xobs, props_from(s.lam, obs_config), phi)
        return s, ll_i

    obs_state, ll_buf, n_iters, done = _run_cavi(
        obs_state, obs_config, maxiter, tol, step, verbose
    )
    converged = carry_converged(ll_buf, n_iters, done)
    gain = jnp.matmul(
        trained.Sigma[np.ix_(unobs, obs)], trained.invSigma[np.ix_(obs, obs)],
        precision=_HI,
    )
    eta = trained.mu[unobs][None, :] + jnp.matmul(
        obs_state.lam - trained.mu[obs][None, :], gain.T, precision=_HI
    )
    return eta, obs_state, converged


# ---------------------------------------------------------------------------
# Stateful wrapper mirroring the Julia API (src/MMCTM.jl:29-108)
# ---------------------------------------------------------------------------


class MMCTM:
    """Stateful wrapper with the reference's constructor/field surface.

    ``MMCTM(k, α, X)`` or ``MMCTM(k, α, V, X)`` where X[doc][modality] is an
    (n, 2) 1-based (vocab_index, count) matrix (src/MMCTM.jl:29-108).
    """

    def __init__(self, k, alpha, *args, init: str = "random", seed: int = 0, dtype=None):
        if len(args) == 2:
            V, X = args
        elif len(args) == 1:
            X = args[0]
            V = [
                infer_vocab_size([doc[m] for doc in X])
                for m in range(len(k))
            ]
        else:
            raise TypeError("MMCTM(k, alpha, [V,] X)")
        if len(alpha) != len(k):
            raise ValueError("alpha must have one entry per modality")
        dtype = dtype or (jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
        self.X = [[np.asarray(doc[m]) for m in range(len(k))] for doc in X]
        self.config = MMCTMConfig(K=tuple(int(x) for x in k), V=tuple(int(v) for v in V), D=len(X), dtype=dtype)
        self.Xdense = tuple(
            jnp.asarray(
                sparse_to_dense([doc[m] for doc in self.X], self.config.V[m]),
                dtype=dtype,
            )
            for m in range(self.config.M)
        )
        self.state = init_with_alpha(
            jax.random.key(seed), self.config, self.Xdense, alpha, init
        )
        self.converged = False
        self.elbo = None
        self.ll = None

    # -- reference scalar fields --
    @property
    def K(self):
        return list(self.config.K)

    @property
    def D(self):
        return self.config.D

    @property
    def M(self):
        return self.config.M

    @property
    def V(self):
        return list(self.config.V)

    @property
    def N(self):
        return [
            [int(np.asarray(doc[m])[:, 1].sum()) if len(doc[m]) else 0 for m in range(self.M)]
            for doc in self.X
        ]

    # -- reference arrays, reference layouts --
    @property
    def mu(self):
        return np.asarray(self.state.mu)

    @property
    def Sigma(self):
        return np.asarray(self.state.Sigma)

    @property
    def invSigma(self):
        return np.asarray(self.state.invSigma)

    @property
    def alpha(self):
        return [float(a) for a in np.asarray(self.state.alpha)]

    @property
    def props(self):
        p = [np.asarray(x) for x in props_from(self.state.lam, self.config)]
        return [[p[m][d] for m in range(self.M)] for d in range(self.D)]

    @property
    def phi(self):
        ph = [np.asarray(x) for x in phi_point(self.state.gamma)]
        return [[ph[m][k] for k in range(self.config.K[m])] for m in range(self.M)]

    @property
    def gamma(self):
        return [
            [np.asarray(self.state.gamma[m][k]) for k in range(self.config.K[m])]
            for m in range(self.M)
        ]

    @property
    def Elnphi(self):
        return [
            [np.asarray(self.state.Elnphi[m][k]) for k in range(self.config.K[m])]
            for m in range(self.M)
        ]

    @property
    def lam(self):
        return [np.asarray(self.state.lam[d]) for d in range(self.D)]

    @property
    def nu(self):
        return [np.asarray(self.state.nu[d]) for d in range(self.D)]

    @property
    def zeta(self):
        return [np.asarray(self.state.zeta[d]) for d in range(self.D)]

    @property
    def theta(self):
        """θ[d][m] as (K_m, n_dm) over the doc's sparse rows (reference
        layout), reconstructed from the carried (λ_pre, logw_pre) snapshot
        (exactly the last E-step's θ)."""
        dense = [
            np.asarray(t) for t in reconstruct_theta(self.state, self.config)
        ]
        out = []
        for d, doc in enumerate(self.X):
            row = []
            for m in range(self.M):
                idx = doc[m][:, 0].astype(np.int64) - 1
                row.append(dense[m][d, idx, :].T)
            out.append(row)
        return out

    # unicode aliases matching the Julia field names
    μ = mu
    Σ = Sigma
    invΣ = invSigma
    α = alpha
    ϕ = phi
    γ = gamma
    Elnϕ = Elnphi
    λ = lam
    ν = nu
    ζ = zeta
    θ = theta

    def fit(
        self,
        maxiter: int = 100,
        tol: float = 1e-4,
        verbose: bool = True,
        autoalpha: bool = False,
        update_sigma: bool = True,
        **kwargs,
    ):
        """`fit!` (src/MMCTM.jl:457-494). Returns the per-iteration list of
        per-modality log-likelihoods. Accepts the Julia keyword spellings
        autoα / updateΣ."""
        autoalpha = kwargs.pop("autoα", autoalpha)
        update_sigma = kwargs.pop("updateΣ", update_sigma)
        if kwargs:
            raise TypeError(f"unexpected kwargs: {sorted(kwargs)}")
        if verbose:
            from .ctm_base import resolved_budgets

            # float32 fits silently resolve the warm-start solver caps
            # (measured on BRCA/PCAWG) — surface them so users of harsher
            # data know what to raise (config fields or
            # MUSIG_F32_FULL_BUDGETS=1; see ctm_base.resolved_budgets)
            print(f"inner-solver budgets: {resolved_budgets(self.config)}")
        result = jax.jit(
            fit,
            static_argnames=("config", "maxiter", "tol", "verbose", "autoalpha", "update_sigma"),
        )(
            self.state,
            self.Xdense,
            self.config,
            maxiter=maxiter,
            tol=tol,
            verbose=verbose,
            autoalpha=autoalpha,
            update_sigma=update_sigma,
        )
        self.state = result.state
        n = int(result.n_iters)
        self.converged = bool(result.converged)
        self.elbo = float(result.elbo)
        self.ll = list(np.asarray(result.ll, dtype=np.float64))
        return [list(row) for row in np.asarray(result.ll_history[:n], dtype=np.float64)]

    fit_ = fit

    def __repr__(self):
        status = (
            f"fitted, ll={[round(v, 5) for v in self.ll]}" if self.ll is not None else "unfitted"
        )
        return f"MMCTM(K={self.K}, D={self.D}, V={self.V}, {status})"


def init_with_alpha(key, config, Xdense, alpha, init_method="random"):
    """init() plus the user's α vector (the reference stores α in the model,
    src/MMCTM.jl:35)."""
    state = init(key, config, Xdense, init_method)
    return state._replace(alpha=jnp.asarray(alpha, config.dtype))


class CTM(MMCTM):
    """Single-modality MMCTM = classic correlated topic model
    (reference README.md:67-73)."""

    def __init__(self, k: int, alpha: float, *args, **kwargs):
        if len(args) == 2:
            V, X = args
            V = [V] if isinstance(V, int) else list(V)
            super().__init__([k], [alpha], V, X, **kwargs)
        elif len(args) == 1:
            super().__init__([k], [alpha], args[0], **kwargs)
        else:
            raise TypeError("CTM(k, alpha, [V,] X) with X from format_counts_ctm")


def transform(
    model: MMCTM,
    X,
    maxiter: int = 1000,
    tol: float = 1e-4,
    fit_gaussian: bool = False,
    verbose: bool = False,
) -> MMCTM:
    """Reference `transform(model, X)` (src/MMCTM.jl:511-552): returns a new
    fitted MMCTM over the new documents with frozen topics.

    Divergences (documented in the module docstring): default tol is 1e-4
    (reference typo: 1e4), and invΣ is kept consistent with the copied Σ.
    """
    newmodel = MMCTM(
        model.K, model.alpha, model.V, X, dtype=model.config.dtype
    )
    # ll under the *trained* ϕ, as the reference freezes newmodel.ϕ
    newmodel.state = newmodel.state._replace(gamma=model.state.gamma)
    result = jax.jit(
        transform_states,
        static_argnames=("config", "maxiter", "tol", "fit_gaussian", "verbose"),
    )(
        model.state,
        newmodel.state,
        newmodel.Xdense,
        newmodel.config,
        maxiter=maxiter,
        tol=tol,
        fit_gaussian=fit_gaussian,
        verbose=verbose,
    )
    newmodel.state = result.state
    if not fit_gaussian:
        # keep Σ bit-identical to the trained model (test/mmctm.jl:390-404)
        newmodel.state = newmodel.state._replace(
            mu=model.state.mu, Sigma=model.state.Sigma, invSigma=model.state.invSigma
        )
    newmodel.converged = bool(result.converged)
    newmodel.elbo = float(result.elbo)
    newmodel.ll = list(np.asarray(result.ll, dtype=np.float64))
    return newmodel


def fit_heldout(Xheldout, model: MMCTM, maxiter: int = 100, verbose: bool = False) -> MMCTM:
    """Reference `fit_heldout` (src/MMCTM.jl:554-586)."""
    heldout = MMCTM(model.K, model.alpha, model.V, Xheldout, dtype=model.config.dtype)
    result = jax.jit(
        fit_heldout_states,
        static_argnames=("config", "maxiter", "tol", "verbose"),
    )(
        model.state,
        heldout.state,
        heldout.Xdense,
        heldout.config,
        maxiter=maxiter,
        verbose=verbose,
    )
    heldout.state = result.state
    heldout.converged = bool(result.converged)
    heldout.elbo = float(result.elbo)
    heldout.ll = list(np.asarray(result.ll, dtype=np.float64))
    return heldout


def predict_modality_eta(
    Xobs, m: int, model: MMCTM, maxiter: int = 100, verbose: bool = False
):
    """Reference `predict_modality_η(Xobs, m, model)` (src/MMCTM.jl:588-634).

    `m` is the 1-based modality index to predict, as in the Julia API; Xobs
    holds the remaining modalities in their original order. Returns a list of
    per-document η arrays (length K[m]).
    """
    if not 1 <= m <= model.M:
        raise ValueError(f"m must be a 1-based modality index in 1..{model.M}, got {m}")
    if model.M < 2:
        raise ValueError("predict_modality_eta needs at least two modalities")
    m0 = m - 1
    obsM = [i for i in range(model.M) if i != m0]
    obs_model = MMCTM(
        [model.K[i] for i in obsM],
        [model.alpha[i] for i in obsM],
        [model.V[i] for i in obsM],
        Xobs,
        dtype=model.config.dtype,
    )
    eta, obs_state, converged = jax.jit(
        predict_modality_eta_states,
        static_argnames=("m", "config", "obs_config", "maxiter", "tol", "verbose"),
    )(
        model.state,
        obs_model.state,
        obs_model.Xdense,
        m0,
        model.config,
        obs_model.config,
        maxiter=maxiter,
        verbose=verbose,
    )
    if not bool(converged):
        import warnings

        warnings.warn("model not converged.")
    eta = np.asarray(eta)
    return [eta[d] for d in range(eta.shape[0])]
