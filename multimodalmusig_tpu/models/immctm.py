"""Independent-feature Multi-Modal CTM (IMMCTM) on accelerators.

Re-implementation of the reference's src/IMMCTM.jl (545 LoC Julia):
MMCTM x ILDA — a joint logistic-normal over all modalities' topics with
per-modality *feature-factorized* topic-word distributions
p_m(v|k) = Π_i ϕ_m,k,i[features_m[v,i]] and per-modality-per-feature
Dirichlet hyperparameters α[m][i] (src/IMMCTM.jl:13, 22).

Accelerator re-architecture: as in ILDA, each modality's feature lookup
becomes one-hot matrices F_m,i : (V_m, J_mi), turning the reference's 4-deep
nested loops (src/IMMCTM.jl:152-172 update_θ!, 199-223 update_γ!) into
matmuls; the logistic-normal document side reuses the shared batched E-step
machinery of ctm_base (identical between MMCTM and IMMCTM in the reference).

Capability notes vs. the reference:
  * The reference IMMCTM has no `transform` and no stored props/ϕ fields
    (src/IMMCTM.jl struct); we provide `transform` as an extension following
    the MMCTM pattern, and expose props/ϕ as derived quantities.
  * `fit!` here accepts update_sigma (reference always updates Σ,
    src/IMMCTM.jl:445) — defaulting to True preserves reference behavior.
  * `predict_modality_eta` uses a well-defined log-likelihood metric (the
    reference's would read undefined fields; same issue as MMCTM's — see
    models/mmctm.py docstring).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.solvers import maximize_alpha
from ..ops.special import dirichlet_expectation, logmvbeta, logmvbeta_symmetric, safe_xlogy, xlogx
from ..utils.formatting import sparse_to_dense
from .ctm_base import (
    carry_converged,
    CTMBaseConfig,
    calculate_Ndivzeta,
    calculate_sumtheta,
    counts_per_doc,
    elbo_eta_z_terms,
    props_from_lam,
    run_cavi as _run_cavi,
    solve_eta,
    theta_from as ctm_theta_from,
    theta_moments,
    theta_moments_auto,
    spd_inverse as _spd_inverse,
    update_Sigma_mats,
    update_mu_vec,
    update_zeta as _base_update_zeta,
)
from .ilda import feature_onehots

# float32 contractions pin HIGHEST: unpinned, a GPU may run them in TF32
# (10 mantissa bits). The one-hot feature products at HIGHEST are exact
# lookups.
_HI = jax.lax.Precision.HIGHEST

__all__ = [
    "IMMCTMConfig",
    "IMMCTMState",
    "IMMCTMFitResult",
    "IMMCTM",
    "transform",
    "fit_heldout",
    "predict_modality_eta",
]


@dataclasses.dataclass(frozen=True)
class IMMCTMConfig(CTMBaseConfig):
    """CTMBaseConfig plus the per-modality feature structure J[m][i]."""

    J: Tuple[Tuple[int, ...], ...] = ()

    @property
    def I(self) -> Tuple[int, ...]:
        return tuple(len(j) for j in self.J)


class IMMCTMState(NamedTuple):
    """Variational state. γ/Elnϕ are per-modality-per-feature (K_m, J_mi)
    matrices — the reference's 4-level [m][k][i][j] nesting
    (src/IMMCTM.jl:19-20) collapsed to matrices per (m, i)."""

    mu: jnp.ndarray
    Sigma: jnp.ndarray
    invSigma: jnp.ndarray
    alpha: Tuple[jnp.ndarray, ...]                 # per modality (I_m,)
    gamma: Tuple[Tuple[jnp.ndarray, ...], ...]     # [m][i] (K_m, J_mi)
    Elnphi: Tuple[Tuple[jnp.ndarray, ...], ...]    # [m][i] (K_m, J_mi)
    lam: jnp.ndarray                               # (D, MK)
    nu: jnp.ndarray                                # (D, MK)
    zeta: jnp.ndarray                              # (D, M)
    lam_pre: jnp.ndarray                           # λ used by the last θ update
    logw_pre: Tuple[jnp.ndarray, ...]              # (V_m, K_m) Σ_i Elnϕ then


class IMMCTMFitResult(NamedTuple):
    state: IMMCTMState
    ll_history: jnp.ndarray
    n_iters: jnp.ndarray
    converged: jnp.ndarray
    elbo: jnp.ndarray
    ll: jnp.ndarray


# ---------------------------------------------------------------------------
# Initialization (src/IMMCTM.jl:30-88)
# ---------------------------------------------------------------------------


def init(
    key: jax.Array,
    config: IMMCTMConfig,
    alpha: Sequence[Sequence[float]],
) -> IMMCTMState:
    """γ_m,k,i ~ Uniform{1..100}; μ=0, Σ=I, λ=0, ν=1 (src/IMMCTM.jl:47-83)."""
    dt = config.dtype
    MK, D = config.MK, config.D
    gamma: List[Tuple[jnp.ndarray, ...]] = []
    key_iter = iter(jax.random.split(key, sum(config.I)))
    for m in range(config.M):
        gm = tuple(
            jax.random.randint(
                next(key_iter), (config.K[m], config.J[m][i]), 1, 101
            ).astype(dt)
            for i in range(config.I[m])
        )
        gamma.append(gm)
    gamma = tuple(gamma)

    lam = jnp.zeros((D, MK), dt)
    nu = jnp.ones((D, MK), dt)
    state = IMMCTMState(
        mu=jnp.zeros((MK,), dt),
        Sigma=jnp.eye(MK, dtype=dt),
        invSigma=jnp.eye(MK, dtype=dt),
        alpha=tuple(jnp.asarray([float(a) for a in am], dt) for am in alpha),
        gamma=gamma,
        Elnphi=tuple(
            tuple(dirichlet_expectation(g, axis=1) for g in gm) for gm in gamma
        ),
        lam=lam,
        nu=nu,
        zeta=jnp.ones((D, config.M), dt),
        # zero log-weights ⇒ reconstructed θ is the uniform init θ of the
        # reference (src/IMMCTM.jl:52-58) until the first E-step
        lam_pre=lam,
        logw_pre=tuple(
            jnp.zeros((config.V[m], config.K[m]), dt) for m in range(config.M)
        ),
    )
    return state._replace(zeta=_base_update_zeta(lam, nu, config))


# ---------------------------------------------------------------------------
# E-step (src/IMMCTM.jl:90-172, 430-435)
# ---------------------------------------------------------------------------


def summed_Elnphi(
    Elnphi_m: Sequence[jnp.ndarray], F_m: Sequence[jnp.ndarray]
) -> jnp.ndarray:
    """(V_m, K_m): Σ_i Elnϕ_m,k,i[features[v,i]] via one-hot matmuls
    (replaces the k×w×i loop at src/IMMCTM.jl:152-172)."""
    total = jnp.matmul(F_m[0], Elnphi_m[0].T, precision=_HI)
    for i in range(1, len(F_m)):
        total = total + jnp.matmul(F_m[i], Elnphi_m[i].T, precision=_HI)
    return total


# θ[d,v,:] = softmax(λ_block[d,:] + logw_m[v,:]) — shared with MMCTM
# (ctm_base.theta_from); the IMMCTM feature product Π_i exp(Elnϕ) is
# already collapsed into the (V_m, K_m) logw table before this is called.
theta_from = ctm_theta_from


def smoothed_logw(state: IMMCTMState, F, config: IMMCTMConfig):
    """Training log-weights Σ_i E[ln ϕ] as (V_m, K_m) tables
    (src/IMMCTM.jl:152-172)."""
    return tuple(summed_Elnphi(state.Elnphi[m], F[m]) for m in range(config.M))


def unsmoothed_logw(phi, F, config: IMMCTMConfig):
    """Inference log-weights Σ_i ln ϕ from point estimates — the analogue of
    MMCTM's unsmoothed_update_θ! for the feature-factorized model."""
    return tuple(
        summed_Elnphi(tuple(jnp.log(p) for p in phi[m]), F[m])
        for m in range(config.M)
    )


def update_theta(
    state: IMMCTMState, F: Sequence[Sequence[jnp.ndarray]], config: IMMCTMConfig
) -> Tuple[jnp.ndarray, ...]:
    """θ[d,v,:] ∝ exp(λ_block[d,:] + Σ_i Elnϕ) (src/IMMCTM.jl:152-172)."""
    return theta_from(state.lam, smoothed_logw(state, F, config), config)


def reconstruct_theta(state: IMMCTMState, config: IMMCTMConfig) -> Tuple[jnp.ndarray, ...]:
    """The θ of the last E-step, from the carried (λ_pre, logw_pre)."""
    return theta_from(state.lam_pre, state.logw_pre, config)


def e_step(
    state: IMMCTMState,
    X: Sequence[jnp.ndarray],
    N: jnp.ndarray,
    F: Sequence[Sequence[jnp.ndarray]],
    config: IMMCTMConfig,
    logw_fn=None,
):
    """Batched `fitdoc!` (src/IMMCTM.jl:430-435): ζ → θ → ν → λ for all
    docs. Returns (state, θ); θ is never carried (see MMCTMState docs)."""
    logw = (
        smoothed_logw(state, F, config) if logw_fn is None else logw_fn(state)
    )
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
    state: IMMCTMState,
    X: Sequence[jnp.ndarray],
    N: jnp.ndarray,
    F: Sequence[Sequence[jnp.ndarray]],
    config: IMMCTMConfig,
    logw_fn=None,
    want_scatter: bool = True,
):
    """`e_step` computing only the θ moments the iteration consumes, via the
    exact exp-factorized matmul schedule (ctm_base.theta_moments) — the
    feature product Π_i exp(Elnϕ) is already collapsed into the (V_m, K_m)
    logw table, so the factorization carries over from MMCTM unchanged.
    `MUSIG_THETA_FACTORIZED=0` pins the materializing path for A/B runs.
    Returns (state, scatters tuple of (K_m, V_m) or None)."""
    logw = (
        smoothed_logw(state, F, config) if logw_fn is None else logw_fn(state)
    )
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
# M-step (src/IMMCTM.jl:174-244)
# ---------------------------------------------------------------------------


def update_gamma(
    state: IMMCTMState,
    X: Sequence[jnp.ndarray],
    F: Sequence[Sequence[jnp.ndarray]],
    config: IMMCTMConfig,
    theta: Sequence[jnp.ndarray] = None,
    scatter: Sequence[jnp.ndarray] = None,
) -> IMMCTMState:
    """γ_m,i[k,j] = α_m,i + (Σ_d X·θ) @ F_m,i (src/IMMCTM.jl:199-223).
    `scatter` supplies the (K_m, V_m) count-weighted sums directly (the
    factorized-moments path) instead of contracting θ here."""
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
    gamma = []
    for m in range(config.M):
        W = scatter[m]
        gamma.append(
            tuple(
                state.alpha[m][i] + jnp.matmul(W, F[m][i], precision=_HI)
                for i in range(config.I[m])
            )
        )
    gamma = tuple(gamma)
    return state._replace(
        gamma=gamma,
        Elnphi=tuple(
            tuple(dirichlet_expectation(g, axis=1) for g in gm) for gm in gamma
        ),
    )


def update_alpha(state: IMMCTMState, config: IMMCTMConfig) -> IMMCTMState:
    """Per-modality-per-feature symmetric Dirichlet MLE (src/IMMCTM.jl:225-244)."""
    alphas = []
    for m in range(config.M):
        am = []
        for i in range(config.I[m]):
            S = jnp.sum(state.Elnphi[m][i])
            am.append(maximize_alpha(state.alpha[m][i], S, config.K[m], config.J[m][i]))
        alphas.append(jnp.stack(am))
    return state._replace(alpha=tuple(alphas))


def phi_point(
    gamma: Sequence[Sequence[jnp.ndarray]],
) -> Tuple[Tuple[jnp.ndarray, ...], ...]:
    """ϕ_m,i[k,:] = γ normalized over values (src/IMMCTM.jl:440-449 inline)."""
    return tuple(
        tuple(g / g.sum(axis=1, keepdims=True) for g in gm) for gm in gamma
    )


def vocab_topic_probs(
    phi_m: Sequence[jnp.ndarray], F_m: Sequence[jnp.ndarray]
) -> jnp.ndarray:
    """(K_m, V_m): p(v|k) = Π_i ϕ_m,k,i[features[v,i]] (src/IMMCTM.jl:362-386)."""
    return jnp.exp(summed_Elnphi(tuple(jnp.log(p) for p in phi_m), F_m)).T


# ---------------------------------------------------------------------------
# Metrics (src/IMMCTM.jl:247-428)
# ---------------------------------------------------------------------------


def modality_loglikelihoods(
    X: Sequence[jnp.ndarray],
    lam: jnp.ndarray,
    gamma: Sequence[Sequence[jnp.ndarray]],
    F: Sequence[Sequence[jnp.ndarray]],
    config: IMMCTMConfig,
) -> jnp.ndarray:
    """(M,): per-modality mixture log-likelihood with props = softmax(λ block)
    and ϕ normalized from γ (src/IMMCTM.jl:388-428)."""
    props = props_from_lam(lam, config)
    phi = phi_point(gamma)
    out = []
    for m in range(config.M):
        B = vocab_topic_probs(phi[m], F[m])  # (K_m, V_m)
        P = jnp.matmul(props[m], B, precision=_HI)  # (D, V_m)
        out.append(jnp.sum(safe_xlogy(X[m], P)) / jnp.sum(X[m]))
    return jnp.stack(out)


def docmodality_loglikelihoods(
    X: Sequence[jnp.ndarray],
    lam: jnp.ndarray,
    gamma: Sequence[Sequence[jnp.ndarray]],
    F: Sequence[Sequence[jnp.ndarray]],
    config: IMMCTMConfig,
) -> jnp.ndarray:
    """(D, M) per-document per-modality normalized log-likelihood — the
    matrix behind src/IMMCTM.jl:362-386's per-document form, batched. Docs
    with zero counts in a modality get NaN (the reference's aggregation
    skips them; see mmctm.docmodality_loglikelihoods)."""
    props = props_from_lam(lam, config)
    phi = phi_point(gamma)
    cols = []
    for m in range(config.M):
        B = vocab_topic_probs(phi[m], F[m])
        P = jnp.matmul(props[m], B, precision=_HI)  # (D, V_m)
        cols.append(jnp.sum(safe_xlogy(X[m], P), axis=1) / jnp.sum(X[m], axis=1))
    return jnp.stack(cols, axis=1)


def calculate_elbo(
    state: IMMCTMState,
    X: Sequence[jnp.ndarray],
    N: jnp.ndarray,
    F: Sequence[Sequence[jnp.ndarray]],
    config: IMMCTMConfig,
) -> jnp.ndarray:
    """7-term ELBO generalizing MMCTM's per-feature (src/IMMCTM.jl:247-360)."""
    dt = config.dtype
    theta = reconstruct_theta(state, config)

    # ElnPϕ (src/IMMCTM.jl:247-260)
    ElnPphi = jnp.zeros((), dt)
    for m in range(config.M):
        for i in range(config.I[m]):
            ElnPphi += -config.K[m] * logmvbeta_symmetric(state.alpha[m][i], config.J[m][i])
            ElnPphi += (state.alpha[m][i] - 1.0) * jnp.sum(state.Elnphi[m][i])

    # ElnPη + ElnPZ − ElnQη — shared logistic-normal terms
    eta_z = elbo_eta_z_terms(
        state.lam, state.nu, state.zeta, state.mu, state.invSigma,
        theta, X, N, config,
    )

    # ElnPX (src/IMMCTM.jl:298-316): per-feature sums
    ElnPX = jnp.zeros((), dt)
    for m in range(config.M):
        ElnPX += jnp.einsum(
            "dv,dvk,vk->", X[m], theta[m], summed_Elnphi(state.Elnphi[m], F[m]),
            precision=_HI,
        )

    # ElnQϕ (src/IMMCTM.jl:318-331)
    ElnQphi = jnp.zeros((), dt)
    for m in range(config.M):
        for i in range(config.I[m]):
            ElnQphi += jnp.sum(-logmvbeta(state.gamma[m][i], axis=1))
            ElnQphi += jnp.sum((state.gamma[m][i] - 1.0) * state.Elnphi[m][i])

    # ElnQZ (src/IMMCTM.jl:338-346) — count-weighted
    ElnQZ = jnp.zeros((), dt)
    for m in range(config.M):
        ElnQZ += jnp.einsum("dv,dvk->", X[m], xlogx(theta[m]), precision=_HI)

    return ElnPphi + eta_z + ElnPX - ElnQphi - ElnQZ


# ---------------------------------------------------------------------------
# Fit loops (src/IMMCTM.jl:437-545)
# ---------------------------------------------------------------------------


def fit_step_fn(
    X: Sequence[jnp.ndarray],
    N: jnp.ndarray,
    F: Tuple[Tuple[jnp.ndarray, ...], ...],
    config: IMMCTMConfig,
    autoalpha: bool = False,
    update_sigma: bool = True,
):
    """One full CAVI iteration as a closure (src/IMMCTM.jl:441-451) — the
    single source of the step body, shared by fit() and the chunked restart
    driver (parallel/restarts.py)."""

    def step(s):
        s, scatters = e_step_moments(s, X, N, F, config)
        s = s._replace(mu=update_mu_vec(s.lam))
        if update_sigma:
            Sigma, invSigma = update_Sigma_mats(s.lam, s.nu, s.mu, config.D)
            s = s._replace(Sigma=Sigma, invSigma=invSigma)
        s = update_gamma(s, X, F, config, scatter=scatters)
        if autoalpha:
            s = update_alpha(s, config)
        ll_i = modality_loglikelihoods(X, s.lam, s.gamma, F, config)
        return s, ll_i

    return step


def fit(
    state: IMMCTMState,
    X: Sequence[jnp.ndarray],
    F: Tuple[Tuple[jnp.ndarray, ...], ...],
    config: IMMCTMConfig,
    maxiter: int = 100,
    tol: float = 1e-4,
    verbose: bool = False,
    autoalpha: bool = False,
    update_sigma: bool = True,
) -> IMMCTMFitResult:
    """Full IMMCTM CAVI (src/IMMCTM.jl:437-466)."""
    X = tuple(X)
    N = counts_per_doc(X)
    step = fit_step_fn(X, N, F, config, autoalpha, update_sigma)
    state, ll_buf, n_iters, converged = _run_cavi(state, config, maxiter, tol, step, verbose)
    return IMMCTMFitResult(
        state=state,
        ll_history=ll_buf,
        n_iters=n_iters,
        converged=carry_converged(ll_buf, n_iters, converged),
        elbo=calculate_elbo(state, X, N, F, config),
        ll=ll_buf[n_iters - 1],
    )


def fit_heldout_states(
    trained: IMMCTMState,
    state: IMMCTMState,
    Xheldout: Sequence[jnp.ndarray],
    F: Tuple[Tuple[jnp.ndarray, ...], ...],
    config: IMMCTMConfig,
    maxiter: int = 100,
    tol: float = 1e-4,
    verbose: bool = False,
) -> IMMCTMFitResult:
    """Doc-side refit with copied globals (src/IMMCTM.jl:468-497)."""
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

    def step(s):
        s, _ = e_step_moments(s, Xheldout, N, F, config, want_scatter=False)
        ll_i = modality_loglikelihoods(Xheldout, s.lam, s.gamma, F, config)
        return s, ll_i

    state, ll_buf, n_iters, converged = _run_cavi(state, config, maxiter, tol, step, verbose)
    return IMMCTMFitResult(
        state=state,
        ll_history=ll_buf,
        n_iters=n_iters,
        converged=carry_converged(ll_buf, n_iters, converged),
        elbo=calculate_elbo(state, Xheldout, N, F, config),
        ll=ll_buf[n_iters - 1],
    )


def transform_states(
    trained: IMMCTMState,
    state: IMMCTMState,
    Xnew: Sequence[jnp.ndarray],
    F: Tuple[Tuple[jnp.ndarray, ...], ...],
    config: IMMCTMConfig,
    maxiter: int = 1000,
    tol: float = 1e-4,
    fit_gaussian: bool = False,
    verbose: bool = False,
) -> IMMCTMFitResult:
    """Capability extension: IMMCTM fold-in following MMCTM's transform
    pattern (the reference has no IMMCTM transform)."""
    Xnew = tuple(Xnew)
    N = counts_per_doc(Xnew)
    state = state._replace(gamma=trained.gamma, Elnphi=trained.Elnphi)
    if not fit_gaussian:
        state = state._replace(
            mu=trained.mu, Sigma=trained.Sigma, invSigma=_spd_inverse(trained.Sigma)
        )
    # frozen point-estimate weights, matching MMCTM transform's unsmoothed θ
    logw_phi = unsmoothed_logw(phi_point(trained.gamma), F, config)

    def step(s):
        s, _ = e_step_moments(
            s, Xnew, N, F, config, logw_fn=lambda st: logw_phi,
            want_scatter=False,
        )
        if fit_gaussian:
            s = s._replace(mu=update_mu_vec(s.lam))
            Sigma, invSigma = update_Sigma_mats(s.lam, s.nu, s.mu, config.D)
            s = s._replace(Sigma=Sigma, invSigma=invSigma)
        ll_i = modality_loglikelihoods(Xnew, s.lam, s.gamma, F, config)
        return s, ll_i

    state, ll_buf, n_iters, converged = _run_cavi(state, config, maxiter, tol, step, verbose)
    return IMMCTMFitResult(
        state=state,
        ll_history=ll_buf,
        n_iters=n_iters,
        converged=carry_converged(ll_buf, n_iters, converged),
        # real ELBO of {trained topics, new-document posteriors} — the
        # round-1 placeholder elbo=0.0 was a silent wrong-number trap
        elbo=calculate_elbo(state, Xnew, N, F, config),
        ll=ll_buf[n_iters - 1],
    )


def predict_modality_eta_states(
    trained: IMMCTMState,
    obs_state: IMMCTMState,
    Xobs: Sequence[jnp.ndarray],
    m: int,
    Fobs: Tuple[Tuple[jnp.ndarray, ...], ...],
    config: IMMCTMConfig,
    obs_config: IMMCTMConfig,
    maxiter: int = 100,
    tol: float = 1e-4,
    verbose: bool = False,
):
    """Cross-modality imputation (src/IMMCTM.jl:499-545), the same linear
    conditioning estimator as MMCTM's (see models/mmctm.py)."""
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

    def step(s):
        s, _ = e_step_moments(s, Xobs, N, Fobs, obs_config, want_scatter=False)
        ll_i = modality_loglikelihoods(Xobs, s.lam, s.gamma, Fobs, obs_config)
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
# Stateful wrapper mirroring the Julia API (src/IMMCTM.jl:30-88)
# ---------------------------------------------------------------------------


class IMMCTM:
    """``IMMCTM(k, α, features, X)`` where α is per-modality scalar
    (broadcast over features, src/IMMCTM.jl:80-88) or per-modality
    per-feature lists; `features[m]` is (V_m, I_m) 1-based."""

    def __init__(self, k, alpha, features, X, *, seed: int = 0, dtype=None):
        dtype = dtype or (jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
        self.features = [np.asarray(f) for f in features]
        M = len(self.features)
        if len(k) != M:
            raise ValueError("k must have one entry per modality")
        J = tuple(
            tuple(int(f[:, i].max()) for i in range(f.shape[1])) for f in self.features
        )
        # scalar-per-modality α broadcasts over features (src/IMMCTM.jl:80-88)
        full_alpha = [
            list(a) if np.ndim(a) > 0 else [float(a)] * len(J[m])
            for m, a in enumerate(alpha)
        ]
        self.X = [[np.asarray(doc[m]) for m in range(M)] for doc in X]
        self.config = IMMCTMConfig(
            K=tuple(int(x) for x in k),
            V=tuple(int(f.shape[0]) for f in self.features),
            D=len(X),
            dtype=dtype,
            J=J,
        )
        self.F = tuple(
            feature_onehots(self.features[m], J[m], dtype) for m in range(M)
        )
        self.Xdense = tuple(
            jnp.asarray(
                sparse_to_dense([doc[m] for doc in self.X], self.config.V[m]),
                dtype=dtype,
            )
            for m in range(M)
        )
        self.state = init(jax.random.key(seed), self.config, full_alpha)
        self.converged = False
        self.elbo = None
        self.ll = None

    # -- reference scalar fields (src/IMMCTM.jl:2-28) --
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
    def I(self):
        return list(self.config.I)

    @property
    def J(self):
        return [list(j) for j in self.config.J]

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
        return [list(np.asarray(a)) for a in self.state.alpha]

    @property
    def gamma(self):
        """γ[m][k][i] vectors of length J_mi (reference 4-level nesting)."""
        return [
            [
                [np.asarray(self.state.gamma[m][i][k]) for i in range(self.config.I[m])]
                for k in range(self.config.K[m])
            ]
            for m in range(self.M)
        ]

    @property
    def Elnphi(self):
        return [
            [
                [np.asarray(self.state.Elnphi[m][i][k]) for i in range(self.config.I[m])]
                for k in range(self.config.K[m])
            ]
            for m in range(self.M)
        ]

    @property
    def phi(self):
        ph = phi_point(self.state.gamma)
        return [
            [
                [np.asarray(ph[m][i][k]) for i in range(self.config.I[m])]
                for k in range(self.config.K[m])
            ]
            for m in range(self.M)
        ]

    @property
    def props(self):
        p = [np.asarray(x) for x in props_from_lam(self.state.lam, self.config)]
        return [[p[m][d] for m in range(self.M)] for d in range(self.D)]

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

    μ = mu
    Σ = Sigma
    invΣ = invSigma
    α = alpha
    γ = gamma
    Elnϕ = Elnphi
    ϕ = phi
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
        """`fit!` (src/IMMCTM.jl:437-466). Accepts the Julia spelling autoα."""
        autoalpha = kwargs.pop("autoα", autoalpha)
        update_sigma = kwargs.pop("updateΣ", update_sigma)
        if kwargs:
            raise TypeError(f"unexpected kwargs: {sorted(kwargs)}")
        if verbose:
            from .ctm_base import resolved_budgets

            # surface the f32 warm-start solver caps (see MMCTM.fit)
            print(f"inner-solver budgets: {resolved_budgets(self.config)}")
        result = jax.jit(
            fit,
            static_argnames=("config", "maxiter", "tol", "verbose", "autoalpha", "update_sigma"),
        )(
            self.state,
            self.Xdense,
            self.F,
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
        return f"IMMCTM(K={self.K}, D={self.D}, V={self.V}, {status})"


def transform(
    model: IMMCTM,
    X,
    maxiter: int = 1000,
    tol: float = 1e-4,
    fit_gaussian: bool = False,
    verbose: bool = False,
) -> IMMCTM:
    """IMMCTM fold-in (extension; the reference lacks IMMCTM transform)."""
    newmodel = IMMCTM(model.K, model.alpha, model.features, X, dtype=model.config.dtype)
    result = jax.jit(
        transform_states,
        static_argnames=("config", "maxiter", "tol", "fit_gaussian", "verbose"),
    )(
        model.state,
        newmodel.state,
        newmodel.Xdense,
        newmodel.F,
        newmodel.config,
        maxiter=maxiter,
        tol=tol,
        fit_gaussian=fit_gaussian,
        verbose=verbose,
    )
    newmodel.state = result.state
    if not fit_gaussian:
        newmodel.state = newmodel.state._replace(
            mu=model.state.mu, Sigma=model.state.Sigma, invSigma=model.state.invSigma
        )
    newmodel.converged = bool(result.converged)
    newmodel.elbo = float(result.elbo)
    newmodel.ll = list(np.asarray(result.ll, dtype=np.float64))
    return newmodel


def fit_heldout(Xheldout, model: IMMCTM, maxiter: int = 100, verbose: bool = False) -> IMMCTM:
    """Reference `fit_heldout` (src/IMMCTM.jl:468-497)."""
    heldout = IMMCTM(model.K, model.alpha, model.features, Xheldout, dtype=model.config.dtype)
    result = jax.jit(
        fit_heldout_states,
        static_argnames=("config", "maxiter", "tol", "verbose"),
    )(
        model.state,
        heldout.state,
        heldout.Xdense,
        heldout.F,
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
    Xobs, m: int, model: IMMCTM, maxiter: int = 100, verbose: bool = False
):
    """Reference `predict_modality_η` (src/IMMCTM.jl:499-545); 1-based m."""
    if not 1 <= m <= model.M:
        raise ValueError(f"m must be a 1-based modality index in 1..{model.M}, got {m}")
    if model.M < 2:
        raise ValueError("predict_modality_eta needs at least two modalities")
    m0 = m - 1
    obsM = [i for i in range(model.M) if i != m0]
    obs_model = IMMCTM(
        [model.K[i] for i in obsM],
        [model.alpha[i] for i in obsM],
        [model.features[i] for i in obsM],
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
        obs_model.F,
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
