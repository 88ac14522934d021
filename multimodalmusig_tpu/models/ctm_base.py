"""Shared logistic-normal CTM machinery used by MMCTM and IMMCTM.

The reference duplicates these routines verbatim between src/MMCTM.jl and
src/IMMCTM.jl (calculate_sumθ/Ndivζ, update_λ!/ν!/ζ!/μ!/Σ!, the Gaussian
ELBO terms, the CAVI convergence loop); here they are written once against
the common state layout (λ/ν (D, MK), ζ (D, M), μ/Σ/invΣ (MK,)).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..ops.convergence import MIN_ITERS_BEFORE_CONVERGENCE, relative_change
from ..ops.solvers import maximize_lambda, maximize_nu

__all__ = [
    "CTMBaseConfig",
    "counts_per_doc",
    "calculate_Ndivzeta",
    "calculate_sumtheta",
    "theta_from",
    "theta_moments",
    "theta_moments_auto",
    "update_zeta",
    "solve_nu",
    "solve_lambda",
    "solve_eta",
    "resolved_budgets",
    "update_mu_vec",
    "update_Sigma_mats",
    "spd_inverse",
    "props_from_lam",
    "run_cavi",
    "elbo_eta_z_terms",
    "elbo_eta_z_term_dict",
]


@dataclasses.dataclass(frozen=True)
class CTMBaseConfig:
    """Static per-modality topic/vocab structure shared by MMCTM and IMMCTM."""

    K: Tuple[int, ...]  # topics per modality
    V: Tuple[int, ...]  # vocab items per modality
    D: int              # documents
    dtype: Any = jnp.float32
    # Inner solver budgets (None = the measured dtype-dependent defaults in
    # ops/solvers.py — float32 fit loops use the warm-start caps
    # LAMBDA_NITER_F32_CAVI / LAMBDA_POLISH_F32_CAVI / NU_FP_F32_CAVI,
    # float64 keeps the cold-start-safe full budgets). Datasets with much
    # larger MK or harsher precision-matrix geometry can raise these without
    # editing solver code; they thread through solve_eta → solve_lambda.
    lambda_n_iter: Any = None
    lambda_cg_iter: Any = None
    lambda_polish_iter: Any = None
    nu_n_iter: Any = None
    # Secant-extrapolated λ warm start: the fit loop's λ solve starts at
    # λ_t + c·(λ_t − λ_{t-1}) instead of λ_t (None/0 = off). The CAVI λ
    # sequence converges geometrically, so a linear predictor lands the
    # start closer to the optimum than the previous iterate does — a
    # fewer-sequential-steps lever on the Newton/PCG dependency chain.
    # Probed by tools/lambda_extrap_ab.py; only the fit loops see it (the
    # first iteration has λ_{t-1} = λ_t, so cold starts are unaffected).
    lambda_extrap: Any = None
    # Newton-direction solver for the λ maximizer: None = the default
    # ("pcg", batched Jacobi-PCG — ops/solvers.py _cg_solve), "chol" = the
    # fully unrolled direct Cholesky solve (_chol_solve), A/B'd by
    # tools/chol_ab.py. Static (jit cache key). "chol" bypasses the fused
    # λ kernel, which implements PCG only.
    lambda_solver: Any = None
    # Fused-λ-kernel switch: None = decided by fused_lambda_enabled on the
    # default device; True/False = decided by the caller, who knows the
    # devices of the program: a GSPMD-partitioned fit turns it off (GSPMD
    # cannot partition a pallas_call), a shard_map body over GPUs turns it
    # on. Static (part of the jit cache key).
    force_fused: Any = None

    @property
    def M(self) -> int:
        return len(self.K)

    @property
    def MK(self) -> int:
        return sum(self.K)

    @property
    def offsets(self) -> Tuple[int, ...]:
        out, acc = [], 0
        for k in self.K:
            out.append(acc)
            acc += k
        return tuple(out)

    def block(self, arr: jnp.ndarray, m: int) -> jnp.ndarray:
        """Slice modality m's topic block from the last axis."""
        o = self.offsets[m]
        return arr[..., o : o + self.K[m]]


def counts_per_doc(X: Sequence[jnp.ndarray]) -> jnp.ndarray:
    """N[d, m] = total counts of document d in modality m (src/MMCTM.jl:37)."""
    return jnp.stack([Xm.sum(axis=1) for Xm in X], axis=1)


def calculate_Ndivzeta(N: jnp.ndarray, zeta: jnp.ndarray, config) -> jnp.ndarray:
    """(D, MK): N_dm/ζ_dm broadcast to modality m's topic block
    (src/MMCTM.jl:119-125, src/IMMCTM.jl:98-104)."""
    parts = [
        jnp.repeat((N[:, m] / zeta[:, m])[:, None], config.K[m], axis=1)
        for m in range(config.M)
    ]
    return jnp.concatenate(parts, axis=1)


def calculate_sumtheta(theta: Sequence[jnp.ndarray], X: Sequence[jnp.ndarray], config) -> jnp.ndarray:
    """(D, MK): per-topic expected counts, concatenated over modalities
    (src/MMCTM.jl:110-117, src/IMMCTM.jl:90-96)."""
    parts = [
        jnp.einsum("dv,dvk->dk", X[m], theta[m], preferred_element_type=config.dtype,
                   precision=jax.lax.Precision.HIGHEST)
        for m in range(config.M)
    ]
    return jnp.concatenate(parts, axis=1)


def theta_moments(lam, logw, X, config, want_scatter: bool = True):
    """Both count-weighted θ moments WITHOUT materializing θ, via the exact
    softmax factorization. Returns (sumθ (D, MK), scatters tuple of
    (K_m, V_m) — or None when `want_scatter` is False).

    θ[d,v,k] = softmax_k(λ_dk + w_vk) (src/MMCTM.jl:183-198,
    src/IMMCTM.jl:152-172) splits exactly: with the two-sided stabilizers
    a_d = max_k λ_block[d], b_v = max_k w[v] and A = exp(λ_block − a),
    B = exp(w − b), the joint exp factors as A_dk·B_vk·exp(a_d + b_v) and
    the exp(a_d + b_v) prefactor cancels in the softmax ratio, so

        Z_dv          = Σ_k A_dk B_vk            (one (D,K)@(K,V) matmul)
        sumθ[d,k]     = Σ_v X θ = A ⊙ (R @ B)    with R = X / Z
        scatter[k,v]  = Σ_d X θ = (B ⊙ (Rᵀ @ A))ᵀ   (src/MMCTM.jl:110-117,
                                                      224-242 moments)

    This is the same math on a different schedule: exps drop from
    D·Σ_m V_m·K_m (~0.56M per BRCA lane-iteration) to D·MK + Σ_m V_m·K_m
    (~9k, ~64×), and the dominant contractions become matmuls over
    (D, V_m) instead of einsums against a (D, V_m, K_m) softmax.
    Stabilization: every A, B entry is ≤ 1, so Z never overflows. Underflow
    is NOT fully equivalent to the materialized softmax, which subtracts the
    per-(d,v) JOINT max and is immune: here Z_dv flushes to 0 when every
    topic's joint term sits > ~88 nats (f32; ~708 in f64 — unreachable)
    below a_d + b_v, which needs the λ-row and logw-row argmaxes to be
    anti-correlated with both spreads > 88. Then R = X/Z is inf on X > 0
    cells and the lane's ll goes NaN — FAIL-SAFE, not silent: run_cavi
    terminates the lane and restart selection masks it
    (tests/test_theta_moments.py::test_f32_joint_underflow_is_the_known_gap
    pins the exact behavior difference). Such a cell means every topic
    explains that (document, word) pair with relative probability < 1e-38
    — fitted models never get there (BRCA/PCAWG spreads are tens of nats);
    data that does can pin `MUSIG_THETA_FACTORIZED=0` for the exact path.

    Precision: all three contractions run at Precision.HIGHEST. A float32
    matmul may otherwise run in TF32 on a GPU (10 mantissa bits), and with
    the factorization that error lands on the softmax NORMALIZER Z, giving
    every θ a correlated bias that the materialized path never had.
    """
    dt = config.dtype
    hi = jax.lax.Precision.HIGHEST
    sum_parts, scatters = [], []
    for m in range(config.M):
        lam_m = config.block(lam, m)
        A = jnp.exp(lam_m - jnp.max(lam_m, axis=1, keepdims=True))   # (D, K)
        B = jnp.exp(logw[m] - jnp.max(logw[m], axis=1, keepdims=True))  # (V, K)
        Z = jnp.einsum("dk,vk->dv", A, B, preferred_element_type=dt, precision=hi)
        R = X[m] / Z
        sum_parts.append(
            A * jnp.einsum("dv,vk->dk", R, B, preferred_element_type=dt, precision=hi)
        )
        if want_scatter:
            scatters.append(
                (B * jnp.einsum("dv,dk->vk", R, A,
                                preferred_element_type=dt, precision=hi)).T
            )
    return (
        jnp.concatenate(sum_parts, axis=1),
        tuple(scatters) if want_scatter else None,
    )


def theta_from(lam, logw, config) -> Tuple[jnp.ndarray, ...]:
    """θ[d,v,:] = softmax(λ_block[d,:] + logw_m[v,:]); logw is (V_m, K_m)
    (src/MMCTM.jl:183-198; src/IMMCTM.jl:152-172 with the feature product
    already collapsed into logw). Materializes the (D, V_m, K_m) tensors —
    the fit loops use theta_moments_auto instead, which needs only the
    count-weighted moments."""
    return tuple(
        jax.nn.softmax(
            config.block(lam, m)[:, None, :] + logw[m][None, :, :], axis=-1
        )
        for m in range(config.M)
    )


def theta_moments_auto(lam, logw, X, config, want_scatter: bool = True):
    """(sumθ, scatters) via the exp-factorized matmul schedule
    (theta_moments — exact same math, ~64× fewer exps on BRCA), or the
    materializing einsum path when `MUSIG_THETA_FACTORIZED=0` pins it for
    A/B runs. Shared by MMCTM and IMMCTM e_step_moments so the two branch
    blocks cannot drift."""
    from ..ops import flags

    if flags.THETA_FACTORIZED:
        return theta_moments(lam, logw, X, config, want_scatter)
    theta = theta_from(lam, logw, config)
    sumtheta = calculate_sumtheta(theta, X, config)
    scatters = (
        tuple(
            jnp.einsum(
                "dv,dvk->kv", X[m], theta[m],
                preferred_element_type=config.dtype,
                precision=jax.lax.Precision.HIGHEST,
            )
            for m in range(config.M)
        )
        if want_scatter
        else None
    )
    return sumtheta, scatters


def update_zeta(lam: jnp.ndarray, nu: jnp.ndarray, config) -> jnp.ndarray:
    """ζ_dm = Σ_k exp(λ+ν/2) over modality m's block (src/MMCTM.jl:172-181)."""
    e = jnp.exp(lam + 0.5 * nu)
    return jnp.stack([config.block(e, m).sum(axis=1) for m in range(config.M)], axis=1)


def solve_nu(nu, lam, Ndivzeta, invSigma, n_iter=None):
    """Batched ν maximization (replaces NLopt at src/MMCTM.jl:156-170)."""
    kw = {} if n_iter is None else {"n_iter": n_iter}
    return maximize_nu(nu, lam, Ndivzeta, jnp.diagonal(invSigma)[None, :], **kw)


def _default_device():
    """The device an unsharded computation runs on."""
    dev = jax.config.jax_default_device
    if dev is None:
        return jax.devices()[0]
    return jax.devices(dev)[0] if isinstance(dev, str) else dev


def fused_lambda_enabled(MK: int, dtype, devices) -> bool:
    """Whether the fused λ kernel (ops/pallas/lambda_kernel.py) serves a λ
    solve. `devices` are the devices one instance of the program runs on:
    the default device for a plain fit, one device of a shard_map body, the
    whole mesh for a GSPMD-partitioned fit. The kernel serves a float32
    solve with MK within its limit on exactly one GPU (GSPMD cannot
    partition a pallas_call)."""
    from ..ops.pallas.lambda_kernel import FUSED_MAX_MK

    devices = list(devices)
    return (
        len(devices) == 1
        and devices[0].platform == "gpu"
        and MK <= FUSED_MAX_MK
        and jnp.dtype(dtype) == jnp.dtype(jnp.float32)
    )


def solve_lambda(lam, nu, Ndivzeta, sumtheta, mu, invSigma,
                 n_iter=None, cg_iter=None, polish_iter=None, force_fused=None,
                 solver=None):
    """Batched λ maximization (replaces NLopt at src/MMCTM.jl:127-143).

    `n_iter`/`cg_iter`/`polish_iter` override the solver's defaults
    (7 Newton iterations, MK CG iterations, 2 polish rounds — ops/solvers.py
    maximize_lambda) for callers whose problems outgrow the BRCA-tuned
    budget, or — via solve_eta's dtype-gated resolution — shrink them to
    the warm-start fit-loop caps. `force_fused` is CTMBaseConfig.force_fused
    (None = fused_lambda_enabled on the default device). The fused kernel
    and the XLA path agree to float32 rounding."""
    kw = {}
    if n_iter is not None:
        kw["n_iter"] = int(n_iter)
    if cg_iter is not None:
        kw["cg_iter"] = int(cg_iter)
    if polish_iter is not None:
        kw["polish_iter"] = int(polish_iter)
    if solver is not None and str(solver) != "pcg":
        # the fused kernel implements the PCG direction only
        return maximize_lambda(
            lam, nu, Ndivzeta, sumtheta, mu, invSigma, solver=str(solver), **kw
        )
    fused = (
        bool(force_fused)
        if force_fused is not None
        else fused_lambda_enabled(lam.shape[-1], lam.dtype, [_default_device()])
    )
    if fused:
        from ..ops.pallas.lambda_kernel import maximize_lambda_fused

        return maximize_lambda_fused(lam, nu, Ndivzeta, sumtheta, mu, invSigma, **kw)
    return maximize_lambda(lam, nu, Ndivzeta, sumtheta, mu, invSigma, **kw)


def resolved_budgets(config) -> dict:
    """The inner-solver budgets a fit loop with this config actually runs:
    {"lambda_n_iter", "lambda_cg_iter", "lambda_polish_iter", "nu_n_iter"},
    None meaning the solver's own cold-start default (ops/solvers.py).

    Warm-started fit-loop solves need far smaller budgets than the
    cold-start defaults — measured cliffs and rationale at ops/solvers.py
    LAMBDA_NITER_F32_CAVI / LAMBDA_POLISH_F32_CAVI / NU_FP_F32_CAVI /
    CG_F32_CAVI. The
    caps apply ONLY to float32 fits (float64 keeps the full budgets — the
    machine-precision trajectory-parity suite needs them), were tuned on
    BRCA and PCAWG, and can be lifted globally with MUSIG_F32_FULL_BUDGETS=1
    or per-model via the config fields (which always win). Exposed as a
    function so verbose fit output and tests can report exactly what a fit
    resolved (the f32 shrink must be inspectable)."""
    from ..ops import flags
    from ..ops.solvers import (
        CG_F32_CAVI,
        LAMBDA_NITER_F32_CAVI,
        LAMBDA_POLISH_F32_CAVI,
        NU_FP_F32_CAVI,
    )

    f32 = (
        jnp.dtype(config.dtype) == jnp.dtype(jnp.float32)
        and not flags.F32_FULL_BUDGETS
    )
    out = {
        "lambda_n_iter": LAMBDA_NITER_F32_CAVI if f32 else None,
        "lambda_cg_iter": CG_F32_CAVI if f32 else None,
        "lambda_polish_iter": LAMBDA_POLISH_F32_CAVI if f32 else None,
        "nu_n_iter": NU_FP_F32_CAVI if f32 else None,
    }
    for name in out:
        if getattr(config, name) is not None:
            out[name] = int(getattr(config, name))
    return out


def solve_eta(lam, nu, N, sumtheta, mu, invSigma, config, lam_prev=None):
    """The η-side of one batched `fitdoc!` (src/MMCTM.jl:450-455, minus θ):
    ζ (closed form) → N/ζ → ν solve → λ solve, for all documents at once.
    Returns (ζ, ν', λ').

    `lam_prev` (the previous CAVI iteration's λ, i.e. the fit loops'
    state.lam_pre) enables the config.lambda_extrap secant warm start for
    the λ solve; the ζ/ν math always uses the un-extrapolated λ (the
    reference's data flow, src/MMCTM.jl:450-455 — only the *initial point*
    handed to the λ maximizer changes, and the maximizer's line search is
    monotone from any start). The extrapolation step is clipped per
    coordinate so a large early-iteration swing cannot overflow exp(λ) in
    the solver's first gradient evaluation.

    Inner-solver budgets come from `resolved_budgets(config)` (float32 fits
    default to the measured warm-start caps; MUSIG_F32_FULL_BUDGETS=1 or
    the config fields override).

    The λ solve takes the fused GPU kernel where solve_lambda's gate
    allows; ζ and ν stay XLA ops.
    """
    budgets = resolved_budgets(config)
    kw = {
        solver_name: budgets[field]
        for solver_name, field in (
            ("n_iter", "lambda_n_iter"),
            ("cg_iter", "lambda_cg_iter"),
            ("polish_iter", "lambda_polish_iter"),
        )
        if budgets[field] is not None
    }
    nu_n_iter = budgets["nu_n_iter"]
    zeta = update_zeta(lam, nu, config)
    Ndivzeta = calculate_Ndivzeta(N, zeta, config)
    nu_kw = {} if nu_n_iter is None else {"n_iter": nu_n_iter}
    nu2 = maximize_nu(nu, lam, Ndivzeta, jnp.diagonal(invSigma)[None, :], **nu_kw)
    lam0 = lam
    if config.lambda_extrap and lam_prev is not None:
        c = float(config.lambda_extrap)
        lam0 = lam + jnp.clip(c * (lam - lam_prev), -4.0, 4.0)
    lam2 = solve_lambda(lam0, nu2, Ndivzeta, sumtheta, mu, invSigma,
                        force_fused=config.force_fused,
                        solver=config.lambda_solver, **kw)
    return zeta, nu2, lam2


def update_mu_vec(lam: jnp.ndarray) -> jnp.ndarray:
    """μ = mean_d λ_d (src/MMCTM.jl:200-202)."""
    return lam.mean(axis=0)


def _spd_inverse_unrolled(S: jnp.ndarray) -> jnp.ndarray:
    """Cholesky inverse with the factorization and forward substitution
    fully unrolled over the (static) matrix dimension: L columns by the
    forward recurrence, X = L⁻¹ by unit forward substitution, invΣ = XᵀX
    at HIGHEST precision. Works batched (leading dims broadcast).

    Rationale: XLA's batched cho_factor/cho_solve lowers to dynamic-slice
    While loops at (R, 14, 14); the M-step pays that inverse once per CAVI
    iteration per restart lane. Unrolling turns it into ~2·MK sequential
    steps of small batched vector ops (A/B: tools/sigma_ab.py). Same
    algorithm, different schedule: f64 agrees with np.linalg.inv to ~2e-14
    relative; f32 agrees with cho_solve to ~1.4e-5 relative at BRCA-like
    conditioning."""
    n = S.shape[-1]
    hi = jax.lax.Precision.HIGHEST
    cols = []  # cols[j]: (..., n) column j of L, zeroed above the diagonal
    for j in range(n):
        r = S[..., :, j]
        for k in range(j):
            r = r - cols[k] * cols[k][..., j : j + 1]
        d = jnp.sqrt(r[..., j])
        col = r / d[..., None]
        cols.append(jnp.where(jnp.arange(n) >= j, col, 0.0))
    L = jnp.stack(cols, axis=-1)

    xcols = []  # column j of X = L⁻¹
    for j in range(n):
        xc = []
        for i in range(n):
            if i < j:
                xc.append(jnp.zeros(S.shape[:-2], S.dtype))
                continue
            acc = jnp.ones(S.shape[:-2], S.dtype) if i == j else (
                jnp.zeros(S.shape[:-2], S.dtype)
            )
            for k in range(j, i):
                acc = acc - L[..., i, k] * xc[k]
            xc.append(acc / L[..., i, i])
        xcols.append(jnp.stack(xc, axis=-1))
    X = jnp.stack(xcols, axis=-1)
    return jnp.matmul(jnp.swapaxes(X, -1, -2), X, precision=hi)


def spd_inverse(Sigma: jnp.ndarray) -> jnp.ndarray:
    """Cholesky inverse of an SPD matrix (vs. LU `inv` at src/MMCTM.jl:211).

    Mutation-signature-sized matrices take the unrolled schedule
    (_spd_inverse_unrolled). The threshold stays near the BRCA and PCAWG
    sizes (MK=14, 19): the unrolled form traces O(n³/6) ops into the loop
    body, so a much larger MK would trade a compile-time blowup for an
    unmeasured win — bigger matrices keep cho_factor/cho_solve."""
    if Sigma.shape[-1] <= 20:
        return _spd_inverse_unrolled(Sigma)
    n = Sigma.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(n, dtype=Sigma.dtype), Sigma.shape)
    chol = jax.scipy.linalg.cho_factor(Sigma)
    return jax.scipy.linalg.cho_solve(chol, eye)


def update_Sigma_mats(lam, nu, mu, D):
    """Σ = (Σ_d diag(ν_d) + (λ_d-μ)(λ_d-μ)ᵀ)/D and invΣ (src/MMCTM.jl:204-212).

    The Gram matrix runs at HIGHEST precision: Σ can be ill-conditioned (its
    smallest diagonal reaches ~5e-3 on the BRCA workload), and a TF32 pass
    (10 mantissa bits) would poison every downstream Σ⁻¹ solve."""
    E = lam - mu[None, :]
    gram = jnp.matmul(E.T, E, precision=jax.lax.Precision.HIGHEST)
    Sigma = (jnp.diag(nu.sum(axis=0)) + gram) / D
    return Sigma, spd_inverse(Sigma)


def props_from_lam(lam: jnp.ndarray, config) -> Tuple[jnp.ndarray, ...]:
    """Per-modality doc-topic proportions: softmax of λ's block
    (src/MMCTM.jl:145-154). Tuple of (D, K_m)."""
    return tuple(jax.nn.softmax(config.block(lam, m), axis=-1) for m in range(config.M))


def make_cavi_carry(state, config, maxiter):
    """Fresh CAVI loop carry: (state, ll ring buffer, iteration, done).

    The 4th element is a *termination* flag ("stop iterating"): true either
    on genuine convergence or when the lane's ll went non-finite (a dead
    lane can never recover and must not run to maxiter). Reported
    convergence is derived via `carry_converged`, which excludes dead lanes.
    """
    ll_buf = jnp.zeros((maxiter, config.M), config.dtype)
    return (state, ll_buf, jnp.int32(0), jnp.array(False))


def carry_converged(ll_buf, n_iters, done):
    """True convergence for reporting: terminated AND the final ll is finite.

    The loop's `done` flag deliberately includes NaN-dead lanes (see
    make_cavi_carry) so they stop early; a diverged fit must still report
    converged=False through the public API — silently reporting success on a
    garbage fit is the same wrong-number trap as the old placeholder ELBO."""
    return done & jnp.all(jnp.isfinite(ll_buf[n_iters - 1]))


def run_cavi_from(carry, maxiter, tol, step_fn, verbose=False, max_new_iters=None,
                  verbose_label="Log-likelihoods"):
    """Resume the CAVI while_loop from an existing carry for up to
    `max_new_iters` more iterations (None = to maxiter). Chunked resumption
    keeps each device execution bounded — long fits are driven as a host loop
    over chunks, which lets a caller observe progress between chunks."""
    it0 = carry[2]
    limit = (
        jnp.int32(maxiter)
        if max_new_iters is None
        else jnp.minimum(it0 + max_new_iters, maxiter)
    )

    def cond(carry):
        _, _, it, converged = carry
        return (it < limit) & ~converged

    def body(carry):
        state, ll_buf, it, _ = carry
        state, ll_i = step_fn(state)
        ll_buf = ll_buf.at[it].set(ll_i)
        if verbose:
            jax.debug.print("{}\t" + verbose_label + ": {}", it + 1, ll_i)
        converged = (it + 1 > MIN_ITERS_BEFORE_CONVERGENCE) & (
            relative_change(ll_buf[it - 1], ll_i) < tol
        )
        # A non-finite ll means the lane diverged and can never recover (nor
        # converge: NaN compares false). Terminate it instead of computing
        # NaNs to maxiter — under vmapped restarts a single dead lane would
        # otherwise keep the whole batch running. (Divergence from the
        # reference, which loops to maxiter on NaN; the lane's result is
        # masked out of restart selection either way — parallel/restarts.py.)
        converged = converged | ~jnp.all(jnp.isfinite(ll_i))
        return state, ll_buf, it + 1, converged

    return jax.lax.while_loop(cond, body, carry)


def run_cavi(state, config, maxiter, tol, step_fn, verbose=False):
    """jit-able CAVI driver with the reference's convergence rule
    (rel. Δ of the (M,) ll vector < tol after iteration 10; src/common.jl:48-56).
    Returns (state, ll_buf (maxiter, M), n_iters, converged)."""
    return run_cavi_from(
        make_cavi_carry(state, config, maxiter), maxiter, tol, step_fn, verbose
    )


def elbo_eta_z_term_dict(lam, nu, zeta, mu, invSigma, theta, X, N, config):
    """The named logistic-normal ELBO pieces shared by MMCTM and IMMCTM,
    as a dict {ElnPeta, ElnPZ, ElnQeta} (src/MMCTM.jl:286-318, 354-360;
    identical in src/IMMCTM.jl:262-296, 330-336). Exposed per-term so the
    reference's pending per-term tests (test/mmctm.jl:295-335) can run live."""
    D, MK = config.D, config.MK
    Ediff = lam - mu[None, :]
    chol = jnp.linalg.cholesky(invSigma)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol)))
    quad = jnp.einsum("di,ij,dj->", Ediff, invSigma, Ediff,
                      precision=jax.lax.Precision.HIGHEST)
    trace = jnp.sum(nu * jnp.diagonal(invSigma)[None, :])
    ElnPeta = 0.5 * (D * logdet - D * MK * jnp.log(2 * jnp.pi) - trace - quad)

    Eeta = jnp.exp(lam + 0.5 * nu)
    sumtheta = calculate_sumtheta(theta, X, config)
    Ndivzeta = calculate_Ndivzeta(N, zeta, config)
    ElnPZ = (
        jnp.sum(lam * sumtheta)
        - (jnp.sum(Ndivzeta * Eeta) - jnp.sum(N))
        - jnp.sum(N * jnp.log(zeta))
    )

    ElnQeta = -0.5 * (jnp.sum(jnp.log(nu)) + D * MK * (jnp.log(2 * jnp.pi) + 1.0))
    return {"ElnPeta": ElnPeta, "ElnPZ": ElnPZ, "ElnQeta": ElnQeta}


def elbo_eta_z_terms(lam, nu, zeta, mu, invSigma, theta, X, N, config):
    """ElnPη + ElnPZ − ElnQη (see elbo_eta_z_term_dict)."""
    t = elbo_eta_z_term_dict(lam, nu, zeta, mu, invSigma, theta, X, N, config)
    return t["ElnPeta"] + t["ElnPZ"] - t["ElnQeta"]
