"""Batched bound-constrained maximizers replacing the reference's NLopt dependency.

The reference calls the NLopt C library's LD_MMA algorithm once per document
per CAVI iteration for the logistic-normal variational parameters λ and ν
(reference: src/MMCTM.jl:127-143, 156-170; objectives in src/common.jl:11-36)
and once per modality for the Dirichlet hyperparameter α
(src/MMCTM.jl:252-269; objective src/common.jl:38-46). That per-document
C-library round-trip is the dominant cost of the reference and is
fundamentally serial.

Here each solve is a fixed-iteration batched method, written so that

  * every step is branch-free (candidate-step line search via a masked
    best-so-far scan instead of data-dependent halving loops) ->
    vmap/jit friendly;
  * λ solves batch over documents with the Newton systems solved by CG whose
    matvec is one shared-matrix matmul (no per-document factorizations),
    and the line search needs only two exponentials per Newton iteration
    (exp(sδ) over the halving/doubling ladder is a squaring/sqrt chain);
  * ν solves exploit that the ν-objective is *fully separable per coordinate*
    (src/common.jl:25-36 is a sum of per-coordinate terms): a contractive
    fixed-point sweep plus Newton polish over the (D, MK) grid;
  * the ν >= 1e-7 bound (src/MMCTM.jl:158 `lower_bounds!(opt, 1e-7)`) is a
    clip, not a constraint.

All objectives here are concave on the feasible region, so monotone damped
Newton converges globally; the candidate line search guarantees monotone
ascent (staying put is always a candidate).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.scipy.special import digamma, gammaln, polygamma

# All matvecs against the precision matrix Σ⁻¹ must run at full f32: a TF32
# pass keeps 10 mantissa bits, and Σ⁻¹ is routinely ill-conditioned here (Σ
# diagonals reach ~5e-3 on the BRCA workload, cond ≳ 1e4), so low-precision
# CG directions can be garbage with huge norms — one unguarded Newton step
# then overflows exp(λ).


def _mv(v, S):
    """out[..., j] = Σ_i v[..., i]·S[i, j] at full f32 precision.

    Computed as a broadcast-multiply-reduce rather than a dot, so no
    matmul precision setting applies: the products and sums are plain f32
    elementwise ops. XLA fuses the broadcast and reduction, so nothing
    (B, MK, MK)-shaped is materialized.
    """
    return jnp.sum(v[..., :, None] * S, axis=-2)

# Trust region for the unconditional polish steps: near the optimum Newton
# deltas are at float-resolution scale, so any |δ|∞ beyond this is a solver
# misfire (e.g. CG on a near-singular system), not progress. Scaling the whole
# vector (not per-coordinate clipping) keeps the step an ascent direction.
_POLISH_MAX_STEP = 2.0

# Polish rounds appended to the λ solve. 2 suffice: PCG directions are
# machine-exact, so the unconditional Newton tail converges quadratically
# from the line-searched basin (|g| ~ 1e-12 in f64 —
# tools/lambda_iters_experiment.py). The fused kernel imports this (and
# _N_BACKTRACK/_POLISH_MAX_STEP) so the two implementations cannot drift.
LAMBDA_POLISH_ITERS = 2

# maximize_nu's fixed-point sweep count (its n_iter default).
NU_FP_ITERS = 8

# Float32 cap on the λ solve's inner PCG iteration count (default
# cg_iter = min(MK, cap); float64 keeps the exact cg_iter = MK). See
# maximize_lambda's docstring. The fused kernel imports this so the fused
# and XLA defaults cannot drift.
CG_ITER_F32_CAP = 10

# Warm-start budgets for float32 λ/ν solves inside the CAVI fit loops
# (models/ctm_base.py resolved_budgets applies them when the model config
# leaves the fields unset and dtype is float32; float64 fits and standalone
# solver calls keep the cold-start-safe full budgets). Each CAVI iteration
# warm-starts the solves at the previous iteration's λ/ν, so far smaller
# budgets hold the outer-iteration distribution and the best
# log-likelihoods. The values were chosen at accuracy cliffs found on BRCA
# and PCAWG with the population-quality method of tools/cg_budget_ab.py:
# fewer Newton steps (2, 1) moved the best log-likelihoods, and the PCG
# response is not monotone (cg=8 needed more outer iterations than cg=10).
# They are hypotheses on a GPU until re-gated there; harder datasets can
# raise them via the CTMBaseConfig fields without touching solver code.
LAMBDA_NITER_F32_CAVI = 3
LAMBDA_POLISH_F32_CAVI = 1
NU_FP_F32_CAVI = 4
CG_F32_CAVI = 4

__all__ = [
    "lambda_objective",
    "lambda_grad",
    "maximize_lambda",
    "nu_objective",
    "nu_grad",
    "maximize_nu",
    "alpha_objective",
    "alpha_grad",
    "maximize_alpha",
    "NU_LOWER_BOUND",
    "ALPHA_LOWER_BOUND",
]

# reference: src/MMCTM.jl:158 and src/MMCTM.jl:254
NU_LOWER_BOUND = 1e-7
ALPHA_LOWER_BOUND = 1e-7

# Line-search candidates: over-steps 8,4,2 (exp-dominated far field, where a
# pure Newton step only moves O(1) per iteration), Newton step 1, backtracks
# 1/2..2^-12, and 0 (reject). argmax over candidates keeps ascent monotone.
_N_BACKTRACK = 13

# Trace-time default for `_loop`'s unroll when the caller passes None;
# tools/unroll_ab.py flips it pre-trace in a subprocess. Not a user knob.
_UNROLL_DEFAULT = False


def _loop(n, body, init, unroll):
    """fori_loop with an opt-in trace-time unroll (`unroll=True`).

    `body(i, carry) -> carry` exactly as lax.fori_loop. Unrolling emits the
    same ops in the same order, so results are bit-identical to the While
    lowering (measured, tools/unroll_ab.py); only scheduling/fusion differ.

    Default is the While lowering; tools/unroll_ab.py A/Bs the unrolled
    form of the small f32 budgets (Newton 3 × CG 4) against it."""
    if unroll is None:
        unroll = _UNROLL_DEFAULT
    if unroll:
        carry = init
        for i in range(n):
            carry = body(i, carry)
        return carry
    return jax.lax.fori_loop(0, n, body, init)


def _step_scales(dtype):
    over = jnp.asarray([8.0, 4.0, 2.0], dtype=dtype)
    scales = 2.0 ** -jnp.arange(_N_BACKTRACK, dtype=dtype)
    return jnp.concatenate([over, scales, jnp.zeros((1,), dtype=dtype)])


# Number of trailing pure-Newton polish iterations appended to every solve.
# Near the optimum the objective improvement per step falls below float
# resolution, so value-based line search can no longer pick the Newton step;
# unconditional Newton steps (safe in the concave basin the line-searched
# phase has reached) polish the gradient to machine precision.
_N_POLISH = 4


# ---------------------------------------------------------------------------
# λ objective (reference: src/common.jl:11-23)
# ---------------------------------------------------------------------------


def lambda_objective(lam, nu, Ndivzeta, sumtheta, mu, invSigma):
    """-½(λ-μ)ᵀΣ⁻¹(λ-μ) + λ·sumθ - Σ Ndivζ·exp(λ+ν/2). Single document."""
    diff = lam - mu
    Eeta = jnp.exp(lam + 0.5 * nu)
    quad = -0.5 * jnp.sum(diff * _mv(diff, invSigma))  # Σ⁻¹ symmetric
    return quad + jnp.sum(lam * sumtheta) - jnp.sum(Ndivzeta * Eeta)


def lambda_grad(lam, nu, Ndivzeta, sumtheta, mu, invSigma):
    """∇λ = -Σ⁻¹(λ-μ) + sumθ - Ndivζ·exp(λ+ν/2). Single document."""
    Eeta = jnp.exp(lam + 0.5 * nu)
    return -_mv(lam - mu, invSigma) + sumtheta - Ndivzeta * Eeta  # Σ⁻¹ symmetric


def _batched_lambda_objective(lam, nu, Ndivzeta, sumtheta, mu, invSigma):
    """λ-objective over arbitrary leading batch dims; last axis is MK."""
    diff = lam - mu
    quad = -0.5 * jnp.sum(diff * _mv(diff, invSigma), axis=-1)
    Eeta = jnp.exp(lam + 0.5 * nu)
    return quad + jnp.sum(lam * sumtheta, axis=-1) - jnp.sum(Ndivzeta * Eeta, axis=-1)


def _cg_solve(w, g, invSigma, n_iter, unroll=None):
    """Batched Jacobi-preconditioned CG for (Σ⁻¹ + diag(w)) δ = g over (B, MK)
    without ever materializing the (B, MK, MK) Hessians: each matvec is one
    shared-matrix contraction plus an elementwise product (the XLA
    small-Cholesky lowering is a latency-bound loop).

    The Jacobi preconditioner M = diag(Σ⁻¹) + w costs one elementwise divide
    per iteration and is decisive in float arithmetic: measured on real
    Newton systems harvested from a BRCA-EU fit (float64,
    tools/pcg_experiment.py), plain CG at n_iter = MK stalls at 1e-1..1e-2
    relative error once cond(Σ⁻¹) reaches ~1e3-1e4 (roundoff destroys Krylov
    exactness), while PCG reaches 1e-15 at exactly MK iterations and is ~100x
    more accurate at every earlier count.
    """
    M = jnp.diagonal(invSigma) + w  # Jacobi preconditioner (always > 0)

    def mv(v):
        return _mv(v, invSigma) + w * v

    x = jnp.zeros_like(g)
    r = g
    z = r / M
    p = z
    rz = jnp.sum(r * z, axis=-1)

    def body(_, carry):
        x, r, z, p, rz = carry
        Ap = mv(p)
        alpha = rz / (jnp.sum(p * Ap, axis=-1) + 1e-30)
        x = x + alpha[..., None] * p
        r = r - alpha[..., None] * Ap
        z = r / M
        rz_new = jnp.sum(r * z, axis=-1)
        beta = rz_new / (rz + 1e-30)
        p = z + beta[..., None] * p
        return x, r, z, p, rz_new

    x, *_ = _loop(n_iter, body, (x, r, z, p, rz), unroll)
    return x


# Pivot floor for the unrolled direct Cholesky: H = Σ⁻¹ + diag(w) is SPD by
# construction (w >= 0), so a non-positive pivot can only arise from f32
# cancellation at extreme conditioning; flooring it yields a huge-but-finite
# direction the monotone line search then rejects (fail-safe, like the PCG
# path's 1e-30 guards), instead of NaN-poisoning the lane.
_CHOL_PIVOT_FLOOR = 1e-30


def _chol_solve(w, g, invSigma):
    """Direct batched solve of (Σ⁻¹ + diag(w)) δ = g by a fully unrolled
    Cholesky factorization and two unrolled triangular substitutions.

    The structural alternative to `_cg_solve`: instead of cg_iter sequential
    Krylov iterations (each a shared-matrix matvec + reductions over MK),
    this emits one static elementwise DAG over the document batch: every L
    entry / substitution step is a (B,)-vectorized FMA, there are no
    reductions over MK at all, and the only inputs that vary per document
    are w and g (Σ⁻¹ is shared). FLOPs per document are ~n³/6 + 2n²
    multiplies — comparable to PCG at cg_iter = 4 for n = 14 — but the
    direction is machine-exact (backward-stable Cholesky) rather than a
    4-iteration Krylov truncation.

    Like the unrolled Σ⁻¹, this traces O(n³/6) ops per solve, so callers
    should keep it to mutation-signature-sized MK (the fit loops run it 4×
    per CAVI iteration); larger problems keep PCG. Opt-in via
    CTMBaseConfig.lambda_solver = "chol"; tools/chol_ab.py A/Bs it against
    PCG at fit level.
    """
    n = g.shape[-1]
    idx = jnp.arange(n)
    cols = []  # cols[j]: (..., n) column j of L, zeroed above the diagonal
    for j in range(n):
        r = invSigma[..., :, j] + jnp.where(idx == j, w[..., j : j + 1], 0.0)
        for k in range(j):
            r = r - cols[k] * cols[k][..., j : j + 1]
        d = jnp.sqrt(jnp.maximum(r[..., j], _CHOL_PIVOT_FLOOR))
        cols.append(jnp.where(idx >= j, r / d[..., None], 0.0))
    # forward substitution: L y = g
    y = []
    for i in range(n):
        acc = g[..., i]
        for k in range(i):
            acc = acc - cols[k][..., i] * y[k]
        y.append(acc / cols[i][..., i])
    # back substitution: Lᵀ δ = y  ((Lᵀ)[i, k] = L[k, i] = cols[i][..., k])
    x = [None] * n
    for i in reversed(range(n)):
        acc = y[i]
        for k in range(i + 1, n):
            acc = acc - cols[i][..., k] * x[k]
        x[i] = acc / cols[i][..., i]
    return jnp.stack(x, axis=-1)


@partial(
    jax.jit,
    static_argnames=("n_iter", "cg_iter", "polish_iter", "unroll", "solver"),
)
def maximize_lambda(
    lam0, nu, Ndivzeta, sumtheta, mu, invSigma, n_iter: int = 7,
    cg_iter: int = None, polish_iter: int = None, unroll: bool = None,
    solver: str = "pcg",
):
    """Batched λ solve: lam0/nu/Ndivzeta/sumtheta are (B, MK); μ, Σ⁻¹ shared.

    Replaces the per-document NLopt loop at src/MMCTM.jl:127-143 /
    src/IMMCTM.jl:103-121. Fully batched damped Newton: the Hessian
    -(Σ⁻¹ + diag(w)) is negative definite, so the Newton direction (obtained
    by batched CG — see _cg_solve) is always an ascent direction, and the
    candidate-step argmax keeps every document's iterate monotone.

    n_iter = 7 comes from a probe, not a guess: with Jacobi-PCG inner solves
    (machine-exact at cg_iter = MK — see _cg_solve) every probed solve of a
    30-outer-iteration BRCA-EU fit (float64, cold and warm starts,
    tools/lambda_iters_experiment.py) agrees with n_iter = 20 to <= 2e-14
    already at n_iter = 6; the 8/4/2 over-step ladder covers the cold start,
    and the 7th iteration buys the far-field margin the extreme-start test
    (λ0 = 30) needs. Each Newton iteration
    costs cg_iter CG matvecs — the dominant FLOPs of the whole CAVI
    iteration at benchmark batch sizes — so the budget matters.

    cg_iter default (None): MK in float64 (exact Krylov termination,
    required by the machine-precision trajectory-parity tests), but
    CG_ITER_F32_CAP-capped in float32, where f32 arithmetic floors the PCG
    residual around 1e-6 by ~10 iterations and further ones buy nothing:
    min(MK, 10) keeps identical outer-iteration counts and best
    log-likelihoods, and holds the fuzz stationarity bound at cond(Σ⁻¹) =
    1e6 as tightly as the full budget (tests/test_solvers.py
    TestIllConditionedRobustness). Override per call or per model via
    CTMBaseConfig.lambda_cg_iter.
    """
    MK = lam0.shape[-1]
    if cg_iter is None:
        cg_iter = MK if lam0.dtype == jnp.float64 else min(MK, CG_ITER_F32_CAP)
    if solver not in ("pcg", "chol"):
        raise ValueError(f"solver must be 'pcg' or 'chol', got {solver!r}")

    def newton_dir(w, g):
        if solver == "chol":
            return _chol_solve(w, g, invSigma)
        return _cg_solve(w, g, invSigma, cg_iter, unroll)

    # NOTE: a batch-max-gradient early exit was tried here and removed — under
    # vmap (100 restarts x 560 docs) the while_loop condition lifts to
    # "any lane unconverged", so no iterations are saved, and the looser
    # intermediate solves cost extra outer CAVI iterations. Fixed-count
    # fori_loop it is.
    #
    # Line-search algebra: for a candidate λ + sδ,
    #   quad(s)  = -½(q0 + 2s·b + s²·c2)      from two matvecs (Sδ, Sdiff)
    #   linear(s) = lin0 + s·lind             from two reductions
    #   exp term  = Σ w·e_s, e_s = exp(δ)^s   via a squaring/sqrt chain
    # so each Newton iteration costs TWO exp evaluations total (not one per
    # candidate) and no per-candidate matvecs.
    def body(_, lam):
        Eeta = jnp.exp(lam + 0.5 * nu)
        w = Ndivzeta * Eeta
        diff = lam - mu
        Sdiff = _mv(diff, invSigma)
        g = -Sdiff + sumtheta - w
        delta = newton_dir(w, g)

        Sdelta = _mv(delta, invSigma)
        q0 = jnp.sum(diff * Sdiff, axis=-1)
        b = jnp.sum(delta * Sdiff, axis=-1)
        c2 = jnp.sum(delta * Sdelta, axis=-1)
        lin0 = jnp.sum(lam * sumtheta, axis=-1)
        lind = jnp.sum(delta * sumtheta, axis=-1)
        f0 = -0.5 * q0 + lin0 - jnp.sum(w, axis=-1)  # current point (s = 0)

        # exp(s*delta) per candidate: the three over-steps get their own
        # exponent-clipped exp (a squaring chain from exp(delta) overflows
        # float32 once any coordinate has delta > ~11, and on w_i = 0
        # coordinates — empty doc x modality blocks — w*inf = NaN would
        # spuriously reject the candidate); the backtracking steps s <= 1
        # form an exact sqrt chain from exp(min(delta, 60)). Where a clip
        # binds, any w_i > 0 coordinate still makes the candidate
        # astronomically negative, so selection is unchanged.
        def f_of(s, e_s):
            quad = -0.5 * (q0 + 2.0 * s * b + s * s * c2)
            return quad + lin0 + s * lind - jnp.sum(w * e_s, axis=-1)

        best_s = jnp.zeros_like(f0)
        best_f = f0
        for s in (8.0, 4.0, 2.0):
            f = f_of(s, jnp.exp(jnp.minimum(s * delta, 60.0)))
            ok = jnp.isfinite(f) & (f > best_f)
            best_f = jnp.where(ok, f, best_f)
            best_s = jnp.where(ok, s, best_s)
        # s = 1, 1/2, ..., 2^-(BACKTRACK-1)
        e_s = jnp.exp(jnp.minimum(delta, 60.0))
        s = 1.0
        for _ in range(_N_BACKTRACK):
            f = f_of(s, e_s)
            ok = jnp.isfinite(f) & (f > best_f)
            best_f = jnp.where(ok, f, best_f)
            best_s = jnp.where(ok, s, best_s)
            e_s = jnp.sqrt(e_s)
            s = s / 2.0

        return lam + best_s[..., None] * delta

    def polish(_, lam):
        w = Ndivzeta * jnp.exp(lam + 0.5 * nu)
        g = -_mv(lam - mu, invSigma) + sumtheta - w
        delta = newton_dir(w, g)
        # trust region: scale (never re-direct) oversized deltas — see _POLISH_MAX_STEP
        dmax = jnp.max(jnp.abs(delta), axis=-1, keepdims=True)
        delta = delta * jnp.minimum(1.0, _POLISH_MAX_STEP / jnp.maximum(dmax, 1e-30))
        step = lam + delta
        ok = jnp.all(jnp.isfinite(step), axis=-1, keepdims=True)
        return jnp.where(ok, step, lam)

    if polish_iter is None:
        polish_iter = LAMBDA_POLISH_ITERS
    lam = _loop(n_iter, body, lam0, unroll)
    return _loop(polish_iter, polish, lam, unroll)


# ---------------------------------------------------------------------------
# ν objective (reference: src/common.jl:25-36) — separable per coordinate
# ---------------------------------------------------------------------------


def nu_objective(nu, lam, Ndivzeta, invSigma_diag):
    """-½Σνᵢ·Σ⁻¹ᵢᵢ - Σ Ndivζ·exp(λ+ν/2) + ½Σ log ν.  Single document (sum).

    `invSigma_diag` is diag(Σ⁻¹); the trace term of src/common.jl:34 only
    touches the diagonal, which is what makes the problem separable.
    """
    return jnp.sum(nu_objective_terms(nu, lam, Ndivzeta, invSigma_diag))


def nu_objective_terms(nu, lam, Ndivzeta, invSigma_diag):
    """Per-coordinate contributions to the ν objective (before summation)."""
    Eeta = jnp.exp(lam + 0.5 * nu)
    return -0.5 * nu * invSigma_diag - Ndivzeta * Eeta + 0.5 * jnp.log(nu)


def nu_grad(nu, lam, Ndivzeta, invSigma_diag):
    """∂/∂νᵢ = -½Σ⁻¹ᵢᵢ - (Ndivζᵢ/2)·exp(λᵢ+νᵢ/2) + 1/(2νᵢ)."""
    Eeta = jnp.exp(lam + 0.5 * nu)
    return -0.5 * invSigma_diag - 0.5 * Ndivzeta * Eeta + 0.5 / nu


@partial(jax.jit, static_argnames=("n_iter", "unroll"))
def maximize_nu(nu0, lam, Ndivzeta, invSigma_diag, n_iter: int = NU_FP_ITERS,
                unroll: bool = None):
    """Elementwise ν maximization; any batch shape, all args broadcast.

    Replaces the MK-dimensional NLopt solve at src/MMCTM.jl:156-170. The
    stationarity condition -a - (b/2)e^{ν/2} + 1/(2ν) = 0 (a = ½Σ⁻¹ᵢᵢ,
    b = Ndivζ·e^λ) rearranges to the fixed point ν = 1/(2a + b·e^{ν/2}),
    whose iteration map is a contraction with rate ≈ ν*/2 near the root
    (|g'(ν*)| = (b/2)e^{ν*/2}·ν*² ≤ ν*/2 because b·e^{ν*/2} ≤ 1/ν* at the
    root). A few fixed-point sweeps land in the quadratic basin, then pure
    Newton polishes to machine precision — ~10x fewer elementwise ops than
    a line-searched Newton loop, which matters because this runs once per
    document per CAVI iteration.
    """
    a = 0.5 * invSigma_diag
    b = Ndivzeta * jnp.exp(lam)

    def wexp(nu):
        # b·e^{ν/2} with overflow guard (and exact 0 when b == 0, i.e. N=0)
        return jnp.where(b > 0, b * jnp.exp(jnp.minimum(0.5 * nu, 60.0)), 0.0)

    def fp(_, nu):
        return jnp.clip(1.0 / (2.0 * a + wexp(nu)), NU_LOWER_BOUND)

    def polish(_, nu):
        w = wexp(nu)
        g = -a - 0.5 * w + 0.5 / nu
        hess = -0.25 * w - 0.5 / (nu * nu)  # always < 0
        step = jnp.clip(nu - g / hess, NU_LOWER_BOUND)
        return jnp.where(jnp.isfinite(step), step, nu)

    shape = jnp.broadcast_shapes(
        jnp.shape(nu0), jnp.shape(lam), jnp.shape(Ndivzeta), jnp.shape(invSigma_diag)
    )
    nu = jnp.broadcast_to(jnp.asarray(nu0), shape)
    nu = _loop(n_iter, fp, nu, unroll)
    return _loop(_N_POLISH, polish, nu, unroll)


# ---------------------------------------------------------------------------
# α objective (reference: src/common.jl:38-46) — scalar symmetric-Dirichlet MLE
# ---------------------------------------------------------------------------


def alpha_objective(alpha, sum_Elnphi, K, V):
    """K·(lgamma(Vα) - V·lgamma(α)) + α·ΣElnϕ (src/common.jl:38-46)."""
    return K * (gammaln(V * alpha) - V * gammaln(alpha)) + alpha * sum_Elnphi


def alpha_grad(alpha, sum_Elnphi, K, V):
    """K·V·(digamma(Vα) - digamma(α)) + ΣElnϕ."""
    return K * V * (digamma(V * alpha) - digamma(alpha)) + sum_Elnphi


@partial(jax.jit, static_argnames=("n_iter",))
def maximize_alpha(alpha0, sum_Elnphi, K, V, n_iter: int = 30):
    """Scalar Newton for the symmetric Dirichlet hyperparameter MLE.

    Replaces the 1-dim NLopt solve of src/MMCTM.jl:252-269 /
    src/IMMCTM.jl:225-244. Newton runs on log α so the α >= 1e-7 bound
    (src/MMCTM.jl:254) is preserved by construction; a final clip guards
    against underflow.
    """
    def f_log(u):
        return alpha_objective(jnp.exp(u), sum_Elnphi, K, V)

    def make_body(scales):
        def body(_, u):
            a = jnp.exp(u)
            g_a = alpha_grad(a, sum_Elnphi, K, V)
            # d²/dα² = K·V²·ψ₁(Vα) - K·V·ψ₁(α)
            h_a = K * V * V * polygamma(1, V * a) - K * V * polygamma(1, a)
            g_u = g_a * a
            h_u = h_a * a * a + g_a * a
            # Fall back to a (scaled) gradient step when the log-space Hessian
            # is not negative (α-objective is concave in α, not always in log α).
            delta = jnp.where(h_u < 0, -g_u / h_u, jnp.sign(g_u))
            cand = u + scales * delta
            fvals = jax.vmap(f_log)(cand)
            fvals = jnp.where(jnp.isfinite(fvals), fvals, -jnp.inf)
            return cand[jnp.argmax(fvals)]

        return body

    def polish(_, u):
        a = jnp.exp(u)
        g_a = alpha_grad(a, sum_Elnphi, K, V)
        h_a = K * V * V * polygamma(1, V * a) - K * V * polygamma(1, a)
        # Newton directly in α-space (concave there), mapped back to u.
        step_a = jnp.clip(a - g_a / h_a, ALPHA_LOWER_BOUND)
        step = jnp.where(h_a < 0, jnp.log(step_a), u)
        return jnp.where(jnp.isfinite(step), step, u)

    dtype = jnp.asarray(alpha0).dtype
    u0 = jnp.log(jnp.clip(jnp.asarray(alpha0), ALPHA_LOWER_BOUND))
    u = jax.lax.fori_loop(0, n_iter, make_body(_step_scales(dtype)), u0)
    u = jax.lax.fori_loop(0, _N_POLISH, polish, u)
    return jnp.clip(jnp.exp(u), ALPHA_LOWER_BOUND)
