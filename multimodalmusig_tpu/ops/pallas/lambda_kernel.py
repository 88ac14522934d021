"""The batched λ Newton solve fused into one GPU kernel (Pallas through Triton).

The λ maximization (replacing NLopt LD_MMA, src/MMCTM.jl:127-143) is the hot
op of the CTM fits: a few line-searched Newton steps per document per CAVI
iteration, each solving its Newton system by Jacobi-PCG. As an XLA op graph
every step of that chain is its own small kernel inside the CAVI while_loop.
Here the whole chain runs in one kernel: each program reads its documents'
λ, ν, N/ζ and sumθ once, keeps every Newton, PCG and line-search temporary
in registers, and writes λ back once.

Layout: documents are rows and topics are columns, padded to a power of two
of at least 16 (MK=14 -> 16, MK=19 -> 32). The grid is (restart lanes,
document tiles); a program loads its lane's Σ⁻¹ and μ once and solves one
tile of documents.
Nothing carries between programs. Padded topic columns are exact no-ops:
identity rows in Σ⁻¹, ν=1, λ=μ=N/ζ=sumθ=0 give a zero gradient and a zero
Newton step. Padded document rows are solved on harmless fill values and
never stored.

Matvecs with Σ⁻¹ are `pl.dot` at Precision.HIGHEST, which Triton lowers
with inputPrecision = ieee: exact float32 on the FMA units, no TF32
rounding of the ill-conditioned Σ⁻¹. (A broadcast-multiply-reduce matvec
lost TF32-level accuracy on an H100 — 2e-3 against 7e-7 for this form —
consistent with Triton's combiner rewriting it into a default-precision
dot.)

The algorithm mirrors ops.solvers.maximize_lambda op for op (its constants
are imported from there), so the two agree to float32 rounding.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..solvers import (
    CG_ITER_F32_CAP,
    LAMBDA_POLISH_ITERS,
    _N_BACKTRACK,
    _POLISH_MAX_STEP,
)

__all__ = ["maximize_lambda_fused", "FUSED_MAX_MK", "padded_topics", "launch_config"]

# Largest MK the kernel takes: every Newton and PCG temporary of a tile
# lives in registers, and 32 padded topic columns is the widest measured.
FUSED_MAX_MK = 32


def padded_topics(MK: int) -> int:
    """Topic columns padded to a power of two, at least 16 (tl.dot's
    smallest operand dimension)."""
    return max(16, pl.next_power_of_2(MK))


def launch_config(MK: int) -> tuple[int, int]:
    """(documents per program, warps) for a topic width, from the tile and
    warp sweep at BRCA (MK=14) and PCAWG (MK=19) widths on an H100
    (tools/lambda_sweep.py)."""
    return (64, 4) if padded_topics(MK) <= 16 else (32, 4)


def _lambda_kernel(lam_ref, nu_ref, ndz_ref, st_ref, mu_ref, invS_ref, out_ref,
                   *, D: int, MK: int, MKP: int, tile: int, n_iter: int,
                   cg_iter: int, n_polish: int):
    r = pl.program_id(0)
    rows = pl.program_id(1) * tile + jnp.arange(tile)
    cols = jnp.arange(MKP)
    col_ok = cols < MK
    mask = (rows < D)[:, None] & col_ok[None, :]
    at = (r, rows[:, None], cols[None, :])

    def load(ref, fill):
        return plgpu.load(ref.at[at], mask=mask, other=fill)

    lam = load(lam_ref, 0.0)
    nu = load(nu_ref, 1.0)
    ndz = load(ndz_ref, 0.0)
    st = load(st_ref, 0.0)
    mu = plgpu.load(mu_ref.at[r, cols], mask=col_ok, other=0.0)[None, :]
    S = plgpu.load(
        invS_ref.at[r, cols[:, None], cols[None, :]],
        mask=col_ok[:, None] & col_ok[None, :], other=0.0,
    )
    diag = cols[:, None] == cols[None, :]
    S = jnp.where(diag & ~col_ok[:, None], 1.0, S)  # identity on padded rows
    diagS = jnp.sum(jnp.where(diag, S, 0.0), axis=0)[None, :]

    def matS(v):
        # out[b, j] = Σ_i v[b, i]·S[i, j]; Σ⁻¹ is symmetric
        return pl.dot(v, S, precision=jax.lax.Precision.HIGHEST)

    def rowsum(x):
        return jnp.sum(x, axis=1)[:, None]

    def cg(w, g):
        # Jacobi-PCG for (Σ⁻¹ + diag(w)) δ = g, as ops.solvers._cg_solve
        M = diagS + w
        z = g / M

        def body(_, carry):
            x, r_, z, p, rz = carry
            Ap = matS(p) + w * p
            alpha = rz / (rowsum(p * Ap) + 1e-30)
            x = x + alpha * p
            r_ = r_ - alpha * Ap
            z = r_ / M
            rz_new = rowsum(r_ * z)
            p = z + (rz_new / (rz + 1e-30)) * p
            return x, r_, z, p, rz_new

        init = (jnp.zeros_like(g), g, z, z, rowsum(g * z))
        return jax.lax.fori_loop(0, cg_iter, body, init)[0]

    def newton(_, lam):
        w = ndz * jnp.exp(lam + 0.5 * nu)
        diff = lam - mu
        Sdiff = matS(diff)
        delta = cg(w, -Sdiff + st - w)
        Sdelta = matS(delta)
        q0 = rowsum(diff * Sdiff)
        b = rowsum(delta * Sdiff)
        c2 = rowsum(delta * Sdelta)
        lin0 = rowsum(lam * st)
        lind = rowsum(delta * st)

        # candidate steps as in ops.solvers.maximize_lambda: clipped exps for
        # the over-steps, an exact sqrt chain for the backtracking ladder
        def f_of(s, e_s):
            quad = -0.5 * (q0 + 2.0 * s * b + s * s * c2)
            return quad + lin0 + s * lind - rowsum(w * e_s)

        best_f = -0.5 * q0 + lin0 - rowsum(w)
        best_s = jnp.zeros_like(best_f)
        for s in (8.0, 4.0, 2.0):
            f = f_of(s, jnp.exp(jnp.minimum(s * delta, 60.0)))
            ok = jnp.isfinite(f) & (f > best_f)
            best_f = jnp.where(ok, f, best_f)
            best_s = jnp.where(ok, s, best_s)
        e_s = jnp.exp(jnp.minimum(delta, 60.0))
        s = 1.0
        for _ in range(_N_BACKTRACK):
            f = f_of(s, e_s)
            ok = jnp.isfinite(f) & (f > best_f)
            best_f = jnp.where(ok, f, best_f)
            best_s = jnp.where(ok, s, best_s)
            e_s = jnp.sqrt(e_s)
            s = s / 2.0
        return lam + best_s * delta

    def polish(_, lam):
        w = ndz * jnp.exp(lam + 0.5 * nu)
        delta = cg(w, -matS(lam - mu) + st - w)
        dmax = jnp.max(jnp.abs(delta), axis=1)[:, None]
        delta = delta * jnp.minimum(1.0, _POLISH_MAX_STEP / jnp.maximum(dmax, 1e-30))
        step = lam + delta
        ok = rowsum(jnp.where(jnp.isfinite(step), 0.0, 1.0)) == 0.0
        return jnp.where(ok, step, lam)

    lam = jax.lax.fori_loop(0, n_iter, newton, lam)
    lam = jax.lax.fori_loop(0, n_polish, polish, lam)
    plgpu.store(out_ref.at[at], lam, mask=mask)


@functools.partial(
    jax.jit,
    static_argnames=("n_iter", "cg_iter", "polish_iter", "launch", "interpret"),
)
def maximize_lambda_fused(
    lam0, nu, Ndivzeta, sumtheta, mu, invSigma,
    n_iter: int = 7, cg_iter: int = None, polish_iter: int = None,
    launch: tuple[int, int] | None = None, interpret: bool = False,
):
    """Fused equivalent of ops.solvers.maximize_lambda, in float32.

    Single lane: lam0/nu/Ndivzeta/sumtheta (D, MK), mu (MK,), invSigma
    (MK, MK). Restart-batched: (R, D, MK), (R, MK), (R, MK, MK), each lane
    with its own Gaussian. Under vmap the single-lane call gains the lane
    axis of the grid. Requires MK <= FUSED_MAX_MK. `launch` overrides
    `launch_config(MK)` (documents per program, warps) for the sweep.
    """
    single = lam0.ndim == 2
    if single:
        lam0, nu, Ndivzeta, sumtheta, mu, invSigma = (
            x[None] for x in (lam0, nu, Ndivzeta, sumtheta, mu, invSigma)
        )
    R, D, MK = lam0.shape
    if MK > FUSED_MAX_MK:
        raise ValueError(f"MK={MK} exceeds the fused kernel's limit {FUSED_MAX_MK}")
    if cg_iter is None:
        cg_iter = min(MK, CG_ITER_F32_CAP)
    if polish_iter is None:
        polish_iter = LAMBDA_POLISH_ITERS
    tile, num_warps = launch or launch_config(MK)
    f32 = jnp.float32
    out = pl.pallas_call(
        functools.partial(
            _lambda_kernel, D=D, MK=MK, MKP=padded_topics(MK), tile=tile,
            n_iter=n_iter, cg_iter=cg_iter, n_polish=polish_iter,
        ),
        out_shape=jax.ShapeDtypeStruct((R, D, MK), f32),
        grid=(R, pl.cdiv(D, tile)),
        compiler_params=plgpu.CompilerParams(num_warps=num_warps),
        interpret=interpret,
        name="lambda_newton_pcg",
    )(*(x.astype(f32) for x in (lam0, nu, Ndivzeta, sumtheta, mu, invSigma)))
    out = out.astype(lam0.dtype)
    return out[0] if single else out
