"""On-device float64 re-scoring — the accelerator path behind rescore.py.

Same scores, different executor: the host rescoring path fetches the full
final states ((R, D, MK) λ plus topic tables) and scores them on the host
CPU, in ~79M float64 `log` evaluations plus ~1.5 GFLOP of batched matmuls
per best-of-1000 BRCA fit. Here the identical formula runs in float64 on the
accelerator, where the states already live (the H100 has native f64), and
the only host transfer left is the (R, M) score matrix.

Determinism contract (see rescore.py's module docstring): selection must
read a deterministic function of the final states alone. One fixed scoring
executable per family/geometry satisfies that exactly like the host path
does; the two paths agree to f64 roundoff (~1e-13 — reduction order is the
only difference), five orders of magnitude below the ~1e-5 winner margins
the f64 re-scoring exists to resolve. tests/test_rescore_device.py pins the
parity; rescore.py's dispatchers pick the executor (device off-CPU by
default, MUSIG_DEVICE_RESCORE to force — ops/flags.py).

Shapes are padded to LANE_CHUNK multiples and scored chunk-by-chunk so each
family compiles ONE executable per data geometry regardless of R or
shortlist size, and the (chunk, D, V) f64 intermediates stay ~100 MB.

Everything here runs inside an enable_x64 scope; the f32 production fits
are traced outside it and are untouched (the x64 flag is part of JAX's
trace-cache key, so the scopes cannot cross-contaminate caches).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "LANE_CHUNK",
    "rescore_mmctm_f64_dev",
    "rescore_immctm_f64_dev",
    "rescore_lda_f64_dev",
    "rescore_ilda_f64_dev",
]

LANE_CHUNK = 256
_HI = jax.lax.Precision.HIGHEST


def _xlogp_mean(Xm, P, Xsum):
    """Σ_dv X·log P / ΣX per lane with the xlogy zero convention (cells where
    X == 0 contribute exactly 0 even when P == 0 there, matching the host
    path's nonzero-gather — rescore._xlogp_sum)."""
    t = jnp.where(Xm > 0, Xm * jnp.log(P), 0.0)
    return jnp.sum(t, axis=(-2, -1)) / Xsum


@partial(jax.jit, static_argnames=("offsets", "ks"))
def _mmctm_chunk(lam, gammas, Xs, offsets, ks):
    """(chunk, M) f64 per-modality lls of a lane chunk — the device mirror of
    rescore.rescore_mmctm_f64's formula (src/MMCTM.jl:384-448)."""
    out = []
    for m, (o, K) in enumerate(zip(offsets, ks)):
        props = jax.nn.softmax(lam[..., o : o + K], axis=-1)  # (r, D, K)
        phi = gammas[m] / jnp.sum(gammas[m], axis=-1, keepdims=True)  # (r, K, V)
        P = jnp.matmul(props, phi, precision=_HI)  # (r, D, V)
        out.append(_xlogp_mean(Xs[m], P, jnp.sum(Xs[m])))
    return jnp.stack(out, axis=-1)


@partial(jax.jit, static_argnames=("offsets", "ks"))
def _immctm_chunk(lam, gammas, fidx, Xs, offsets, ks):
    """(chunk, M) f64 lls; topic-word tables factorized over features,
    p(v|k) = Π_i ϕ_m,i[k, F_m[i][v]] (src/IMMCTM.jl:388-428). `gammas` is a
    tuple over modalities of tuples over features of (r, K, J_i); `fidx` a
    matching tuple of (V,) int value indices."""
    out = []
    for m, (o, K) in enumerate(zip(offsets, ks)):
        props = jax.nn.softmax(lam[..., o : o + K], axis=-1)
        logB = 0.0
        for g, f in zip(gammas[m], fidx[m]):
            logphi = jnp.log(g / jnp.sum(g, axis=-1, keepdims=True))  # (r, K, J)
            logB = logB + logphi[:, :, f]  # (r, K, V)
        P = jnp.matmul(props, jnp.exp(logB), precision=_HI)
        out.append(_xlogp_mean(Xs[m], P, jnp.sum(Xs[m])))
    return jnp.stack(out, axis=-1)


@jax.jit
def _lda_chunk(gamma, lam, X):
    """(chunk,) f64 lls (src/LDA.jl:174-190): θ = γ normalized over topics,
    β = λ normalized over vocab, ll = Σ xlogy(X, θβᵀ)/ΣX."""
    theta = gamma / jnp.sum(gamma, axis=-1, keepdims=True)  # (r, D, K)
    beta = lam / jnp.sum(lam, axis=-2, keepdims=True)  # (r, V, K)
    P = jnp.einsum("rdk,rvk->rdv", theta, beta, precision=_HI)
    return _xlogp_mean(X, P, jnp.sum(X))


@jax.jit
def _ilda_chunk(gamma, lams, fidx, X):
    """(chunk,) f64 lls with per-feature β factorization
    (src/ILDA.jl:209-236)."""
    theta = gamma / jnp.sum(gamma, axis=-1, keepdims=True)
    logB = 0.0
    for l, f in zip(lams, fidx):
        logbeta = jnp.log(l / jnp.sum(l, axis=-2, keepdims=True))  # (r, J, K)
        logB = logB + logbeta[:, f, :]  # (r, V, K)
    P = jnp.einsum("rdk,rvk->rdv", theta, jnp.exp(logB), precision=_HI)
    return _xlogp_mean(X, P, jnp.sum(X))


def _pad_lanes(n: int) -> int:
    return -(-n // LANE_CHUNK) * LANE_CHUNK


@jax.jit
def _take_pad_f64(tree, idx):
    """Gather lanes `idx` (already padded) from every leaf, upcast to f64 —
    one device execution regardless of pytree size (see _gather_tree)."""
    return jax.tree_util.tree_map(
        lambda x: jnp.take(x, idx, axis=0).astype(jnp.float64), tree
    )


def _chunk_indices(lanes: Optional[np.ndarray], R: int):
    """Padded lane-index array (multiple of LANE_CHUNK; tail repeats lane 0
    so every chunk runs the same executable) and the true count. Bounds are
    checked HERE because jit's gather clamps/fills out-of-range indices
    silently — the host path's `lam[lanes]` raises, and the two executors
    must not differ on invalid input."""
    idx = np.arange(R) if lanes is None else np.asarray(lanes)
    if idx.size and (idx.min() < -R or idx.max() >= R):
        raise IndexError(
            f"lane indices out of range for {R} restarts: "
            f"[{idx.min()}, {idx.max()}]"
        )
    idx = np.where(idx < 0, idx + R, idx)
    n = int(idx.size)
    pad = _pad_lanes(max(n, 1))
    full = np.zeros(pad, np.int32)
    full[:n] = idx
    return full, n


def _run_chunks(score_one, tree, idx, n):
    outs = []
    with jax.enable_x64(True):
        for lo in range(0, idx.size, LANE_CHUNK):
            sub = _take_pad_f64(tree, jnp.asarray(idx[lo : lo + LANE_CHUNK]))
            outs.append(np.asarray(jax.device_get(score_one(sub))))
    return np.concatenate(outs, axis=0)[:n]


def _feature_indices(F) -> tuple:
    """(V,) int32 value index per vocab item from one-hot (V, J) feature
    matrices or index vectors (rescore._feature_index, device-resident)."""
    out = []
    for Fi in F:
        Fi = np.asarray(Fi)
        out.append(
            jnp.asarray(Fi.argmax(axis=1) if Fi.ndim == 2 else Fi, jnp.int32)
        )
    return tuple(out)


def rescore_mmctm_f64_dev(lam, gamma, X, config, lanes=None) -> np.ndarray:
    """Device-f64 mirror of rescore.rescore_mmctm_f64 (same signature minus
    lane_chunk; `lam`/`gamma` may be device-resident). Returns (n, M) f64."""
    idx, n = _chunk_indices(lanes, int(np.shape(lam)[0]))
    offsets, ks = config.offsets, tuple(config.K)
    with jax.enable_x64(True):
        # astype, not np.asarray round-trip: device-resident X upcasts on
        # device; only host-resident X pays an upload.
        Xs = tuple(jnp.asarray(x).astype(jnp.float64) for x in X)

        def score(sub):
            lam_c, gam_c = sub
            return _mmctm_chunk(lam_c, gam_c, Xs, offsets, ks)

        return _run_chunks(score, (jnp.asarray(lam), tuple(gamma)), idx, n)


def rescore_immctm_f64_dev(lam, gamma, X, F, config, lanes=None) -> np.ndarray:
    """Device-f64 mirror of rescore.rescore_immctm_f64. Returns (n, M) f64."""
    idx, n = _chunk_indices(lanes, int(np.shape(lam)[0]))
    offsets, ks = config.offsets, tuple(config.K)
    fidx = tuple(_feature_indices(Fm) for Fm in F)
    with jax.enable_x64(True):
        Xs = tuple(jnp.asarray(x).astype(jnp.float64) for x in X)

        def score(sub):
            lam_c, gam_c = sub
            return _immctm_chunk(lam_c, gam_c, fidx, Xs, offsets, ks)

        tree = (jnp.asarray(lam), tuple(tuple(gm) for gm in gamma))
        return _run_chunks(score, tree, idx, n)


def rescore_lda_f64_dev(gamma, lam, X, lanes=None) -> np.ndarray:
    """Device-f64 mirror of rescore.rescore_lda_f64. Returns (n,) f64."""
    idx, n = _chunk_indices(lanes, int(np.shape(gamma)[0]))
    with jax.enable_x64(True):
        Xd = jnp.asarray(X).astype(jnp.float64)

        def score(sub):
            gam_c, lam_c = sub
            return _lda_chunk(gam_c, lam_c, Xd)

        return _run_chunks(score, (jnp.asarray(gamma), jnp.asarray(lam)), idx, n)


def rescore_ilda_f64_dev(gamma, lam, X, F, lanes=None) -> np.ndarray:
    """Device-f64 mirror of rescore.rescore_ilda_f64. Returns (n,) f64."""
    idx, n = _chunk_indices(lanes, int(np.shape(gamma)[0]))
    fidx = _feature_indices(F)
    with jax.enable_x64(True):
        Xd = jnp.asarray(X).astype(jnp.float64)

        def score(sub):
            gam_c, lam_c = sub
            return _ilda_chunk(gam_c, lam_c, fidx, Xd)

        tree = (jnp.asarray(gamma), tuple(jnp.asarray(l) for l in lam))
        return _run_chunks(score, tree, idx, n)
