"""Float64 host re-scoring of restart-lane log-likelihoods for selection.

Why this exists: accelerator fits run in float32 and the per-iteration ll
metric is computed INSIDE each fit executable. Different executables — the
unchunked single-dispatch fit, each compaction-phase program, the fused-
kernel arm — round differently, and hundreds of CAVI iterations amplify
that: on BRCA the cross-executable drift of the final f32 ll can exceed the
best-of-N winner margins, so WHICH restart won would depend on which
executables happened to run. The reference's selection (run_mmctm.jl:86-97,
136-147) is deterministic because it runs in f64 on CPU.

The fix: selection never reads the in-fit f32 ll. Every candidate lane's
final per-modality log-likelihood is re-scored in float64 from the final
variational state — the exact same formula the models define (e.g.
mmctm.modality_loglikelihoods, src/MMCTM.jl:384-448), evaluated once,
deterministically, by one code path regardless of which executables
produced the states. The f32-vs-f64 discrepancy for the SAME state is pure
scoring rounding (~1e-5 absolute on BRCA — reductions over ~5e4 cells), so
a shortlist window of 1e-2 around the f32 leader provably contains the true
winner; production paths rescore only the shortlist, measurement tools
rescore everything.

What this does and does not guarantee: the selection metric becomes a
deterministic function of the final states alone (scoring noise gone). The
states themselves can still drift across executables after hundreds of f32
iterations; a pick can only flip when two lanes' true quality gap is inside
that state drift, i.e. a genuine near-tie where either model is defensible.
tools/selection_stability.py quantifies both effects separately.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = [
    "rescore_mmctm_f64",
    "rescore_immctm_f64",
    "rescore_lda_f64",
    "rescore_ilda_f64",
    "rescore_mmctm",
    "rescore_immctm",
    "rescore_lda",
    "rescore_ilda",
    "pick_optimal_modality_restarts_np",
    "pick_optimal_restart_np",
    "dense_rank_np",
    "shortlist_lanes",
]

# f32-vs-f64 scoring gap for the SAME state is ~1e-5 on BRCA-sized
# reductions; 1e-2 gives three orders of magnitude of safety margin while
# still shortlisting only near-winners.
SHORTLIST_WINDOW = 1e-2


def _np64(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float64)


def _softmax64(x: np.ndarray, axis: int = -1) -> np.ndarray:
    e = np.exp(x - np.max(x, axis=axis, keepdims=True))
    return e / np.sum(e, axis=axis, keepdims=True)


def _norm64(x: np.ndarray, axis: int) -> np.ndarray:
    return x / np.sum(x, axis=axis, keepdims=True)


def _xlogp_sum(Xm: np.ndarray, P: np.ndarray) -> np.ndarray:
    """Σ_dv X·log P per lane, zeros of X skipped (the xlogy convention),
    accumulated in float64. P: (R, D, V) positive; Xm: (D, V)."""
    d_idx, v_idx = np.nonzero(Xm)
    xv = _np64(Xm[d_idx, v_idx])
    with np.errstate(divide="ignore", invalid="ignore"):
        logs = np.log(P[:, d_idx, v_idx])  # (R, nnz)
    return logs @ xv


def _lane_chunks(R: int, chunk: int):
    for lo in range(0, R, chunk):
        yield slice(lo, min(lo + chunk, R))


def _feature_index(Fi) -> np.ndarray:
    """(V,) value index per vocab item from either a one-hot (V, J) feature
    matrix (the models' on-device representation, ilda.feature_onehots) or
    an index vector."""
    Fi = np.asarray(Fi)
    return Fi.argmax(axis=1) if Fi.ndim == 2 else Fi.astype(np.int64)


def rescore_mmctm_f64(
    lam,
    gamma,
    X,
    config,
    lanes: Optional[np.ndarray] = None,
    lane_chunk: int = 64,
) -> np.ndarray:
    """Exact f64 per-modality log-likelihoods of batched MMCTM final states.

    Same formula as mmctm.modality_loglikelihoods (src/MMCTM.jl:384-448):
    props = softmax(λ block), ϕ = γ row-normalized, ll_m = Σ xlogy(X, props@ϕ)
    / ΣX — evaluated on the host in float64. `lam` is (R, D, MK); `gamma` a
    tuple of (R, K_m, V_m). `lanes` restricts to a candidate subset (rows of
    the returned (len(lanes), M) matrix follow `lanes` order); None scores
    every lane. Dead lanes (NaN states) come back NaN and are masked by the
    pick functions exactly like the in-fit f32 path.
    """
    lam = _np64(lam)
    gammas = [_np64(g) for g in gamma]
    if lanes is not None:
        lanes = np.asarray(lanes)
        lam = lam[lanes]
        gammas = [g[lanes] for g in gammas]
    R = lam.shape[0]
    M = config.M
    out = np.empty((R, M), np.float64)
    for m in range(M):
        o = config.offsets[m]
        Xm = np.asarray(X[m])
        Xsum = _np64(Xm).sum()
        phi = _norm64(gammas[m], axis=2)  # (R, K, V)
        for sl in _lane_chunks(R, lane_chunk):
            props = _softmax64(lam[sl, :, o : o + config.K[m]])  # (r, D, K)
            with np.errstate(invalid="ignore"):
                P = props @ phi[sl]  # (r, D, V)
            out[sl, m] = _xlogp_sum(Xm, P) / Xsum
    return out


def rescore_immctm_f64(
    lam,
    gamma,
    X,
    F,
    config,
    lanes: Optional[np.ndarray] = None,
    lane_chunk: int = 64,
) -> np.ndarray:
    """Exact f64 per-modality log-likelihoods of batched IMMCTM final states
    (immctm.modality_loglikelihoods, src/IMMCTM.jl:388-428): the topic-word
    table factorizes over features, p(v|k) = Π_i ϕ_m,i[k, F_m[i][v]].
    `gamma` is a tuple over modalities of tuples over features of
    (R, K_m, J_mi)."""
    lam = _np64(lam)
    gammas = [[_np64(g) for g in gm] for gm in gamma]
    if lanes is not None:
        lanes = np.asarray(lanes)
        lam = lam[lanes]
        gammas = [[g[lanes] for g in gm] for gm in gammas]
    R = lam.shape[0]
    M = config.M
    out = np.empty((R, M), np.float64)
    for m in range(M):
        o = config.offsets[m]
        Xm = np.asarray(X[m])
        Xsum = _np64(Xm).sum()
        # (R, K, V): sum of log-normalized γ over features, exp'd
        logB = np.zeros((R, config.K[m], Xm.shape[1]), np.float64)
        for i, g in enumerate(gammas[m]):
            with np.errstate(divide="ignore", invalid="ignore"):
                logphi = np.log(_norm64(g, axis=2))  # (R, K, J_i)
            f = _feature_index(F[m][i])  # (V,) value index per vocab item
            logB += logphi[:, :, f]
        B = np.exp(logB)
        for sl in _lane_chunks(R, lane_chunk):
            props = _softmax64(lam[sl, :, o : o + config.K[m]])
            with np.errstate(invalid="ignore"):
                P = props @ B[sl]
            out[sl, m] = _xlogp_sum(Xm, P) / Xsum
    return out


def rescore_lda_f64(
    gamma, lam, X, lanes: Optional[np.ndarray] = None, lane_chunk: int = 64
) -> np.ndarray:
    """Exact f64 log-likelihoods of batched LDA final states
    (lda.loglikelihood, src/LDA.jl:174-190): θ = γ normalized over topics,
    β = λ normalized over vocab, ll = Σ xlogy(X, θβᵀ)/ΣX. `gamma` (R, D, K),
    `lam` (R, V, K). Returns (R,)."""
    gamma = _np64(gamma)
    lam = _np64(lam)
    if lanes is not None:
        lanes = np.asarray(lanes)
        gamma, lam = gamma[lanes], lam[lanes]
    Xm = np.asarray(X)
    Xsum = _np64(Xm).sum()
    R = gamma.shape[0]
    out = np.empty((R,), np.float64)
    beta = _norm64(lam, axis=1)  # (R, V, K)
    for sl in _lane_chunks(R, lane_chunk):
        theta = _norm64(gamma[sl], axis=2)  # (r, D, K)
        with np.errstate(invalid="ignore"):
            P = theta @ np.swapaxes(beta[sl], 1, 2)  # (r, D, V)
        out[sl] = _xlogp_sum(Xm, P) / Xsum
    return out


def rescore_ilda_f64(
    gamma, lam, X, F, lanes: Optional[np.ndarray] = None, lane_chunk: int = 64
) -> np.ndarray:
    """Exact f64 log-likelihoods of batched ILDA final states
    (ilda.loglikelihood, src/ILDA.jl:209-236): β factorizes over features,
    p(v|k) = Π_i β_i[F[i][v], k]. `gamma` (R, D, K), `lam` a tuple over
    features of (R, J_i, K). Returns (R,)."""
    gamma = _np64(gamma)
    lams = [_np64(l) for l in lam]
    if lanes is not None:
        lanes = np.asarray(lanes)
        gamma = gamma[lanes]
        lams = [l[lanes] for l in lams]
    Xm = np.asarray(X)
    Xsum = _np64(Xm).sum()
    R, K = gamma.shape[0], gamma.shape[2]
    logB = np.zeros((R, Xm.shape[1], K), np.float64)  # (R, V, K)
    for i, l in enumerate(lams):
        with np.errstate(divide="ignore", invalid="ignore"):
            logbeta = np.log(_norm64(l, axis=1))  # (R, J_i, K)
        f = _feature_index(F[i])
        logB += logbeta[:, f, :]
    B = np.exp(logB)
    out = np.empty((R,), np.float64)
    for sl in _lane_chunks(R, 64):
        theta = _norm64(gamma[sl], axis=2)
        with np.errstate(invalid="ignore"):
            P = theta @ np.swapaxes(B[sl], 1, 2)
        out[sl] = _xlogp_sum(Xm, P) / Xsum
    return out


# ---------------------------------------------------------------------------
# Host-side selection on the rescored values (numpy mirrors of
# restarts.pick_optimal_modality_restarts / pick_optimal_restart / dense_rank)
# ---------------------------------------------------------------------------


def dense_rank_np(values: np.ndarray) -> np.ndarray:
    """StatsBase.denserank on the host (run_mmctm.jl:143)."""
    _, inv = np.unique(values, return_inverse=True)
    return inv + 1


def pick_optimal_modality_restarts_np(ll: np.ndarray) -> np.ndarray:
    """(R, M) f64 lls -> (M,) winning restart per modality; non-finite lanes
    excluded (run_mmctm.jl:86-97)."""
    masked = np.where(np.isfinite(ll), ll, -np.inf)
    return np.argmax(masked, axis=0)


def pick_optimal_restart_np(ll: np.ndarray) -> int:
    """(R, M) f64 lls -> index minimizing mean dense-rank of |ll|; non-finite
    lanes rank last (run_mmctm.jl:136-147)."""
    ll = np.asarray(ll, np.float64)
    if ll.ndim == 1:
        ll = ll[:, None]
    vals = np.where(np.isfinite(ll), np.abs(ll), np.inf)
    ranks = np.stack([dense_rank_np(vals[:, m]) for m in range(ll.shape[1])], axis=1)
    mean_rank = np.where(
        np.all(np.isfinite(ll), axis=1), ranks.mean(axis=1), np.inf
    )
    return int(np.argmin(mean_rank))


# ---------------------------------------------------------------------------
# Executor dispatch: identical f64 scores, run where the states live.
# States arrive device-resident from the fits; the host path (above) fetches
# them and scores on the CPU, the device path (parallel/rescore_device.py)
# scores them in native f64 on the accelerator and fetches only the (n, M)
# score matrix. The two agree to f64 reduction-order roundoff (~1e-13,
# tests/test_rescore_device.py), five orders below the winner margins.
# ---------------------------------------------------------------------------


def _use_device_rescore() -> bool:
    from ..ops import flags

    if flags.DEVICE_RESCORE in ("0", "1"):
        return flags.DEVICE_RESCORE == "1"
    import jax

    return jax.default_backend() != "cpu"


def _dispatch(device_call, host_call):
    """Run the device scorer thunk when the device executor is chosen, the
    host thunk otherwise. A device failure raises: selection never carries
    on silently on another executor."""
    if _use_device_rescore():
        return device_call()
    return host_call()


def rescore_mmctm(lam, gamma, X, config, lanes=None) -> np.ndarray:
    """rescore_mmctm_f64 on whichever executor _use_device_rescore picks;
    `lam`/`gamma` may be device-resident (no host fetch on the device path)."""

    def device_call():
        from .rescore_device import rescore_mmctm_f64_dev

        return rescore_mmctm_f64_dev(lam, gamma, X, config, lanes)

    def host_call():
        import jax

        lam_h, gam_h = jax.device_get((lam, tuple(gamma)))
        return rescore_mmctm_f64(
            lam_h, gam_h, [np.asarray(x) for x in X], config, lanes
        )

    return _dispatch(device_call, host_call)


def rescore_immctm(lam, gamma, X, F, config, lanes=None) -> np.ndarray:
    """rescore_immctm_f64 on whichever executor _use_device_rescore picks."""

    def device_call():
        from .rescore_device import rescore_immctm_f64_dev

        return rescore_immctm_f64_dev(lam, gamma, X, F, config, lanes)

    def host_call():
        import jax

        lam_h, gam_h = jax.device_get((lam, tuple(tuple(g) for g in gamma)))
        return rescore_immctm_f64(
            lam_h, gam_h, [np.asarray(x) for x in X], F, config, lanes
        )

    return _dispatch(device_call, host_call)


def rescore_lda(gamma, lam, X, lanes=None) -> np.ndarray:
    """rescore_lda_f64 on whichever executor _use_device_rescore picks."""

    def device_call():
        from .rescore_device import rescore_lda_f64_dev

        return rescore_lda_f64_dev(gamma, lam, X, lanes)

    def host_call():
        import jax

        gam_h, lam_h = jax.device_get((gamma, lam))
        return rescore_lda_f64(gam_h, lam_h, np.asarray(X), lanes)

    return _dispatch(device_call, host_call)


def rescore_ilda(gamma, lam, X, F, lanes=None) -> np.ndarray:
    """rescore_ilda_f64 on whichever executor _use_device_rescore picks."""

    def device_call():
        from .rescore_device import rescore_ilda_f64_dev

        return rescore_ilda_f64_dev(gamma, lam, X, F, lanes)

    def host_call():
        import jax

        gam_h, lam_h = jax.device_get((gamma, tuple(lam)))
        return rescore_ilda_f64(gam_h, lam_h, np.asarray(X), F, lanes)

    return _dispatch(device_call, host_call)


def shortlist_lanes(
    ll_f32: np.ndarray, window: float = SHORTLIST_WINDOW
) -> np.ndarray:
    """Candidate lanes for exact rescoring: every lane whose in-fit f32 ll is
    within `window` of the per-modality f32 leader in ANY modality. The
    f32-vs-f64 gap for the same state is pure scoring rounding (~1e-5), so
    the true per-modality winners are always inside a 1e-2 window."""
    ll = np.asarray(ll_f32, np.float64)
    if ll.ndim == 1:
        ll = ll[:, None]
    masked = np.where(np.isfinite(ll), ll, -np.inf)
    top = masked.max(axis=0, keepdims=True)
    cand = (masked >= top - window).any(axis=1)
    if not cand.any():  # every lane diverged: fall back to scoring them all
        cand = np.ones(ll.shape[0], bool)
    return np.nonzero(cand)[0]
