"""Multi-restart fitting as a vmap axis — the accelerator replacement for the
reference's `Distributed.pmap` restart fan-out (scripts/run_mmctm.jl:99-161).

The reference fits R=1000 independent MMCTMs on separate Julia worker
processes, then runs a two-stage protocol:
  1. `fit_restart`: R random inits, fit!(maxiter=1000, tol=1e-4)
     (run_mmctm.jl:77-84); `pick_optimal_modality_models` selects, per
     modality, the restart with the best modality log-likelihood
     (run_mmctm.jl:86-97, findmax over the (R, M) ll matrix).
  2. `seed_and_fit_restart`: fresh models with the per-modality-best
     topic-word posteriors grafted in (γ/Elnϕ/ϕ per modality,
     run_mmctm.jl:113-134), refit with tol=1e-5; `pick_optimal_model`
     takes the min mean dense-rank of |ll| across modalities
     (run_mmctm.jl:136-147).

Here restarts are a leading vmap axis: one compiled program fits every
restart simultaneously, with per-lane convergence handled by the batched
while_loop (converged lanes stop changing). Communication between restarts
is zero during fitting, exactly as in the reference.

Documented divergence: the reference's stage-2 restarts are deterministic
duplicates — `seed_and_fit_restart` grafts γ/Elnϕ/ϕ for *every* modality
over the fresh random init (run_mmctm.jl:126-130), and all remaining state
(λ=0, ν=1, uniform θ, ζ) initializes deterministically, so its R stage-2
workers compute R identical models and the rank-based pick returns the
first. We therefore run stage 2 once by default (`stage2_restarts=1`),
reproducing the reference's result at 1/R the cost. The same holds here:
raising `stage2_restarts` only adds identical lanes (the per-lane random γ
is entirely overwritten by the graft), pinned by
tests/test_parallel.py::test_stage2_restarts_are_duplicates.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..models import mmctm as mmctm_mod
from ..models.ctm_base import (
    carry_converged,
    counts_per_doc,
    make_cavi_carry,
    run_cavi_from,
)
from ..models.mmctm import MMCTM, MMCTMConfig, MMCTMFitResult, init_with_alpha

__all__ = [
    "dense_rank",
    "pick_optimal_modality_restarts",
    "pick_optimal_restart",
    "select_modality_winners_f64",
    "select_best_restart_f64",
    "fit_restarts",
    "fit_restarts_auto",
    "two_stage_fit",
    "fit_mmctm_restarts",
    "suggest_compact_schedule",
    "measure_boundary_seconds",
    "auto_compact_schedule",
]


def suggest_compact_schedule(
    iters,
    maxiter: Optional[int] = None,
    boundary_cost_lane_iters: float = 8_000.0,
    max_boundaries: int = 3,
    production_restarts: Optional[int] = None,
    margin_z: float = 1.0,
):
    """Pick compaction boundaries for `fit_restarts(compact_schedule=...)`
    from a pilot fit's per-lane iteration counts (`FitResult.n_iters`).

    A vmapped fit costs (active lanes) x (iterations) of device work per
    phase, with converged lanes padding up to the next power of two after
    each compaction (see _chunked_drive), and each boundary costing one
    compaction round-trip (`boundary_cost_lane_iters`, in units of
    lane-iterations; the 8000 default is an unmeasured placeholder — the
    auto paths replace it with a boundary cost measured on the device).
    Boundary placement is solved EXACTLY by dynamic programming over the
    observed iteration counts (shortest path: phase cost =
    active-bucket x phase length, plus the boundary charge per cut), for up
    to `max_boundaries` cuts. Returns the schedule as cumulative-budget
    increments — or () when no boundary beats the single dispatch (e.g. a
    tight distribution).

    `max_boundaries` defaults to 3, a hypothesis not yet measured on a GPU:
    the linear-in-lanes cost model has no small-bucket floor, so beyond a
    few cuts it overestimates the gain from shrinking already-small buckets
    (per-iteration device time stops scaling below some bucket size).

    Workflow: run the pilot at small R (or take stage-1's n_iters), then
    fit the production R with the suggested schedule. The iteration
    distribution is a property of data/tolerance, not of R, so a pilot
    transfers (BRCA: R=100 and R=1000 distributions match to a few
    percent). Pass `production_restarts` when the
    production fit's lane count differs from the pilot's: phase costs
    scale with R while the boundary charge is absolute, so a small pilot
    fed in raw makes boundaries look relatively ~R/P times too expensive
    and the DP under-compacts.

    `margin_z` guards the bucket edges against survivor-count noise. The
    exact DP on a pilot cuts exactly where survivors drop to a power of
    two (e.g. 511 of 1000 on BRCA), but the production count is a noisy
    realization of the pilot's survivor fraction — different lane seeds
    (binomial, sd ≈ R·√(p(1-p)(1/P+1/R))), plus the few-iteration drift
    the compacted phases' own f32 rounding induces. One lane over the
    edge doubles the next phase's padded batch (e.g. a first cut that
    leaves 542 survivors runs phase 2 at bucket 1024). The DP therefore
    buckets mean + margin_z·sd survivors; margin_z=0
    restores the exact empirical DP.
    """
    iters = np.asarray(iters)
    iters = iters[np.isfinite(iters)].astype(np.int64)
    if iters.size == 0:
        return ()
    P = iters.size
    # production_restarts is None means "schedule THE run these counts came
    # from" (exact-measurement semantics); any explicit value — even one
    # numerically equal to P — means pilot extrapolation and keeps the
    # pilot-sampling margin term (fit_restarts_auto routinely lands on
    # production == pilot size, e.g. restarts=100 -> 50/50).
    exact_counts = production_restarts is None
    R = P if exact_counts else int(production_restarts)
    hi = int(iters.max()) if maxiter is None else min(int(iters.max()), maxiter)
    cuts = np.unique(iters)
    cuts = cuts[cuts < hi]
    if cuts.size == 0:
        return ()

    def bucket(n):
        return 0 if n == 0 else 1 << (int(n) - 1).bit_length()

    # survivors after cut c = lanes needing > c iterations; their padded
    # power-of-two batch is the active-lane count of the following phase.
    # Production survivors are predicted from the pilot fraction with a
    # margin_z-sigma safety margin before bucketing (see docstring).
    sorted_it = np.sort(iters)

    def surv_pred(c):
        s_p = P - int(np.searchsorted(sorted_it, c, side="right"))
        if s_p == 0:
            return 0
        p = s_p / P
        if exact_counts:
            # exact-measurement caller: the iters ARE the production run's
            # own counts, so there is no pilot-sampling term — only the f32
            # phase drift (compacted phases are different executables whose
            # rounding re-ranks lanes near a cut). Model each near-boundary
            # lane's survival flip as binomial: sd = sqrt(R p (1-p)).
            sd = np.sqrt(R * p * (1.0 - p))
        else:
            # pilot-extrapolation caller: binomial sampling of the pilot
            # (1/P) plus the production realization (1/R)
            sd = R * np.sqrt(p * (1.0 - p) * (1.0 / P + 1.0 / R))
        # clamp: more than R production survivors is impossible — without it
        # a near-1 pilot fraction plus the margin prices early phases at
        # bucket(>R), a cost level the real fit can never reach
        return min(int(np.ceil(R * p + margin_z * sd)), R)

    surv_bucket = np.array([bucket(surv_pred(c)) for c in cuts], dtype=np.float64)
    cuts_f = cuts.astype(np.float64)
    n = cuts.size
    B = float(boundary_cost_lane_iters)

    # Layered DP: dp[j] = min cost of the phases up to (and including) a
    # boundary at cuts[j] using EXACTLY k boundaries; transitions add
    # bucket(survivors(i)) x (c_j - c_i) + B. Exact for any boundary count.
    best_cost = float(R) * hi            # no boundaries at all
    best_bounds = ()
    dp = R * cuts_f + B                  # k = 1
    parents = []                         # parents[k-2][j] for chains of k >= 2
    for k in range(1, max_boundaries + 1):
        finish = dp + surv_bucket * (hi - cuts_f)
        j = int(np.argmin(finish))
        if finish[j] < best_cost:
            best_cost = float(finish[j])
            chain = [j]
            for lvl in range(k - 2, -1, -1):
                chain.append(int(parents[lvl][chain[-1]]))
            best_bounds = tuple(int(cuts[i]) for i in reversed(chain))
        if k == max_boundaries:
            break
        trans = (
            dp[:, None]
            + surv_bucket[:, None] * (cuts_f[None, :] - cuts_f[:, None])
            + B
        )
        trans[np.tril_indices(n)] = np.inf  # predecessor must be earlier
        prev = np.argmin(trans, axis=0)
        parents.append(prev)
        dp = trans[prev, np.arange(n)]
    # cumulative boundaries -> per-phase budget increments
    out, prev_c = [], 0
    for c in best_bounds:
        out.append(int(c) - prev_c)
        prev_c = int(c)
    return tuple(out)


_BOUNDARY_CACHE: dict = {}


def measure_boundary_seconds_cached(reps: int = 5) -> float:
    """measure_boundary_seconds memoized per default device: the boundary
    round-trip is a property of the device attachment (transfer latency +
    dispatch), not of the data, so auto-compact fits after the first reuse
    the calibration instead of measuring it again."""
    key = str(jax.devices()[0])
    if key not in _BOUNDARY_CACHE:
        _BOUNDARY_CACHE[key] = measure_boundary_seconds(reps)
    return _BOUNDARY_CACHE[key]


def measure_boundary_seconds(reps: int = 5) -> float:
    """Measured wall-clock of one compaction boundary's host round-trip on
    the CURRENT default device: a small control transfer (the (it, done)
    read that decides compaction) plus one fused-dispatch enqueue+completion.
    This is what a boundary costs beyond the lane-iterations it runs: two
    host-device round trips plus one dispatch."""
    import time

    control = jnp.zeros((64,), jnp.int32)
    payload = jnp.ones((1024,), jnp.float32)
    idx = jnp.arange(512)

    @jax.jit
    def fused(p, i):
        g = p[i] * 1.0000001
        return g, g[:64].astype(jnp.int32) + control

    _, c = jax.block_until_ready(fused(payload, idx))  # compile outside timing
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.device_get(c)            # the boundary's control sync
        out = jax.block_until_ready(fused(payload, idx))  # the fused dispatch
        best = min(best, time.perf_counter() - t0)
        c = out[1]
    return best


def auto_compact_schedule(
    key: jax.Array,
    X,
    config: MMCTMConfig,
    alpha: jnp.ndarray,
    restarts: int,
    maxiter: int = 1000,
    tol: float = 1e-4,
    pilot_restarts: int = 64,
    init_method: str = "random",
    max_boundaries: int = 3,
):
    """Derive a compaction schedule for `fit_restarts` with no manual pilot
    step (the reference CLI is zero-config at R=1000, run_mmctm.jl:52):

      1. fit a small pilot (`pilot_restarts` lanes, same data/tol — the
         iteration distribution is a property of data+tolerance, not R);
      2. re-run the warm pilot to measure the device's lane-iterations/s;
      3. measure one boundary round-trip (`measure_boundary_seconds`);
      4. hand the DP the measured boundary cost in lane-iteration units.

    Returns (schedule, info) where info records the measurements for
    logging/bench provenance. The pilot uses a key folded away from the
    production stream so auto-compaction never changes which restarts the
    production fit runs."""
    import time

    X = tuple(X)
    pilot_R = max(2, min(int(pilot_restarts), int(restarts)))
    pk = jax.random.fold_in(key, 0x9E3779B9)
    keys = jax.random.split(pk, pilot_R)
    # AOT-split compile from execution so the pilot runs ONCE: lowering +
    # compiling first, then timing the single execution that also yields
    # n_iters (a naive "cold run for iters, warm re-run for the rate" pays
    # the whole pilot fit twice). _pilot_executable memoizes the compiled
    # object per signature — jax.jit's cache does not serve
    # .lower().compile() calls, so a bare AOT compile here would re-lower
    # the full while_loop program (~0.5 s host-side) on every call.
    compiled = _pilot_executable(
        keys, X, config, alpha, maxiter, tol, init_method
    )
    # the iteration counts are needed on the host anyway, and fetching
    # them cannot return before the executable has produced the data
    t0 = time.perf_counter()
    result = compiled(keys, X, alpha)
    iters = np.asarray(jax.device_get(result.n_iters))
    t_warm = time.perf_counter() - t0
    # shared derivation: cached boundary calibration + schedule memo (the
    # memo keeps repeat derivations from flipping schedules on pilot-wall
    # timing noise, which would force fresh phase-executable compiles)
    return _derive_auto_schedule(
        iters, t_warm, int(restarts), maxiter, max_boundaries
    )


def dense_rank(values: jnp.ndarray) -> jnp.ndarray:
    """StatsBase.denserank: smallest value gets rank 1, ties share a rank,
    ranks are consecutive (run_mmctm.jl:143 uses denserank(abs.(ll)))."""
    s = jnp.sort(values)
    is_new = jnp.concatenate([jnp.ones((1,), bool), s[1:] != s[:-1]])
    distinct = jnp.cumsum(is_new)
    pos = jnp.searchsorted(s, values, side="left")
    return distinct[pos]


def pick_optimal_modality_restarts(ll: jnp.ndarray) -> jnp.ndarray:
    """(R, M) lls -> (M,) restart index with the best ll per modality
    (run_mmctm.jl:86-97: findmax along the restart axis).

    Non-finite lanes (diverged restarts) are excluded — the reference's pmap
    fan-out would abort the whole run on a failed worker; here a bad lane
    just loses the selection (SURVEY.md §5 failure-recovery note)."""
    masked = jnp.where(jnp.isfinite(ll), ll, -jnp.inf)
    return jnp.argmax(masked, axis=0)


def pick_optimal_restart(ll: jnp.ndarray) -> jnp.ndarray:
    """(R, M) lls -> scalar index minimizing the mean dense-rank of |ll|
    across modalities (run_mmctm.jl:136-147). Non-finite lanes rank last."""
    ranks = jax.vmap(dense_rank, in_axes=1, out_axes=1)(
        jnp.where(jnp.isfinite(ll), jnp.abs(ll), jnp.inf)
    )
    mean_rank = jnp.where(
        jnp.all(jnp.isfinite(ll), axis=1), ranks.mean(axis=1), jnp.inf
    )
    return jnp.argmin(mean_rank)


def lane(batched_pytree, i):
    """Extract restart lane i from a vmapped pytree."""
    return jax.tree_util.tree_map(lambda x: x[i], batched_pytree)


@partial(jax.jit, static_argnames=("config", "maxiter", "tol", "init_method"))
def fit_restarts_from_keys(
    keys: jax.Array,
    X,
    config: MMCTMConfig,
    alpha: jnp.ndarray,
    maxiter: int = 1000,
    tol: float = 1e-4,
    init_method: str = "random",
) -> MMCTMFitResult:
    """Fit one restart per PRNG key in `keys` (R, ...), vmapped into a single
    compiled program. Accepts pre-sharded keys so the restart axis can live
    on a device mesh."""
    X = tuple(X)

    def one(k):
        state = init_with_alpha(k, config, X, alpha, init_method)
        return mmctm_mod.fit(state, X, config, maxiter=maxiter, tol=tol)

    return jax.vmap(one)(keys)


@partial(jax.jit, static_argnames=("config", "maxiter", "init_method"))
def _init_carries(keys, X, config, alpha, maxiter, init_method="random"):
    def one(k):
        state = init_with_alpha(k, config, X, alpha, init_method)
        return make_cavi_carry(state, config, maxiter)

    return jax.vmap(one)(keys)


def _advance_body(carries, X, config, maxiter, tol, chunk):
    """Advance every lane by up to `chunk` CAVI iterations (None = to
    maxiter / per-lane convergence). Shared by the standalone jit below and
    the fused boundary (_boundary_carries)."""
    X = tuple(X)
    N = counts_per_doc(X)
    step = mmctm_mod.fit_step_fn(X, N, config)

    def one(carry):
        return run_cavi_from(carry, maxiter, tol, step, max_new_iters=chunk)

    return jax.vmap(one)(carries)


_advance_carries = partial(
    jax.jit, static_argnames=("config", "maxiter", "tol", "chunk")
)(_advance_body)


@partial(jax.jit, static_argnames=("config", "maxiter", "tol", "b"))
def _boundary_carries(c, done_idx, pad_idx, X, config, maxiter, tol, b):
    """Fused MMCTM compaction boundary: done-lane gather + survivor re-pack
    + next advance as ONE jitted device execution.

    MODULE-LEVEL on purpose: jax.jit caches on the function object, so a
    jit-wrapped closure built inside the drive loop can never hit the cache
    across fits — every fit re-traces and re-loads each boundary executable.
    Here each distinct (carry shapes, budget) pair
    compiles once per process and every later fit dispatches the cached
    executable."""
    done_grp = jax.tree_util.tree_map(lambda x: x[done_idx], c)
    packed = jax.tree_util.tree_map(lambda x: x[pad_idx], c)
    return done_grp, _advance_body(packed, X, config, maxiter, tol, b)


@jax.jit
def _split_tree(tree, done_idx, pad_idx):
    """Done-lane gather + survivor re-pack as ONE device execution — the
    unfused boundary fallback for _chunked_drive callers that pass no
    fused `boundary` (every in-repo family driver now passes one)."""
    return (
        jax.tree_util.tree_map(lambda x: x[done_idx], tree),
        jax.tree_util.tree_map(lambda x: x[pad_idx], tree),
    )


@partial(jax.jit, static_argnames=("config",))
def _finalize_carries(carries, X, config):
    X = tuple(X)
    N = counts_per_doc(X)
    return jax.vmap(lambda c: mmctm_mod.finalize_fit(c, X, N, config))(carries)


def fit_restarts(
    key: jax.Array,
    X,
    config: MMCTMConfig,
    alpha: jnp.ndarray,
    restarts: int,
    maxiter: int = 1000,
    tol: float = 1e-4,
    init_method: str = "random",
    chunk_iters: int = None,
    compact_schedule: Optional[Sequence[int]] = None,
    progress=None,
) -> MMCTMFitResult:
    """Fit `restarts` independently-initialized MMCTMs in one compiled
    program (replaces pmap(fit_restart), run_mmctm.jl:99-111). Returns a
    batched MMCTMFitResult with a leading restart axis.

    `chunk_iters` bounds the CAVI iterations per device execution: the fit
    becomes a host loop over resumable chunks (identical math/results),
    observable between chunks.

    `compact_schedule` is the 2-phase straggler fit: a vmapped while_loop
    runs every lane until the SLOWEST converges, so at reference-default
    scale (R=1000, run_mmctm.jl:52) the max-iteration tail (~3x the median
    on BRCA) dominates device work. `compact_schedule=(c1, c2, ...)` runs
    all lanes c1 iterations, compacts converged lanes out on device, runs
    c2 more, ... and finishes survivors unbounded once the schedule is
    exhausted. Same math as the single-dispatch fit — bit-identical on CPU
    (tests/test_chunked.py); on an accelerator the phase programs are
    separate executables whose f32 rounding differs, which hundreds of CAVI
    iterations amplify on a few lanes' final ll. Each boundary costs one
    host round-trip. Mutually exclusive with `chunk_iters` (which compacts
    at a fixed cadence).

    `progress(done, total)` streams per-round completed-restart counts
    (requires `chunk_iters` or `compact_schedule`: an unchunked fit is one
    device dispatch with nothing observable until it returns).
    """
    if chunk_iters is None and not compact_schedule:
        return fit_restarts_from_keys(
            jax.random.split(key, restarts), X, config, alpha,
            maxiter=maxiter, tol=tol, init_method=init_method,
        )
    return _fit_scheduled_from_keys(
        jax.random.split(key, restarts), X, config, alpha,
        maxiter=maxiter, tol=tol, init_method=init_method,
        schedule=_resolve_schedule(chunk_iters, compact_schedule),
        progress=progress,
    )


def _fit_scheduled_from_keys(
    keys, X, config, alpha, maxiter, tol, init_method, schedule, progress=None
) -> MMCTMFitResult:
    """The compacted (host-driven) restart fit from explicit per-lane keys —
    the engine behind fit_restarts(compact_schedule=...) and the folded
    auto-compact production phase (fit_restarts_auto)."""
    X = tuple(X)
    restarts = int(keys.shape[0])
    carries = _init_carries(keys, X, config, alpha, maxiter, init_method)
    final = _chunked_drive(
        carries,
        lambda c, b: _advance_carries(c, X, config, maxiter, tol, b),
        maxiter,
        restarts,
        progress=progress,
        schedule=schedule,
        boundary=lambda c, d, p, b: _boundary_carries(
            c, d, p, X, config, maxiter, tol, b
        ),
    )
    return _finalize_carries(final, X, config)


_PILOT_EXEC_CACHE: dict = {}
_PILOT_EXEC_CACHE_MAX = 32


def _pilot_cache_put(sig, exe):
    """Insert with FIFO eviction. Model-selection sweeps with
    compact_schedule="auto" create one pilot executable per (family, K,
    shapes, budgets) signature; without a cap a long-lived process would
    retain every compiled while_loop program forever."""
    _PILOT_EXEC_CACHE[sig] = exe
    while len(_PILOT_EXEC_CACHE) > _PILOT_EXEC_CACHE_MAX:
        _PILOT_EXEC_CACHE.pop(next(iter(_PILOT_EXEC_CACHE)))


def _pilot_executable(keys, X, config, alpha, maxiter, tol, init_method):
    """AOT-compiled pilot fit, memoized per signature: jax.jit's cache does
    not serve `.lower().compile()` calls, so without this every
    auto-compact fit re-lowers the full while_loop program (~0.5 s of
    host-side MLIR work) even when the executable is byte-identical. The
    AOT split itself is load-bearing — the pilot must run exactly once and
    be timed, which a cold jit call (compile + run fused) cannot give."""
    sig = (
        tuple((x.shape, str(x.dtype)) for x in X),
        keys.shape, str(keys.dtype), config,
        alpha.shape, str(alpha.dtype),
        maxiter, tol, init_method, str(jax.devices()[0]),
    )
    if sig not in _PILOT_EXEC_CACHE:
        _pilot_cache_put(sig, fit_restarts_from_keys.lower(
            keys, X, config, alpha,
            maxiter=maxiter, tol=tol, init_method=init_method,
        ).compile())
    return _PILOT_EXEC_CACHE[sig]


@jax.jit
def _concat_results(a, b):
    """Concatenate two batched FitResults along the restart axis as one
    device execution (the folded auto-compact fit's pilot + production
    halves; works on any family's result pytree)."""
    return jax.tree_util.tree_map(
        lambda x, y: jnp.concatenate([x, y], axis=0), a, b
    )


@partial(jax.jit, static_argnames=("config", "maxiter", "tol"))
def _lda_restarts_from_keys(keys, Xd, config, maxiter, tol):
    """One LDA restart per PRNG key, vmapped into a single program.
    MODULE-LEVEL with X as an argument (the fit_restarts_from_keys
    pattern) so repeated fitter calls hit jax.jit's in-memory cache
    instead of re-tracing a fresh closure per call."""
    from ..models import lda as lda_mod

    def one(key):
        return lda_mod.fit(
            lda_mod.init(key, config), Xd, config, maxiter=maxiter, tol=tol
        )

    return jax.vmap(one)(keys)


@partial(jax.jit, static_argnames=("config", "maxiter", "tol"))
def _ilda_restarts_from_keys(keys, Xd, F, config, maxiter, tol):
    """One ILDA restart per PRNG key (see _lda_restarts_from_keys)."""
    from ..models import ilda as ilda_mod

    def one(key):
        return ilda_mod.fit(
            ilda_mod.init(key, config), Xd, F, config, maxiter=maxiter, tol=tol
        )

    return jax.vmap(one)(keys)


@partial(jax.jit, static_argnames=("config", "maxiter", "tol"))
def _immctm_restarts_from_keys(keys, Xd, F, alpha_full, config, maxiter, tol):
    """One IMMCTM restart per PRNG key (see _lda_restarts_from_keys).
    `alpha_full` is the per-modality-per-feature α every lane starts from
    (the wrapper ctor's scalar-α expansion, src/IMMCTM.jl:24-63)."""
    from ..models import immctm as immctm_mod

    def one(key):
        state = immctm_mod.init(key, config, [np.zeros(i) for i in config.I])
        return immctm_mod.fit(
            state._replace(alpha=alpha_full), Xd, F, config,
            maxiter=maxiter, tol=tol,
        )

    return jax.vmap(one)(keys)


@partial(jax.jit, static_argnames=("config", "maxiter"))
def _lda_init_carries(keys, config, maxiter):
    """Batched (state, ll_history, iters, converged) carries for the LDA
    chunked driver. MODULE-LEVEL jits (here through _immctm_finalize) for
    the same reason as the runners above: closure jits re-trace per call."""
    from ..models import lda as lda_mod

    def one(k):
        return (
            lda_mod.init(k, config),
            jnp.zeros((maxiter,), config.dtype),
            jnp.int32(0),
            jnp.array(False),
        )

    return jax.vmap(one)(keys)


def _lda_advance_body(carries, Xd, config, maxiter, tol, chunk):
    from ..models import lda as lda_mod

    def one(c):
        return run_cavi_from(
            c, maxiter, tol, lambda s: lda_mod._fit_step(s, Xd, config),
            max_new_iters=chunk,
        )

    return jax.vmap(one)(carries)


_lda_advance = partial(
    jax.jit, static_argnames=("config", "maxiter", "tol", "chunk")
)(_lda_advance_body)


def _make_family_boundary(advance_body):
    """Fused compaction boundary for a family driver (see
    _boundary_carries for why it must be a module-level jit): done-lane
    gather + survivor re-pack + next advance as ONE device execution.
    Applied at module scope so each family shares one definition while
    keeping its own jit cache."""

    @partial(jax.jit, static_argnames=("config", "maxiter", "tol", "b"))
    def boundary(c, done_idx, pad_idx, *data, config, maxiter, tol, b):
        done_grp = jax.tree_util.tree_map(lambda x: x[done_idx], c)
        packed = jax.tree_util.tree_map(lambda x: x[pad_idx], c)
        return done_grp, advance_body(packed, *data, config, maxiter, tol, b)

    return boundary


_lda_boundary = _make_family_boundary(_lda_advance_body)


@partial(jax.jit, static_argnames=("config",))
def _lda_finalize(carries, Xd, config):
    from ..models import lda as lda_mod

    def one(c):
        return lda_mod.LDAFitResult(
            state=c[0], ll_history=c[1], n_iters=c[2],
            converged=carry_converged(c[1], c[2], c[3]),
            elbo=lda_mod.calculate_elbo(c[0], Xd, config), ll=c[1][c[2] - 1],
        )

    return jax.vmap(one)(carries)


@partial(jax.jit, static_argnames=("config", "maxiter"))
def _ilda_init_carries(keys, config, maxiter):
    from ..models import ilda as ilda_mod

    def one(k):
        return (
            ilda_mod.init(k, config),
            jnp.zeros((maxiter,), config.dtype),
            jnp.int32(0),
            jnp.array(False),
        )

    return jax.vmap(one)(keys)


def _ilda_advance_body(carries, Xd, F, config, maxiter, tol, chunk):
    from ..models import ilda as ilda_mod

    step = ilda_mod.fit_step_fn(Xd, F, config)

    def one(c):
        return run_cavi_from(c, maxiter, tol, step, max_new_iters=chunk)

    return jax.vmap(one)(carries)


_ilda_advance = partial(
    jax.jit, static_argnames=("config", "maxiter", "tol", "chunk")
)(_ilda_advance_body)


_ilda_boundary = _make_family_boundary(_ilda_advance_body)


@partial(jax.jit, static_argnames=("config",))
def _ilda_finalize(carries, Xd, F, config):
    from ..models import ilda as ilda_mod

    def one(c):
        return ilda_mod.ILDAFitResult(
            state=c[0], ll_history=c[1], n_iters=c[2],
            converged=carry_converged(c[1], c[2], c[3]),
            elbo=ilda_mod.calculate_elbo(c[0], Xd, F, config),
            ll=c[1][c[2] - 1],
        )

    return jax.vmap(one)(carries)


@partial(jax.jit, static_argnames=("config", "maxiter"))
def _immctm_init_carries(keys, alpha_full, config, maxiter):
    from ..models import immctm as immctm_mod

    def one(k):
        st = immctm_mod.init(k, config, [np.zeros(i) for i in config.I])
        return make_cavi_carry(st._replace(alpha=alpha_full), config, maxiter)

    return jax.vmap(one)(keys)


def _immctm_advance_body(carries, Xd, F, config, maxiter, tol, chunk):
    from ..models import immctm as immctm_mod

    step = immctm_mod.fit_step_fn(Xd, counts_per_doc(Xd), F, config)

    def one(c):
        return run_cavi_from(c, maxiter, tol, step, max_new_iters=chunk)

    return jax.vmap(one)(carries)


_immctm_advance = partial(
    jax.jit, static_argnames=("config", "maxiter", "tol", "chunk")
)(_immctm_advance_body)


_immctm_boundary = _make_family_boundary(_immctm_advance_body)


@partial(jax.jit, static_argnames=("config",))
def _immctm_finalize(carries, Xd, F, config):
    from ..models import immctm as immctm_mod

    N = counts_per_doc(Xd)

    def one(c):
        return immctm_mod.IMMCTMFitResult(
            state=c[0], ll_history=c[1], n_iters=c[2],
            converged=carry_converged(c[1], c[2], c[3]),
            elbo=immctm_mod.calculate_elbo(c[0], Xd, N, F, config),
            ll=c[1][c[2] - 1],
        )

    return jax.vmap(one)(carries)


class _FamilyRunner:
    """Binds a module-level jitted runner to its non-key arguments so the
    family fitters and _family_restarts_auto share one call/lower surface.

    Because the runner functions take X (and F/α) as ARGUMENTS rather than
    baking them into the jaxpr as constants, (a) repeat calls hit jax.jit's
    in-memory cache — no per-call re-trace — and (b) an AOT executable
    memoized on shapes/dtypes/statics alone is safe: the compiled program
    contains no dataset values, so it can never serve the wrong dataset's
    results (the hazard that kept the closure-based predecessor uncached).
    """

    def __init__(self, fn, *args, **statics):
        self.fn = fn
        self.args = args
        self.statics = statics

    def __call__(self, keys):
        return self.fn(keys, *self.args, **self.statics)

    def lower(self, keys):
        return self.fn.lower(keys, *self.args, **self.statics)

    def aot_call(self, compiled, keys):
        # AOT executables take only the dynamic args; statics are baked.
        return compiled(keys, *self.args)

    def aot_signature(self, keys):
        leaves = jax.tree_util.tree_leaves(self.args)
        return (
            self.fn,
            keys.shape, str(keys.dtype),
            tuple((x.shape, str(x.dtype)) for x in leaves),
            tuple(sorted(self.statics.items())),
            str(jax.devices()[0]),
        )


def _shmap_family_restarts(runner, keys, devices):
    """Explicit per-device restart fan-out for a family runner: shard_map
    over a flat "restart" mesh, data replicated, zero collectives — the
    family analogue of sharding.shmap_fit_restarts (the reference's only
    parallelism is exactly this fan-out, run_mmctm.jl:99-111). Lanes pad
    to a multiple of the device count by cycling keys (duplicates compute
    identical trajectories and are dropped on return).

    The jit closure here re-traces per call, but the multi-chip fan-out is
    a per-session entry point, not a loop body — and the inner runner call
    inlines the already-cached module-level jaxpr."""
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    devs = list(devices)
    n = len(devs)
    mesh = Mesh(np.asarray(devs), axis_names=("restart",))
    R = int(keys.shape[0])
    R_pad = ((R + n - 1) // n) * n
    keys = jnp.take(keys, jnp.arange(R_pad) % R, axis=0)

    @jax.jit
    def run(keys, *args):
        def local(keys_l, *args_l):
            return runner.fn(keys_l, *args_l, **runner.statics)

        # check_vma off for the same reason as shmap_fit_restarts:
        # replicated data feeds restart-varying loop carries; lanes are
        # independent and every output is restart-varying.
        return shard_map(
            local,
            mesh=mesh,
            in_specs=(P("restart"),) + tuple(P() for _ in args),
            out_specs=P("restart"),
            check_vma=False,
        )(keys, *args)

    result = run(keys, *runner.args)
    if R_pad != R:
        result = jax.tree_util.tree_map(lambda x: x[:R], result)
    return result


_SCHEDULE_MEMO: dict = {}
_SCHEDULE_MEMO_MAX = 64


def _derive_auto_schedule(iters, t_warm, production_restarts, maxiter,
                          max_boundaries):
    """Schedule derivation shared by the folded-pilot auto fits (MMCTM's
    fit_restarts_auto and the family fitters' compact_schedule="auto"):
    lane-iters/s from the timed pilot execution, one cached boundary-cost
    calibration, then the margin-aware exact DP. Returns (schedule, info).

    The derived schedule is memoized per derivation signature — the pilot
    iteration distribution plus the DP's static inputs (everything except
    the measured `t_warm`). The pilot's iteration counts are deterministic
    given (keys, data, config), but `t_warm` is a wall measurement: its
    run-to-run noise can flip the DP to a *different* schedule on a repeat
    of the identical fit, and every new schedule means new phase bucket
    shapes, i.e. fresh XLA compiles inside a production run that look like
    fit time. First derivation in
    the process wins; the safe degenerate case (a cold first call
    under-measuring the rate) declines boundaries, which is just the plain
    unchunked fit. FIFO-capped like _PILOT_EXEC_CACHE."""
    P = int(iters.size)
    sig = (
        iters.tobytes(), str(iters.dtype), int(production_restarts),
        int(maxiter), int(max_boundaries),
    )
    memo = _SCHEDULE_MEMO.get(sig)
    rate = P * float(iters.max()) / max(t_warm, 1e-9)
    t_boundary = measure_boundary_seconds_cached()
    B = t_boundary * rate
    if memo is not None:
        schedule = memo
    else:
        schedule = tuple(suggest_compact_schedule(
            iters, maxiter=maxiter, boundary_cost_lane_iters=B,
            max_boundaries=max_boundaries,
            production_restarts=production_restarts,
        ))
        _SCHEDULE_MEMO[sig] = schedule
        while len(_SCHEDULE_MEMO) > _SCHEDULE_MEMO_MAX:
            _SCHEDULE_MEMO.pop(next(iter(_SCHEDULE_MEMO)))
    info = {
        "pilot_restarts": P,
        "pilot_iters_max": int(iters.max()),
        "pilot_iters_median": float(np.median(iters)),
        "pilot_warm_s": t_warm,
        "lane_iters_per_s": rate,
        "boundary_s": t_boundary,
        "boundary_cost_lane_iters": B,
        "schedule": tuple(schedule),
        "schedule_memo_hit": memo is not None,
    }
    return tuple(schedule), info


def _family_restarts_auto(keys, run_unchunked, run_scheduled, restarts,
                          maxiter, pilot_restarts=64, max_boundaries=3):
    """Folded-pilot zero-config compaction for the best-of-N family fitters
    (LDA/ILDA/IMMCTM) — the family analogue of fit_restarts_auto: the first
    P = min(pilot_restarts, restarts//2) production lanes run unchunked as
    ONE timed AOT execution and double as the schedule pilot; the DP then
    schedules the remaining lanes' compaction from their measured iteration
    distribution plus one cached boundary calibration. Nothing is fit
    twice, and the lanes keep their original key order.

    `run_unchunked` is the family's keys -> batched-FitResult runner — a
    _FamilyRunner over the module-level jitted per-family function, whose
    AOT pilot executable is memoized in _PILOT_EXEC_CACHE (safe because X
    is an argument, not a baked constant; see _FamilyRunner) — and
    `run_scheduled(keys, schedule)` its compacted driver.

    Returns (batched FitResult over all lanes in key order, info dict with
    the derivation measurements)."""
    import time

    restarts = int(restarts)
    P = max(2, min(int(pilot_restarts), restarts // 2))
    if restarts < 8:
        result = run_unchunked(keys)
        iters = np.asarray(jax.device_get(result.n_iters))
        return result, {
            "pilot_restarts": restarts,
            "pilot_iters_max": int(iters.max()),
            "pilot_iters_median": float(np.median(iters)),
            "pilot_warm_s": 0.0,
            "lane_iters_per_s": 0.0,
            "boundary_s": 0.0,
            "boundary_cost_lane_iters": 0.0,
            "schedule": (),
            "note": "too few restarts to split; single unchunked fit",
        }
    if isinstance(run_unchunked, _FamilyRunner):
        sig = run_unchunked.aot_signature(keys[:P])
        if sig not in _PILOT_EXEC_CACHE:
            _pilot_cache_put(sig, run_unchunked.lower(keys[:P]).compile())
        compiled = run_unchunked.aot_call
        executable = _PILOT_EXEC_CACHE[sig]
    else:  # plain jitted closure (no safe memo key: constants baked in)
        executable = run_unchunked.lower(keys[:P]).compile()
        compiled = lambda exe, ks: exe(ks)  # noqa: E731
    # the pilot's iteration counts are fetched anyway: that fetch ends the
    # timed window
    t0 = time.perf_counter()
    pilot = compiled(executable, keys[:P])
    iters = np.asarray(jax.device_get(pilot.n_iters))
    t_warm = time.perf_counter() - t0
    schedule, info = _derive_auto_schedule(
        iters, t_warm, restarts - P, maxiter, max_boundaries
    )
    if schedule:
        rest = run_scheduled(keys[P:], schedule)
    else:
        rest = run_unchunked(keys[P:])
    return _concat_results(pilot, rest), info


def fit_restarts_auto(
    key: jax.Array,
    X,
    config: MMCTMConfig,
    alpha: jnp.ndarray,
    restarts: int,
    maxiter: int = 1000,
    tol: float = 1e-4,
    init_method: str = "random",
    pilot_restarts: int = 64,
    max_boundaries: int = 3,
    progress=None,
):
    """Zero-config compacted restart fit where the pilot IS production work
    (the separate-pilot auto_compact_schedule pays a whole 64-lane fit +
    calibration on top of the production fit).

    The first P = min(pilot_restarts, restarts//2) lanes of the SAME key
    stream run unchunked; that execution, timed, doubles as the schedule
    pilot (iteration distribution + lane-iters/s). The DP then derives the
    remaining R-P lanes' compaction schedule from those measurements plus
    one boundary-cost calibration, and the rest of the fit runs with it.
    Nothing is fit twice: every lane's result is production output, so the
    only overhead vs a pinned schedule is the pilot lanes forgoing
    compaction (at P<=64 lanes the DP usually declines to compact anyway)
    and ~50 ms of boundary calibration.

    The per-lane trajectories are the same math as fit_restarts(key, ...):
    the identical split keys, partitioned into two executions. On CPU the
    results match the unchunked fit to the last ulp (vectorized reductions
    can differ in the final bit between batch shapes); on an accelerator
    the two halves are different executables with the usual f32 rounding
    drift — selection reads f64 re-scores either way.

    Returns (batched MMCTMFitResult over all `restarts` lanes in key order,
    info dict with the derivation measurements).
    """
    import time

    X = tuple(X)
    restarts = int(restarts)
    keys = jax.random.split(key, restarts)
    P = max(2, min(int(pilot_restarts), restarts // 2))
    if restarts < 8:
        result = fit_restarts_from_keys(
            keys, X, config, alpha, maxiter=maxiter, tol=tol,
            init_method=init_method,
        )
        if progress is not None:
            progress(restarts, restarts)
        return result, {
            "pilot_restarts": restarts,
            "pilot_iters_max": int(np.asarray(result.n_iters).max()),
            "pilot_iters_median": float(np.median(np.asarray(result.n_iters))),
            "pilot_warm_s": 0.0,
            "lane_iters_per_s": 0.0,
            "boundary_s": 0.0,
            "boundary_cost_lane_iters": 0.0,
            "schedule": (),
            "note": "too few restarts to split; single unchunked fit",
        }

    compiled = _pilot_executable(
        keys[:P], X, config, alpha, maxiter, tol, init_method
    )
    # device_get an output, not block_until_ready: see auto_compact_schedule
    t0 = time.perf_counter()
    pilot = compiled(keys[:P], X, alpha)
    iters = np.asarray(jax.device_get(pilot.n_iters))
    t_warm = time.perf_counter() - t0
    if progress is not None:
        progress(P, restarts)
    schedule, info = _derive_auto_schedule(
        iters, t_warm, restarts - P, maxiter, max_boundaries
    )
    sub_progress = (
        None if progress is None
        else lambda d, t: progress(P + d, restarts)
    )
    if schedule:
        rest = _fit_scheduled_from_keys(
            keys[P:], X, config, alpha, maxiter=maxiter, tol=tol,
            init_method=init_method, schedule=tuple(schedule),
            progress=sub_progress,
        )
    else:
        rest = fit_restarts_from_keys(
            keys[P:], X, config, alpha, maxiter=maxiter, tol=tol,
            init_method=init_method,
        )
        if progress is not None:
            progress(restarts, restarts)
    return _concat_results(pilot, rest), info


def _repeat_forever(x):
    while True:
        yield x


@jax.jit
def _gather_tree(tree, idx):
    """Whole-pytree lane gather as ONE device execution. An eager tree_map
    gather dispatches once per leaf (~15 leaves for the MMCTM carry)."""
    return jax.tree_util.tree_map(lambda x: x[idx], tree)


@jax.jit
def _reassemble_tree(groups, keeps, inv):
    """Concatenate the per-round finished-lane groups (dropping pad
    duplicates via `keeps`) and restore original restart order, as one
    device execution per fit instead of one dispatch per leaf."""

    def leaf(*xs):
        return jnp.concatenate(
            [x[k] for x, k in zip(xs, keeps)], axis=0
        )[inv]

    return jax.tree_util.tree_map(leaf, *groups)


def _chunked_drive(carries, advance, maxiter, restarts, progress=None,
                   schedule=None, boundary=None):
    """Host loop with LANE COMPACTION over a batched CAVI carry.

    A vmapped while_loop computes every lane until the slowest lane
    finishes, so straggler restarts would make all R lanes pay for up to
    maxiter iterations. Between chunks we pull finished lanes out and
    re-pack the still-running ones into the next power-of-two batch
    (padding by duplicating lane 0 — duplicates compute identical
    trajectories, so their results overwrite harmlessly). Total work drops
    from R x slowest to roughly the sum of per-lane iterations.

    `advance(carries, budget)` advances every lane by up to `budget`
    iterations (None = until per-lane termination). `schedule` yields the
    budget for each successive round; when exhausted, rounds run unbounded.
    A chunked fit passes an endless repeat(chunk_iters); the 2-phase
    straggler fit passes e.g. (160,) — run everyone to ~p75 of the
    iteration distribution, compact once, let survivors run to completion
    (each round boundary costs a host round-trip, so fewer, well-placed
    boundaries beat many small ones).

    Everything stays ON DEVICE: the only host transfers are the tiny
    (iteration, converged) vectors that drive compaction; each boundary is
    ONE fused dispatch (done-lane gather + survivor re-pack + next advance),
    and finished-lane groups are re-assembled with one final concatenate +
    permutation gather.

    `progress(done, total)` is called after every chunk with the number of
    unique finished restarts — the analogue of the reference's per-restart
    progress bar over its pmap (run_mmctm.jl:101-104), which a single
    compiled dispatch cannot stream but the chunk boundary gives for free.
    """
    # `boundary(c, done_idx, pad_idx, b)` is the fused one-dispatch boundary
    # (done-lane gather + survivor re-pack + next advance). Callers must back
    # it with a MODULE-LEVEL jit (_boundary_carries) — a jit closure defined
    # here would re-trace and re-load its executables on every fit (see
    # _boundary_carries' docstring). Without one, the fallback is the paired
    # gather (_split_tree, one dispatch) + the caller's advance.
    budgets = iter(schedule) if schedule is not None else iter(())
    order = np.arange(restarts)
    done_groups = []   # device pytrees, each a batch of finished lanes
    done_orders = []   # their original restart indices
    carries = advance(carries, next(budgets, None))
    while True:
        # one batched host transfer for both control vectors (each separate
        # np.asarray is its own round-trip)
        it, done = jax.device_get((carries[2], carries[3]))
        done = done | (it >= maxiter)
        done_pos = np.nonzero(done)[0]
        active_pos = np.nonzero(~done)[0]
        if progress is not None:
            progress(restarts - np.unique(order[active_pos]).size, restarts)
        if len(active_pos) == 0:
            if len(done_pos) > 0:
                done_groups.append(_gather_tree(carries, jnp.asarray(done_pos)))
                done_orders.append(order[done_pos])
            break
        budget = next(budgets, None)
        if len(done_pos) == 0:
            # nothing to compact — a plain advance, no repack dispatch
            carries = advance(carries, budget)
            continue
        A = len(active_pos)
        bucket = 1 << (A - 1).bit_length()
        pad = np.concatenate([active_pos, np.repeat(active_pos[:1], bucket - A)])
        if boundary is not None:
            done_grp, carries = boundary(
                carries, jnp.asarray(done_pos), jnp.asarray(pad), budget
            )
        else:
            done_grp, packed = _split_tree(
                carries, jnp.asarray(done_pos), jnp.asarray(pad)
            )
            carries = advance(packed, budget)
        done_groups.append(done_grp)
        done_orders.append(order[done_pos])
        order = order[pad]

    # Dedupe pad-duplicate lanes (keep the first finish of each restart),
    # then one device concatenate + inverse-permutation gather.
    seen = set()
    keeps = []
    flat_order = []
    for grp_order in done_orders:
        mask = []
        for o in grp_order:
            fresh = o not in seen
            mask.append(fresh)
            if fresh:
                seen.add(o)
                flat_order.append(o)
        keeps.append(jnp.asarray(np.nonzero(np.asarray(mask, bool))[0]))
    inv = np.empty(restarts, np.int64)
    inv[np.asarray(flat_order)] = np.arange(restarts)
    return _reassemble_tree(tuple(done_groups), tuple(keeps), jnp.asarray(inv))


@partial(jax.jit, static_argnames=("config", "maxiter", "tol", "init_method"))
def _stage2_from_graft(
    keys2, X, config, alpha, grafted_gamma, grafted_Elnphi, maxiter, tol,
    init_method="random",
):
    """Stage-2 restarts with the per-modality-best topic posteriors grafted
    over fresh random inits (run_mmctm.jl:113-134)."""

    def one(k):
        state = init_with_alpha(k, config, X, alpha, init_method)
        state = state._replace(gamma=grafted_gamma, Elnphi=grafted_Elnphi)
        return mmctm_mod.fit(state, X, config, maxiter=maxiter, tol=tol)

    return jax.vmap(one)(keys2)


def select_modality_winners_f64(stage1, X, config):
    """Per-modality stage-1 winners by EXACT float64 re-scoring of the
    final states (parallel/rescore.py: the in-fit f32 lls drift across
    executables by more than the winner margins, so selection must never
    read them). The f64 scores run on the host (numpy) or the accelerator
    (rescore_device.py, native f64) per
    rescore.py's dispatch — the executors agree to ~1e-13, five orders
    below the margins, so the pick is executor-independent. Only lanes
    within the shortlist window of the f32 leaders are re-scored; the
    window provably contains the true winners (rescore.shortlist_lanes).
    Returns (best_m (M,) np.int64, info dict)."""
    from .rescore import (
        pick_optimal_modality_restarts_np,
        rescore_mmctm,
        shortlist_lanes,
    )

    ll_f32 = np.asarray(jax.device_get(stage1.ll), np.float64)
    cand = shortlist_lanes(ll_f32)
    lam, gamma = _gather_tree(
        (stage1.state.lam, stage1.state.gamma), jnp.asarray(cand)
    )
    ll64 = rescore_mmctm(lam, gamma, X, config)
    best_m = cand[pick_optimal_modality_restarts_np(ll64)]
    info = {
        "rescored_lanes": cand,
        "ll_f64": ll64,
        "winners": best_m,
    }
    return best_m, info


def select_best_restart_f64(result, X, config):
    """Dense-rank pick (run_mmctm.jl:136-147) over EXACT float64 re-scores
    of every lane's final state (host or device executor — rescore.py).
    Returns (best index, (R, M) f64 ll matrix)."""
    from .rescore import pick_optimal_restart_np, rescore_mmctm

    ll64 = rescore_mmctm(result.state.lam, result.state.gamma, X, config)
    return pick_optimal_restart_np(ll64), ll64


def two_stage_fit(
    key: jax.Array,
    X,
    config: MMCTMConfig,
    alpha: jnp.ndarray,
    restarts: int,
    stage2_restarts: int = 1,
    maxiter: int = 1000,
    stage1_tol: float = 1e-4,
    stage2_tol: float = 1e-5,
    init_method: str = "random",
    chunk_iters: int = None,
    compact_schedule: Optional[Sequence[int]] = None,
    progress=None,
    rescore_f64: bool = True,
    pilot_restarts: int = 64,
    auto_info: Optional[dict] = None,
    selection_info: Optional[dict] = None,
):
    """The CLI's full two-stage protocol (run_mmctm.jl:163-180). Returns
    (best stage-2 result (unbatched), stage-1 batched result, stage-2
    batched result, best index).

    `selection_info`, when a dict is passed, receives the selection's own
    working data — {"stage1_winners": (M,) lane indices,
    "stage1_winner_ll": (M,) the winners' per-modality scores (f64
    re-scores when rescore_f64, else the in-fit f32 metric)} — so verbose
    callers can report the numbers selection actually read without
    re-running the multi-second f64 re-scoring pass.

    `compact_schedule="auto"` runs stage 1 through the folded pilot
    (fit_restarts_auto: the first `pilot_restarts` production lanes double
    as the schedule pilot — no work is fit twice); the derivation
    measurements are written into `auto_info` when a dict is passed.

    With `chunk_iters` set, both stages run as host-chunked resumable fits
    (bounded device executions — see fit_restarts), and `progress(stage,
    done, total)` streams per-chunk completion counts (stage is 1 or 2).
    `compact_schedule` enables the 2-phase straggler fit for stage 1 (see
    fit_restarts; stage 2 is `stage2_restarts` lanes — 1 by default — and
    has no straggler problem to compact away). A stage that runs as a
    single dispatch (no chunking for that stage, including an auto-derived
    EMPTY schedule) still invokes `progress` once on completion, so a
    progress-consuming caller never sees total silence.

    `rescore_f64` (default True) makes BOTH selections — the per-modality
    stage-1 winners and the stage-2 dense-rank pick — read exact float64
    re-scores of the final states instead of the in-fit f32 lls, so the
    picks are a deterministic function of the states alone and cannot
    flip with the executable mix (see parallel/rescore.py; the scores run
    host- or device-side per its dispatch, agreeing to ~1e-13). False
    selects on the in-fit f32 lls.
    """
    X = tuple(X)
    k1, k2 = jax.random.split(key)

    if isinstance(compact_schedule, str):
        if compact_schedule != "auto":
            raise ValueError(
                f"compact_schedule: expected 'auto' or a tuple, got "
                f"{compact_schedule!r}"
            )
        if chunk_iters is not None:
            raise ValueError("chunk_iters and compact_schedule='auto' are "
                             "mutually exclusive")
        stage1, info = fit_restarts_auto(
            key=k1, X=X, config=config, alpha=alpha, restarts=restarts,
            maxiter=maxiter, tol=stage1_tol, init_method=init_method,
            pilot_restarts=pilot_restarts,
            progress=None if progress is None else partial(progress, 1),
        )
        if auto_info is not None:
            auto_info.update(info)
        # fit_restarts_auto streamed its own progress (pilot + production)
        stage1_reported = True
    else:
        stage1 = fit_restarts(
            key=k1, X=X, config=config, alpha=alpha, restarts=restarts,
            maxiter=maxiter, tol=stage1_tol, init_method=init_method,
            chunk_iters=chunk_iters, compact_schedule=compact_schedule,
            progress=None if progress is None else partial(progress, 1),
        )
        stage1_reported = chunk_iters is not None or bool(compact_schedule)
    if progress is not None and not stage1_reported:
        # single-dispatch stage: no chunk boundaries streamed anything, so
        # report completion once — otherwise --progress with an auto-derived
        # EMPTY schedule (the DP decided no boundary pays) looks like a hang
        progress(1, restarts, restarts)
    if rescore_f64:
        best_m, sel = select_modality_winners_f64(stage1, X, config)  # (M,)
        if selection_info is not None:
            cand = list(sel["rescored_lanes"])
            selection_info["stage1_winners"] = np.asarray(best_m)
            selection_info["stage1_winner_ll"] = np.asarray(
                [sel["ll_f64"][cand.index(best_m[m]), m]
                 for m in range(config.M)]
            )
    else:
        best_m = pick_optimal_modality_restarts(stage1.ll)  # (M,)
        if selection_info is not None:
            ll32 = np.asarray(jax.device_get(stage1.ll))
            selection_info["stage1_winners"] = np.asarray(best_m)
            selection_info["stage1_winner_ll"] = np.asarray(
                [ll32[int(best_m[m]), m] for m in range(config.M)]
            )

    # Graft the per-modality-best topic-word posteriors (run_mmctm.jl:126-130)
    grafted_gamma = tuple(
        stage1.state.gamma[m][best_m[m]] for m in range(config.M)
    )
    grafted_Elnphi = tuple(
        stage1.state.Elnphi[m][best_m[m]] for m in range(config.M)
    )

    keys2 = jax.random.split(k2, stage2_restarts)
    if chunk_iters is None:
        stage2 = _stage2_from_graft(
            keys2, X, config, alpha, grafted_gamma, grafted_Elnphi,
            maxiter=maxiter, tol=stage2_tol, init_method=init_method,
        )
        if progress is not None:
            progress(2, stage2_restarts, stage2_restarts)
    else:
        carries = _init_carries(keys2, X, config, alpha, maxiter, init_method)
        state = carries[0]._replace(
            gamma=jax.tree_util.tree_map(
                lambda g: jnp.broadcast_to(g, (stage2_restarts,) + g.shape),
                grafted_gamma,
            ),
            Elnphi=jax.tree_util.tree_map(
                lambda g: jnp.broadcast_to(g, (stage2_restarts,) + g.shape),
                grafted_Elnphi,
            ),
        )
        carries = (state,) + carries[1:]
        final = _chunked_drive(
            carries,
            lambda c, b: _advance_carries(c, X, config, maxiter, stage2_tol, b),
            maxiter,
            stage2_restarts,
            progress=None if progress is None else partial(progress, 2),
            schedule=_repeat_forever(chunk_iters),
            boundary=lambda c, d, p, b: _boundary_carries(
                c, d, p, X, config, maxiter, stage2_tol, b
            ),
        )
        stage2 = _finalize_carries(final, X, config)
    if rescore_f64:
        best, _ = select_best_restart_f64(stage2, X, config)
    else:
        best = pick_optimal_restart(stage2.ll)
    return lane(stage2, best), stage1, stage2, best


def fit_mmctm_restarts(
    k: Sequence[int],
    alpha: Sequence[float],
    X,
    V: Optional[Sequence[int]] = None,
    restarts: int = 100,
    stage2_restarts: int = 1,
    maxiter: int = 1000,
    stage1_tol: float = 1e-4,
    stage2_tol: float = 1e-5,
    seed: int = 147959412,
    dtype=None,
    verbose: bool = False,
    chunk_iters: Optional[int] = None,
    compact_schedule: Optional[Sequence[int]] = None,
    pilot_restarts: int = 64,
    progress=None,
    rescore_f64: bool = True,
) -> MMCTM:
    """High-level entry mirroring the CLI's `fit_model` (run_mmctm.jl:163-180):
    multi-restart two-stage MMCTM fitting, returning the selected model as a
    fitted MMCTM wrapper (with `ll_history` attached). `progress(stage, done,
    total)` streams per-chunk completion when `chunk_iters` is set.

    `compact_schedule="auto"` derives the stage-1 straggler-compaction
    schedule at zero duplicated work: the first `pilot_restarts` production
    lanes run unchunked and double as the schedule pilot, then the DP
    schedules the remaining lanes from their measured iteration
    distribution and a runtime boundary-cost calibration
    (fit_restarts_auto — matches the reference CLI's zero-config ergonomics
    at R=1000); the derivation is recorded on the returned model as
    `model.compact_info`.

    Unchunked by default: every chunk boundary costs a host round-trip.
    Set `chunk_iters` to observe progress between chunks."""
    args = (list(k), list(alpha)) + (() if V is None else (list(V),)) + (X,)
    model = MMCTM(*args, dtype=dtype)
    alpha_arr = jnp.asarray([float(a) for a in alpha], model.config.dtype)
    auto_info: dict = {}
    selection_info: dict = {}
    best, stage1, stage2, best_idx = two_stage_fit(
        jax.random.key(seed),
        model.Xdense,
        model.config,
        alpha_arr,
        restarts=restarts,
        stage2_restarts=stage2_restarts,
        maxiter=maxiter,
        stage1_tol=stage1_tol,
        stage2_tol=stage2_tol,
        chunk_iters=chunk_iters,
        compact_schedule=compact_schedule,
        progress=progress,
        rescore_f64=rescore_f64,
        pilot_restarts=pilot_restarts,
        auto_info=auto_info,
        selection_info=selection_info if verbose else None,
    )
    if auto_info:
        model.compact_info = auto_info
        if verbose:
            print(
                f"auto-compact: schedule={auto_info['schedule']} "
                f"(pilot = first {auto_info['pilot_restarts']} production "
                f"lanes, median {auto_info['pilot_iters_median']:.0f} "
                f"iters; boundary {auto_info['boundary_s'] * 1e3:.0f} ms = "
                f"{auto_info['boundary_cost_lane_iters']:.0f} lane-iters at "
                f"{auto_info['lane_iters_per_s']:.0f} lane-iters/s)"
            )
    if verbose:
        # the numbers selection actually read (f64 re-scores by default) —
        # recomputing them here would repeat a multi-second host pass, and
        # the in-fit f32 metric is exactly the executable-drifting value
        # the selection was changed to never read
        print("Modality optimal model log-likelihoods:")
        for m in range(model.config.M):
            print(f"{m + 1}: {selection_info['stage1_winner_ll'][m]}")
        print("Seeded model log-likelihoods:")
        print(np.asarray(best.ll))
    model.state = best.state
    model.converged = bool(best.converged)
    model.elbo = float(best.elbo)
    model.ll = list(np.asarray(best.ll, dtype=np.float64))
    n = int(best.n_iters)
    model.ll_history = [
        list(row) for row in np.asarray(best.ll_history[:n], dtype=np.float64)
    ]
    model.stage1_ll = np.asarray(stage1.ll, dtype=np.float64)
    return model


# ---------------------------------------------------------------------------
# Restart fitting for the other model families (capability extensions: the
# reference only orchestrates MMCTM restarts; LDA/ILDA/IMMCTM users get the
# same pick-best-of-N escape from local optima)
# ---------------------------------------------------------------------------


def _resolve_schedule(chunk_iters, compact_schedule):
    """Map the two mutually-exclusive compaction modes onto a budget
    iterator for _chunked_drive (None = run unbounded from then on)."""
    if chunk_iters is not None and compact_schedule is not None:
        raise ValueError("chunk_iters and compact_schedule are mutually exclusive")
    if chunk_iters is not None:
        return _repeat_forever(chunk_iters)
    return tuple(compact_schedule)


def _best_scalar_ll_lane(result, rescore_fn, rescore_f64: bool) -> int:
    """argmax-final-ll selection for the scalar-metric families (LDA/ILDA),
    reading exact f64 re-scores of the shortlisted final states by default
    (host or device executor — see parallel/rescore.py;
    `rescore_fn(candidate_idx)` returns their f64 lls). Non-finite lanes
    are masked either way."""
    ll_f32 = np.asarray(jax.device_get(result.ll), np.float64)
    if not rescore_f64:
        return int(np.argmax(np.where(np.isfinite(ll_f32), ll_f32, -np.inf)))
    from .rescore import shortlist_lanes

    cand = shortlist_lanes(ll_f32)
    ll64 = rescore_fn(cand)
    return int(cand[int(np.argmax(np.where(np.isfinite(ll64), ll64, -np.inf)))])


def fit_lda_restarts(
    k, alpha, eta, X, V=None, restarts: int = 100, maxiter: int = 1000,
    tol: float = 1e-4, seed: int = 147959412, dtype=None,
    chunk_iters: Optional[int] = None,
    compact_schedule=None,
    rescore_f64: bool = True,
    pilot_restarts: int = 64,
    devices: Optional[Sequence] = None,
):
    """Best-of-N LDA fitting: vmapped restarts, argmax final log-likelihood
    (exact f64 re-scores of the shortlisted final states by default,
    host- or device-executed —
    parallel/rescore.py). `chunk_iters` enables the host-chunked compacted
    driver; `compact_schedule` the 2-phase straggler fit (see fit_restarts),
    or "auto" for the zero-config folded-pilot derivation (the first
    `pilot_restarts` lanes double as the schedule pilot —
    _family_restarts_auto); the derivation lands on `model.compact_info`.
    `devices` runs the lanes as a shard_map per-device fan-out over the
    given devices (_shmap_family_restarts, the multi-chip path)."""
    from ..models.lda import LDA

    args = (k, alpha, eta) + (() if V is None else (V,)) + (X,)
    model = LDA(*args, dtype=dtype)
    cfg, Xd = model.config, model.Xdense
    keys = jax.random.split(jax.random.key(seed), restarts)

    run = _FamilyRunner(
        _lda_restarts_from_keys, Xd, config=cfg, maxiter=maxiter, tol=tol
    )

    def scheduled(ks, sched):
        final = _chunked_drive(
            _lda_init_carries(ks, config=cfg, maxiter=maxiter),
            lambda c, b: _lda_advance(
                c, Xd, config=cfg, maxiter=maxiter, tol=tol, chunk=b
            ),
            maxiter, int(ks.shape[0]), schedule=sched,
            boundary=lambda c, d, p, b: _lda_boundary(
                c, d, p, Xd, config=cfg, maxiter=maxiter, tol=tol, b=b
            ),
        )
        return _lda_finalize(final, Xd, config=cfg)

    if devices is not None:
        if chunk_iters is not None or compact_schedule:
            raise ValueError(
                "devices (the shard_map restart fan-out) is incompatible "
                "with chunk_iters/compact_schedule (host-driven compaction)"
            )
        result = _shmap_family_restarts(run, keys, devices)
    elif compact_schedule == "auto":
        if chunk_iters is not None:
            raise ValueError("chunk_iters and compact_schedule are mutually exclusive")
        result, model.compact_info = _family_restarts_auto(
            keys, run, scheduled, restarts, maxiter,
            pilot_restarts=pilot_restarts,
        )
    elif chunk_iters is None and not compact_schedule:
        result = run(keys)
    else:
        result = scheduled(keys, _resolve_schedule(chunk_iters, compact_schedule))

    def _rescore(cand):
        from .rescore import rescore_lda

        gam, lam_ = _gather_tree(
            (result.state.gamma, result.state.lam), jnp.asarray(cand)
        )
        return rescore_lda(gam, lam_, Xd)

    best = _best_scalar_ll_lane(result, _rescore, rescore_f64)
    sel = lane(result, best)
    model.state = sel.state
    model.converged = bool(sel.converged)
    model.elbo = float(sel.elbo)
    model.ll = float(sel.ll)
    return model


def fit_ilda_restarts(
    k, alpha, eta, features, X, restarts: int = 100, maxiter: int = 1000,
    tol: float = 1e-4, seed: int = 147959412, dtype=None,
    chunk_iters: Optional[int] = None,
    compact_schedule=None,
    rescore_f64: bool = True,
    pilot_restarts: int = 64,
    devices: Optional[Sequence] = None,
):
    """Best-of-N ILDA fitting: vmapped restarts, argmax final log-likelihood
    (exact f64 re-scores of the shortlisted final states by default,
    host- or device-executed —
    parallel/rescore.py). `chunk_iters` enables the host-chunked compacted
    driver; `compact_schedule` the 2-phase straggler fit (see fit_restarts),
    or "auto" for the zero-config folded-pilot derivation
    (_family_restarts_auto; derivation lands on `model.compact_info`).
    `devices` runs the lanes as a shard_map per-device fan-out over the
    given devices (_shmap_family_restarts, the multi-chip path)."""
    from ..models.ilda import ILDA

    model = ILDA(k, alpha, eta, features, X, dtype=dtype)
    cfg, Xd, F = model.config, model.Xdense, model.F
    keys = jax.random.split(jax.random.key(seed), restarts)

    run = _FamilyRunner(
        _ilda_restarts_from_keys, Xd, F, config=cfg, maxiter=maxiter, tol=tol
    )

    def scheduled(ks, sched):
        final = _chunked_drive(
            _ilda_init_carries(ks, config=cfg, maxiter=maxiter),
            lambda c, b: _ilda_advance(
                c, Xd, F, config=cfg, maxiter=maxiter, tol=tol, chunk=b
            ),
            maxiter, int(ks.shape[0]), schedule=sched,
            boundary=lambda c, d, p, b: _ilda_boundary(
                c, d, p, Xd, F, config=cfg, maxiter=maxiter, tol=tol, b=b
            ),
        )
        return _ilda_finalize(final, Xd, F, config=cfg)

    if devices is not None:
        if chunk_iters is not None or compact_schedule:
            raise ValueError(
                "devices (the shard_map restart fan-out) is incompatible "
                "with chunk_iters/compact_schedule (host-driven compaction)"
            )
        result = _shmap_family_restarts(run, keys, devices)
    elif compact_schedule == "auto":
        if chunk_iters is not None:
            raise ValueError("chunk_iters and compact_schedule are mutually exclusive")
        result, model.compact_info = _family_restarts_auto(
            keys, run, scheduled, restarts, maxiter,
            pilot_restarts=pilot_restarts,
        )
    elif chunk_iters is None and not compact_schedule:
        result = run(keys)
    else:
        result = scheduled(keys, _resolve_schedule(chunk_iters, compact_schedule))

    def _rescore(cand):
        from .rescore import rescore_ilda

        gam, lam_ = _gather_tree(
            (result.state.gamma, result.state.lam), jnp.asarray(cand)
        )
        return rescore_ilda(gam, lam_, Xd, F)

    best = _best_scalar_ll_lane(result, _rescore, rescore_f64)
    sel = lane(result, best)
    model.state = sel.state
    model.converged = bool(sel.converged)
    model.elbo = float(sel.elbo)
    model.ll = float(sel.ll)
    return model


def fit_immctm_restarts(
    k, alpha, features, X, restarts: int = 100, maxiter: int = 1000,
    tol: float = 1e-4, seed: int = 147959412, dtype=None,
    chunk_iters: Optional[int] = None,
    compact_schedule=None,
    rescore_f64: bool = True,
    pilot_restarts: int = 64,
    devices: Optional[Sequence] = None,
):
    """Best-of-N IMMCTM fitting: vmapped restarts; selection by min mean
    dense-rank of |ll| across modalities (the MMCTM CLI's criterion,
    run_mmctm.jl:136-147), over exact f64 re-scores of every lane's
    final state by default (the dense-rank criterion needs the full
    population ranked, so there is no shortlist here — parallel/rescore.py).
    `chunk_iters` enables the same host-chunked compacted driver as the
    MMCTM path; `compact_schedule` the 2-phase straggler fit (see
    fit_restarts), or "auto" for the zero-config folded-pilot derivation
    (_family_restarts_auto; derivation lands on `model.compact_info`).
    `devices` runs the lanes as a shard_map per-device fan-out over the
    given devices (_shmap_family_restarts, the multi-chip path)."""
    from ..models.immctm import IMMCTM

    model = IMMCTM(k, alpha, features, X, dtype=dtype)
    cfg, Xd, F = model.config, model.Xdense, model.F
    alpha_full = model.state.alpha
    keys = jax.random.split(jax.random.key(seed), restarts)

    run = _FamilyRunner(
        _immctm_restarts_from_keys, Xd, F, alpha_full,
        config=cfg, maxiter=maxiter, tol=tol,
    )

    def scheduled(ks, sched):
        final = _chunked_drive(
            _immctm_init_carries(ks, alpha_full, config=cfg, maxiter=maxiter),
            lambda c, b: _immctm_advance(
                c, Xd, F, config=cfg, maxiter=maxiter, tol=tol, chunk=b
            ),
            maxiter, int(ks.shape[0]), schedule=sched,
            boundary=lambda c, d, p, b: _immctm_boundary(
                c, d, p, Xd, F, config=cfg, maxiter=maxiter, tol=tol, b=b
            ),
        )
        return _immctm_finalize(final, Xd, F, config=cfg)

    if devices is not None:
        if chunk_iters is not None or compact_schedule:
            raise ValueError(
                "devices (the shard_map restart fan-out) is incompatible "
                "with chunk_iters/compact_schedule (host-driven compaction)"
            )
        result = _shmap_family_restarts(run, keys, devices)
    elif compact_schedule == "auto":
        if chunk_iters is not None:
            raise ValueError("chunk_iters and compact_schedule are mutually exclusive")
        result, model.compact_info = _family_restarts_auto(
            keys, run, scheduled, restarts, maxiter,
            pilot_restarts=pilot_restarts,
        )
    elif chunk_iters is None and not compact_schedule:
        result = run(keys)
    else:
        result = scheduled(keys, _resolve_schedule(chunk_iters, compact_schedule))

    if rescore_f64:
        from .rescore import pick_optimal_restart_np, rescore_immctm

        best = pick_optimal_restart_np(
            rescore_immctm(result.state.lam, result.state.gamma, Xd, F, cfg)
        )
    else:
        best = int(pick_optimal_restart(result.ll))
    sel = lane(result, best)
    model.state = sel.state
    model.converged = bool(sel.converged)
    model.elbo = float(sel.elbo)
    model.ll = list(np.asarray(sel.ll, dtype=np.float64))
    return model
