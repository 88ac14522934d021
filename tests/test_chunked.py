"""Chunked (resumable) restart fitting must match single-shot exactly."""

import jax
import jax.numpy as jnp
import numpy as np

from multimodalmusig_tpu.models.mmctm import MMCTM
from multimodalmusig_tpu.parallel import restarts as rmod


def test_chunked_matches_single_shot(mmctm_fixture):
    model = MMCTM(mmctm_fixture["K"], mmctm_fixture["alpha"], mmctm_fixture["X"])
    alpha = jnp.asarray([0.1, 0.1], model.config.dtype)
    kwargs = dict(restarts=3, maxiter=25, tol=1e-5)
    single = rmod.fit_restarts(
        jax.random.key(9), model.Xdense, model.config, alpha, **kwargs
    )
    chunked = rmod.fit_restarts(
        jax.random.key(9), model.Xdense, model.config, alpha, chunk_iters=7, **kwargs
    )
    np.testing.assert_array_equal(
        np.asarray(single.n_iters), np.asarray(chunked.n_iters)
    )
    np.testing.assert_allclose(np.asarray(single.ll), np.asarray(chunked.ll), rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(single.state.lam), np.asarray(chunked.state.lam), rtol=1e-10
    )
    np.testing.assert_array_equal(
        np.asarray(single.converged), np.asarray(chunked.converged)
    )


def test_two_phase_compaction_matches_single_shot(mmctm_fixture):
    """The 2-phase straggler fit (compact_schedule): run everyone a fixed
    budget, compact converged lanes out, finish survivors unbounded. Must
    be bit-identical to the single-dispatch fit — compaction only re-packs
    lanes, never changes any lane's trajectory."""
    model = MMCTM(mmctm_fixture["K"], mmctm_fixture["alpha"], mmctm_fixture["X"])
    alpha = jnp.asarray([0.1, 0.1], model.config.dtype)
    kwargs = dict(restarts=5, maxiter=25, tol=1e-5)
    single = rmod.fit_restarts(
        jax.random.key(9), model.Xdense, model.config, alpha, **kwargs
    )
    for schedule in [(8,), (8, 6), (100,)]:
        phased = rmod.fit_restarts(
            jax.random.key(9), model.Xdense, model.config, alpha,
            compact_schedule=schedule, **kwargs
        )
        np.testing.assert_array_equal(
            np.asarray(single.n_iters), np.asarray(phased.n_iters)
        )
        np.testing.assert_allclose(
            np.asarray(single.ll), np.asarray(phased.ll), rtol=1e-12
        )
        np.testing.assert_allclose(
            np.asarray(single.state.lam), np.asarray(phased.state.lam), rtol=1e-10
        )
        np.testing.assert_array_equal(
            np.asarray(single.converged), np.asarray(phased.converged)
        )


def test_compact_schedule_excludes_chunk_iters(mmctm_fixture):
    import pytest

    model = MMCTM(mmctm_fixture["K"], mmctm_fixture["alpha"], mmctm_fixture["X"])
    alpha = jnp.asarray([0.1, 0.1], model.config.dtype)
    with pytest.raises(ValueError):
        rmod.fit_restarts(
            jax.random.key(0), model.Xdense, model.config, alpha,
            restarts=2, maxiter=5, chunk_iters=3, compact_schedule=(3,),
        )


class TestSuggestCompactSchedule:
    def _brca_like(self, rng, R=1000):
        """Iteration distribution shaped like a BRCA R=1000 one: a long
        right tail, max about three times the median."""
        base = rng.gamma(shape=9.0, scale=16.0, size=R) + 60
        return np.clip(base, 60, 406).astype(int)

    def test_picks_boundaries_near_measured_optimum(self, rng):
        iters = self._brca_like(rng)
        sched = rmod.suggest_compact_schedule(iters)
        assert 1 <= len(sched) <= 3
        # the optimal first boundary sits where survivors drop just below a
        # power of two — for a long-tailed distribution that's in the broad
        # p40-p90 band (the measured on-chip optimum for the real BRCA
        # distribution was cumulative (190, 270) ≈ p77/p95)
        lo, hi = np.percentile(iters, [40, 90])
        assert lo <= sched[0] <= hi, (sched, lo, hi)
        # and adding the suggested boundaries must model-cost less than none
        assert sum(sched) < iters.max()

    def test_tight_distribution_yields_empty(self):
        # all lanes finish within a few iterations of each other: any
        # boundary costs more than the straggler waste it removes
        iters = np.full(64, 100)
        iters[:8] = 95
        assert rmod.suggest_compact_schedule(iters) == ()

    def test_suggested_schedule_runs(self, mmctm_fixture):
        model = MMCTM(mmctm_fixture["K"], mmctm_fixture["alpha"], mmctm_fixture["X"])
        alpha = jnp.asarray([0.1, 0.1], model.config.dtype)
        pilot = rmod.fit_restarts(
            jax.random.key(9), model.Xdense, model.config, alpha,
            restarts=5, maxiter=25, tol=1e-5,
        )
        sched = rmod.suggest_compact_schedule(
            np.asarray(pilot.n_iters), maxiter=25, boundary_cost_lane_iters=1.0
        )
        # tiny fixture: whatever it suggests must reproduce the same fits
        phased = rmod.fit_restarts(
            jax.random.key(9), model.Xdense, model.config, alpha,
            restarts=5, maxiter=25, tol=1e-5,
            compact_schedule=sched if sched else (10,),
        )
        np.testing.assert_allclose(
            np.asarray(pilot.ll), np.asarray(phased.ll), rtol=1e-12
        )

    def test_handles_empty_and_nan(self):
        assert rmod.suggest_compact_schedule(np.array([])) == ()
        assert rmod.suggest_compact_schedule(np.array([np.nan, np.nan])) == ()


def test_two_phase_single_lane_and_maxiter_capped(mmctm_fixture):
    """Edge cases through the compacted driver: a single restart lane, and
    lanes that exhaust maxiter without converging (must terminate, report
    converged=False, and match the single-dispatch fit)."""
    model = MMCTM(mmctm_fixture["K"], mmctm_fixture["alpha"], mmctm_fixture["X"])
    alpha = jnp.asarray([0.1, 0.1], model.config.dtype)

    # R=1 with a boundary
    single = rmod.fit_restarts(
        jax.random.key(2), model.Xdense, model.config, alpha,
        restarts=1, maxiter=20, tol=1e-5,
    )
    phased = rmod.fit_restarts(
        jax.random.key(2), model.Xdense, model.config, alpha,
        restarts=1, maxiter=20, tol=1e-5, compact_schedule=(7,),
    )
    np.testing.assert_allclose(np.asarray(single.ll), np.asarray(phased.ll), rtol=1e-12)

    # tol=0 -> nothing converges; every lane runs exactly to maxiter
    capped = rmod.fit_restarts(
        jax.random.key(2), model.Xdense, model.config, alpha,
        restarts=3, maxiter=12, tol=0.0, compact_schedule=(5,),
    )
    np.testing.assert_array_equal(np.asarray(capped.n_iters), [12, 12, 12])
    assert not np.asarray(capped.converged).any()
    ref = rmod.fit_restarts(
        jax.random.key(2), model.Xdense, model.config, alpha,
        restarts=3, maxiter=12, tol=0.0,
    )
    np.testing.assert_allclose(np.asarray(capped.ll), np.asarray(ref.ll), rtol=1e-12)


def test_empty_schedule_takes_single_dispatch_path(mmctm_fixture, monkeypatch):
    """compact_schedule=() — suggest_compact_schedule's 'no boundary pays'
    answer — must route to the single-dispatch fit, not the chunked driver
    (which would add round-trips and, on a GPU, a differently-rounded
    executable for zero compaction)."""
    model = MMCTM(mmctm_fixture["K"], mmctm_fixture["alpha"], mmctm_fixture["X"])
    alpha = jnp.asarray([0.1, 0.1], model.config.dtype)

    def boom(*a, **k):
        raise AssertionError("chunked driver must not run for an empty schedule")

    monkeypatch.setattr(rmod, "_chunked_drive", boom)
    result = rmod.fit_restarts(
        jax.random.key(1), model.Xdense, model.config, alpha,
        restarts=2, maxiter=5, compact_schedule=(),
    )
    assert np.isfinite(np.asarray(result.ll)).all()


def test_selection_invariant_under_compaction(mmctm_fixture):
    """Restart SELECTION (per-modality stage-1 winners + the dense-rank
    pick) must not depend on the compaction schedule. On CPU trajectories
    are bit-identical so this is exact; the accelerator analogue — where
    compacted phases are different executables whose f32 rounding drifts —
    is
    measured and recorded by tools/selection_stability.py (near-tie margin
    vs cross-run drift)."""
    model = MMCTM(mmctm_fixture["K"], mmctm_fixture["alpha"], mmctm_fixture["X"])
    alpha = jnp.asarray([0.1, 0.1], model.config.dtype)
    kwargs = dict(restarts=12, maxiter=40, tol=1e-4)
    plain = rmod.fit_restarts(
        jax.random.key(4), model.Xdense, model.config, alpha, **kwargs
    )
    compacted = rmod.fit_restarts(
        jax.random.key(4), model.Xdense, model.config, alpha,
        compact_schedule=(10, 8), **kwargs
    )
    np.testing.assert_array_equal(np.asarray(plain.ll), np.asarray(compacted.ll))
    np.testing.assert_array_equal(
        np.asarray(rmod.pick_optimal_modality_restarts(plain.ll)),
        np.asarray(rmod.pick_optimal_modality_restarts(compacted.ll)),
    )
    assert int(rmod.pick_optimal_restart(plain.ll)) == int(
        rmod.pick_optimal_restart(compacted.ll)
    )
