"""Float64 host re-scoring of restart selection (parallel/rescore.py).

The in-fit f32 lls drift across executables by more than the best-of-N
winner margins, so selection reads exact f64 host re-scores of the final states. These tests pin:
(a) the rescored values equal the in-fit metric exactly in f64 fits (same
formula, reference semantics src/MMCTM.jl:384-448) and to f32 scoring
rounding in f32 fits; (b) the numpy pick functions mirror the device ones,
including non-finite masking; (c) the shortlist always contains the true
winners; (d) the selection paths of every family route through the f64
scores.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multimodalmusig_tpu.models.mmctm import MMCTM
from multimodalmusig_tpu.parallel import rescore as rs
from multimodalmusig_tpu.parallel import restarts as rmod

FEATURES = np.array([[1, 1], [1, 2], [2, 1], [2, 2]])


def _fit_restarts(mmctm_fixture, dtype, restarts=4, maxiter=15):
    model = MMCTM(
        mmctm_fixture["K"], mmctm_fixture["alpha"], mmctm_fixture["X"], dtype=dtype
    )
    result = rmod.fit_restarts(
        jax.random.key(3),
        model.Xdense,
        model.config,
        jnp.asarray([0.1, 0.1], model.config.dtype),
        restarts=restarts,
        maxiter=maxiter,
        tol=1e-6,
    )
    return model, result


class TestRescoreMMCTM:
    def test_matches_in_fit_ll_exactly_in_f64(self, mmctm_fixture):
        model, result = _fit_restarts(mmctm_fixture, jnp.float64)
        ll64 = rs.rescore_mmctm_f64(
            result.state.lam, result.state.gamma, model.Xdense, model.config
        )
        np.testing.assert_allclose(ll64, np.asarray(result.ll), rtol=1e-12)

    def test_matches_in_fit_ll_to_scoring_rounding_in_f32(self, mmctm_fixture):
        model, result = _fit_restarts(mmctm_fixture, jnp.float32)
        ll64 = rs.rescore_mmctm_f64(
            result.state.lam, result.state.gamma, model.Xdense, model.config
        )
        # same states, same formula: only f32 evaluation rounding differs
        np.testing.assert_allclose(ll64, np.asarray(result.ll), atol=2e-5)

    def test_lanes_subset(self, mmctm_fixture):
        model, result = _fit_restarts(mmctm_fixture, jnp.float64)
        full = rs.rescore_mmctm_f64(
            result.state.lam, result.state.gamma, model.Xdense, model.config
        )
        sub = rs.rescore_mmctm_f64(
            result.state.lam, result.state.gamma, model.Xdense, model.config,
            lanes=np.array([2, 0]),
        )
        # BLAS may pick different kernels for different batch shapes: allow
        # last-ulp f64 differences between subset and full scoring
        np.testing.assert_allclose(sub, full[[2, 0]], rtol=1e-12)

    def test_dead_lane_rescored_nan_and_never_picked(self, mmctm_fixture):
        model, result = _fit_restarts(mmctm_fixture, jnp.float64)
        lam = np.asarray(result.state.lam).copy()
        lam[1] = np.nan  # poison lane 1's state
        ll64 = rs.rescore_mmctm_f64(
            lam, result.state.gamma, model.Xdense, model.config
        )
        assert np.isnan(ll64[1]).all()
        assert 1 not in rs.pick_optimal_modality_restarts_np(ll64)
        assert rs.pick_optimal_restart_np(ll64) != 1


class TestNumpyPicksMirrorDevicePicks:
    def test_random_matrices(self, rng):
        for _ in range(20):
            ll = rng.normal(-4.0, 1.0, size=(17, 3))
            ll[rng.integers(0, 17)] = np.nan  # one dead lane
            dev_m = np.asarray(
                rmod.pick_optimal_modality_restarts(jnp.asarray(ll))
            )
            np.testing.assert_array_equal(
                rs.pick_optimal_modality_restarts_np(ll), dev_m
            )
            assert rs.pick_optimal_restart_np(ll) == int(
                rmod.pick_optimal_restart(jnp.asarray(ll))
            )

    def test_dense_rank_ties(self):
        vals = np.array([30.0, 10.0, 20.0, 10.0])
        np.testing.assert_array_equal(rs.dense_rank_np(vals), [3, 1, 2, 1])
        np.testing.assert_array_equal(
            rs.dense_rank_np(vals), np.asarray(rmod.dense_rank(jnp.asarray(vals)))
        )


class TestShortlist:
    def test_contains_per_modality_winners(self, rng):
        ll = rng.normal(-4.0, 0.5, size=(50, 2))
        cand = rs.shortlist_lanes(ll, window=1e-2)
        for m in range(2):
            assert np.argmax(ll[:, m]) in cand

    def test_all_nan_falls_back_to_everything(self):
        ll = np.full((5, 2), np.nan)
        np.testing.assert_array_equal(rs.shortlist_lanes(ll), np.arange(5))

    def test_window_excludes_far_losers(self):
        ll = np.array([[-4.0], [-3.0], [-3.0000001], [-9.0]])
        cand = rs.shortlist_lanes(ll, window=1e-2)
        assert 1 in cand and 2 in cand and 3 not in cand and 0 not in cand


class TestSelectionWiring:
    def test_two_stage_f64_selection_runs_and_matches_f32_on_clear_winner(
        self, mmctm_fixture
    ):
        """On the tiny f64 fixture the two selection paths must agree (no
        scoring noise in f64), pinning that rescore_f64=True is wired into
        both the stage-1 graft pick and the stage-2 dense-rank pick."""
        model = MMCTM(mmctm_fixture["K"], mmctm_fixture["alpha"], mmctm_fixture["X"])
        alpha = jnp.asarray([0.1, 0.1], model.config.dtype)
        kw = dict(restarts=4, stage2_restarts=2, maxiter=12)
        best_a, s1_a, s2_a, idx_a = rmod.two_stage_fit(
            jax.random.key(0), model.Xdense, model.config, alpha,
            rescore_f64=True, **kw,
        )
        best_b, s1_b, s2_b, idx_b = rmod.two_stage_fit(
            jax.random.key(0), model.Xdense, model.config, alpha,
            rescore_f64=False, **kw,
        )
        assert idx_a == int(idx_b)
        np.testing.assert_allclose(
            np.asarray(best_a.ll), np.asarray(best_b.ll), rtol=1e-12
        )

    def test_select_modality_winners_f64_info(self, mmctm_fixture):
        model, result = _fit_restarts(mmctm_fixture, jnp.float64)
        best_m, info = rmod.select_modality_winners_f64(
            result, model.Xdense, model.config
        )
        # winners must equal the device pick in f64 (no scoring noise)
        np.testing.assert_array_equal(
            best_m, np.asarray(rmod.pick_optimal_modality_restarts(result.ll))
        )
        assert set(info) >= {"rescored_lanes", "ll_f64", "winners"}
        # every winner was actually rescored
        assert all(w in info["rescored_lanes"] for w in best_m)

    def test_fit_mmctm_restarts_rescored_default(self, mmctm_fixture):
        model = rmod.fit_mmctm_restarts(
            mmctm_fixture["K"], mmctm_fixture["alpha"], mmctm_fixture["X"],
            restarts=3, maxiter=10,
        )
        assert np.all(np.isfinite(model.ll))


class TestOtherFamilies:
    def test_lda_rescore_matches_in_fit(self, lda_fixture):
        from multimodalmusig_tpu.models import lda as lda_mod
        from multimodalmusig_tpu.models.lda import LDA

        model = LDA(
            lda_fixture["K"], lda_fixture["alpha"], lda_fixture["eta"],
            lda_fixture["X"],
        )
        keys = jax.random.split(jax.random.key(0), 3)
        result = jax.vmap(
            lambda k: lda_mod.fit(
                lda_mod.init(k, model.config), model.Xdense, model.config,
                maxiter=10, tol=1e-6,
            )
        )(keys)
        ll64 = rs.rescore_lda_f64(
            result.state.gamma, result.state.lam, model.Xdense
        )
        np.testing.assert_allclose(ll64, np.asarray(result.ll), rtol=1e-12)

    def test_ilda_restarts_rescored(self, lda_fixture):
        model = rmod.fit_ilda_restarts(
            2, 0.1, 0.1, FEATURES, lda_fixture["X"], restarts=3, maxiter=15
        )
        assert np.isfinite(model.ll)

    def test_ilda_rescore_matches_in_fit(self, lda_fixture):
        from multimodalmusig_tpu.models import ilda as ilda_mod
        from multimodalmusig_tpu.models.ilda import ILDA

        model = ILDA(2, 0.1, 0.1, FEATURES, lda_fixture["X"])
        keys = jax.random.split(jax.random.key(0), 3)
        result = jax.vmap(
            lambda k: ilda_mod.fit(
                ilda_mod.init(k, model.config), model.Xdense, model.F,
                model.config, maxiter=10, tol=1e-6,
            )
        )(keys)
        ll64 = rs.rescore_ilda_f64(
            result.state.gamma, result.state.lam, model.Xdense, model.F
        )
        np.testing.assert_allclose(ll64, np.asarray(result.ll), rtol=1e-12)

    def test_immctm_rescore_matches_in_fit(self, mmctm_fixture):
        from multimodalmusig_tpu.models import immctm as immctm_mod
        from multimodalmusig_tpu.models.immctm import IMMCTM

        model = IMMCTM(
            mmctm_fixture["K"], mmctm_fixture["alpha"], [FEATURES, FEATURES],
            mmctm_fixture["X"],
        )
        alpha_full = model.state.alpha
        keys = jax.random.split(jax.random.key(0), 3)

        def one(k):
            state = immctm_mod.init(
                k, model.config, [np.zeros(i) for i in model.config.I]
            )._replace(alpha=alpha_full)
            return immctm_mod.fit(
                state, model.Xdense, model.F, model.config, maxiter=10, tol=1e-6
            )

        result = jax.vmap(one)(keys)
        ll64 = rs.rescore_immctm_f64(
            result.state.lam, result.state.gamma,
            [np.asarray(x) for x in model.Xdense], model.F, model.config,
        )
        np.testing.assert_allclose(ll64, np.asarray(result.ll), rtol=1e-12)

    def test_immctm_restarts_rescored(self, mmctm_fixture):
        model = rmod.fit_immctm_restarts(
            mmctm_fixture["K"], mmctm_fixture["alpha"], [FEATURES, FEATURES],
            mmctm_fixture["X"], restarts=3, maxiter=12,
        )
        assert np.all(np.isfinite(model.ll))
