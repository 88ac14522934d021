"""Restart-orchestration and mesh-sharding tests (8 virtual CPU devices)."""

import jax
import jax.numpy as jnp
import numpy as np

from multimodalmusig_tpu.models.mmctm import MMCTM
from multimodalmusig_tpu.parallel import restarts as rmod
from multimodalmusig_tpu.parallel import sharding as smod


class TestDenseRank:
    def test_matches_statsbase_semantics(self):
        # StatsBase.denserank([30, 10, 20, 10]) == [3, 1, 2, 1]
        got = np.asarray(rmod.dense_rank(jnp.asarray([30.0, 10.0, 20.0, 10.0])))
        np.testing.assert_array_equal(got, [3, 1, 2, 1])

    def test_all_ties(self):
        got = np.asarray(rmod.dense_rank(jnp.asarray([5.0, 5.0, 5.0])))
        np.testing.assert_array_equal(got, [1, 1, 1])


class TestSelection:
    def test_pick_optimal_modality(self):
        ll = jnp.asarray([[-3.0, -5.0], [-2.0, -6.0], [-4.0, -4.0]])
        got = np.asarray(rmod.pick_optimal_modality_restarts(ll))
        np.testing.assert_array_equal(got, [1, 2])

    def test_pick_optimal_restart_mean_dense_rank(self):
        # |ll| ranks: col0: [2,1,3]; col1: [2,3,1] -> means [2, 2, 2]... use
        # a case with a clear winner
        ll = jnp.asarray([[-3.0, -5.0], [-2.0, -4.0], [-4.0, -6.0]])
        # ranks col0: [2,1,3], col1: [2,1,3] -> means [2,1,3] -> idx 1
        assert int(rmod.pick_optimal_restart(ll)) == 1


class TestFitRestarts:
    def test_lanes_differ_and_are_finite(self, mmctm_fixture):
        model = MMCTM(mmctm_fixture["K"], mmctm_fixture["alpha"], mmctm_fixture["X"])
        result = rmod.fit_restarts(
            jax.random.key(0),
            model.Xdense,
            model.config,
            jnp.asarray([0.1, 0.1], model.config.dtype),
            restarts=4,
            maxiter=12,
            tol=1e-4,
        )
        ll = np.asarray(result.ll)
        assert ll.shape == (4, 2)
        assert np.all(np.isfinite(ll))
        # independent random inits -> different lanes
        assert not np.allclose(ll[0], ll[1])

    def test_lane_matches_single_fit(self, mmctm_fixture):
        """A restart lane must equal the same-key single fit (vmap parity)."""
        from multimodalmusig_tpu.models import mmctm as mmod
        from multimodalmusig_tpu.models.mmctm import init_with_alpha

        model = MMCTM(mmctm_fixture["K"], mmctm_fixture["alpha"], mmctm_fixture["X"])
        alpha = jnp.asarray([0.1, 0.1], model.config.dtype)
        keys = jax.random.split(jax.random.key(7), 3)
        batched = rmod.fit_restarts_from_keys(
            keys, model.Xdense, model.config, alpha, maxiter=8, tol=1e-4
        )
        state0 = init_with_alpha(keys[1], model.config, model.Xdense, [0.1, 0.1])
        single = jax.jit(
            mmod.fit, static_argnames=("config", "maxiter", "tol")
        )(state0, model.Xdense, model.config, maxiter=8, tol=1e-4)
        np.testing.assert_allclose(
            np.asarray(batched.ll)[1], np.asarray(single.ll), rtol=1e-6
        )


class TestTwoStage:
    def test_protocol_improves_on_stage1_median(self, mmctm_fixture):
        model = MMCTM(mmctm_fixture["K"], mmctm_fixture["alpha"], mmctm_fixture["X"])
        best, stage1, stage2, idx = rmod.two_stage_fit(
            jax.random.key(0),
            model.Xdense,
            model.config,
            jnp.asarray([0.1, 0.1], model.config.dtype),
            restarts=4,
            maxiter=15,
        )
        s1 = np.asarray(stage1.ll)
        b = np.asarray(best.ll)
        assert np.all(np.isfinite(b))
        # stage-2 grafts each modality's best topics: final ll should be at
        # least close to the stage-1 per-modality best
        for m in range(2):
            assert b[m] >= np.median(s1[:, m]) - 0.5

    def test_stage2_restarts_are_duplicates(self, mmctm_fixture):
        """Pins the stage2_restarts=1 default (restarts.py module docstring):
        the reference grafts EVERY modality's best topics over each stage-2
        worker (run_mmctm.jl:126-130) and all remaining state initializes
        deterministically, so its R stage-2 fits are identical — and so are
        ours (the per-lane random γ is entirely overwritten by the graft)."""
        model = MMCTM(mmctm_fixture["K"], mmctm_fixture["alpha"], mmctm_fixture["X"])
        _, _, stage2, idx = rmod.two_stage_fit(
            jax.random.key(0),
            model.Xdense,
            model.config,
            jnp.asarray([0.1, 0.1], model.config.dtype),
            restarts=3,
            stage2_restarts=3,
            maxiter=12,
        )
        ll = np.asarray(stage2.ll)
        lam = np.asarray(stage2.state.lam)
        for r in (1, 2):
            np.testing.assert_array_equal(ll[r], ll[0])
            np.testing.assert_array_equal(lam[r], lam[0])
        assert int(idx) == 0  # dense-rank pick returns the first of the ties

    def test_wrapper_returns_fitted_model(self, mmctm_fixture):
        model = rmod.fit_mmctm_restarts(
            mmctm_fixture["K"], mmctm_fixture["alpha"], mmctm_fixture["X"],
            restarts=3, maxiter=12,
        )
        assert isinstance(model, MMCTM)
        assert model.ll is not None and np.all(np.isfinite(model.ll))
        assert hasattr(model, "ll_history") and len(model.ll_history) >= 1


class TestSharding:
    def test_mesh_construction(self):
        mesh = smod.make_mesh(2, 4, jax.devices("cpu"))
        assert mesh.shape == {"restart": 2, "data": 4}

    def test_sharded_restarts_match_unsharded(self, mmctm_fixture):
        model = MMCTM(mmctm_fixture["K"], mmctm_fixture["alpha"], mmctm_fixture["X"])
        alpha = jnp.asarray([0.1, 0.1], model.config.dtype)
        mesh = smod.make_mesh(2, 2, jax.devices("cpu")[:4])
        sharded = smod.sharded_fit_restarts(
            mesh, jax.random.key(3), model.Xdense, model.config, alpha,
            restarts=4, maxiter=6,
        )
        unsharded = rmod.fit_restarts(
            jax.random.key(3), model.Xdense, model.config, alpha,
            restarts=4, maxiter=6,
        )
        np.testing.assert_allclose(
            np.asarray(sharded.ll), np.asarray(unsharded.ll), rtol=1e-5
        )

    def test_data_parallel_fit_matches_single_device(self, mmctm_fixture):
        from multimodalmusig_tpu.models import mmctm as mmod
        from multimodalmusig_tpu.models.mmctm import init_with_alpha

        # use 8 docs so the data axis can shard 4 ways
        rng = np.random.default_rng(5)
        X = tuple(
            jnp.asarray(rng.integers(0, 6, size=(8, V)), jnp.float64)
            for V in (4, 4)
        )
        import dataclasses

        model = MMCTM(mmctm_fixture["K"], mmctm_fixture["alpha"], mmctm_fixture["X"])
        config = dataclasses.replace(model.config, D=8)
        state = init_with_alpha(jax.random.key(2), config, X, [0.1, 0.1])

        mesh = smod.make_mesh(1, 4, jax.devices("cpu")[:4])
        sharded = smod.sharded_data_parallel_fit(mesh, state, X, config, maxiter=5)
        single = jax.jit(
            mmod.fit, static_argnames=("config", "maxiter", "tol")
        )(state, X, config, maxiter=5)
        np.testing.assert_allclose(
            np.asarray(sharded.ll), np.asarray(single.ll), rtol=1e-8
        )

    def test_dryrun_multichip(self):
        smod.dryrun_multichip(8)


class TestNaNLaneTolerance:
    def test_pick_functions_skip_nonfinite_lanes(self):
        ll = jnp.asarray([[np.nan, -5.0], [-2.0, -6.0], [-4.0, np.nan]])
        best_m = np.asarray(rmod.pick_optimal_modality_restarts(ll))
        np.testing.assert_array_equal(best_m, [1, 0])
        ll2 = jnp.asarray([[np.nan, np.nan], [-2.0, -4.0], [-3.0, -5.0]])
        assert int(rmod.pick_optimal_restart(ll2)) == 1


class TestVocabSharding:
    def test_vocab_sharded_fit_matches_single_device(self, mmctm_fixture):
        """TP analog (SURVEY.md §2.8): shard the vocabulary axis of the
        count matrices; XLA reduces the V-contractions across the mesh."""
        import dataclasses

        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        from multimodalmusig_tpu.models import mmctm as mmod
        from multimodalmusig_tpu.models.mmctm import init_with_alpha

        rng = np.random.default_rng(11)
        X = tuple(
            jnp.asarray(rng.integers(0, 6, size=(4, V)), jnp.float64)
            for V in (8, 8)
        )
        model = MMCTM(mmctm_fixture["K"], mmctm_fixture["alpha"], mmctm_fixture["X"])
        config = dataclasses.replace(model.config, D=4, V=(8, 8))
        state = init_with_alpha(jax.random.key(4), config, X, [0.1, 0.1])

        mesh = Mesh(np.array(jax.devices("cpu")[:4]), axis_names=("vocab",))
        Xs = tuple(
            jax.device_put(Xm, NamedSharding(mesh, P(None, "vocab"))) for Xm in X
        )
        state_s = state._replace(
            gamma=tuple(
                jax.device_put(g, NamedSharding(mesh, P(None, "vocab")))
                for g in state.gamma
            ),
            Elnphi=tuple(
                jax.device_put(g, NamedSharding(mesh, P(None, "vocab")))
                for g in state.Elnphi
            ),
        )
        fit = jax.jit(mmod.fit, static_argnames=("config", "maxiter", "tol"))
        sharded = fit(state_s, Xs, config, maxiter=5)
        single = fit(state, X, config, maxiter=5)
        np.testing.assert_allclose(
            np.asarray(sharded.ll), np.asarray(single.ll), rtol=1e-8
        )


class TestShmapRestarts:
    """The shard_map restart fan-out (parallel/sharding.py
    shmap_fit_restarts): per-device unpartitioned programs over a flat
    "restart" mesh — the multi-device path that keeps the fused λ kernel
    on GPUs (GSPMD cannot partition a pallas_call)."""

    def test_matches_unsharded(self, mmctm_fixture):
        model = MMCTM(mmctm_fixture["K"], mmctm_fixture["alpha"], mmctm_fixture["X"])
        alpha = jnp.asarray([0.1, 0.1], model.config.dtype)
        sm = smod.shmap_fit_restarts(
            jax.random.key(3), model.Xdense, model.config, alpha,
            restarts=8, maxiter=6, devices=jax.devices("cpu")[:4],
        )
        plain = rmod.fit_restarts(
            jax.random.key(3), model.Xdense, model.config, alpha,
            restarts=8, maxiter=6,
        )
        np.testing.assert_allclose(
            np.asarray(sm.ll), np.asarray(plain.ll), rtol=1e-6
        )

    def test_pads_non_divisible_restarts(self, mmctm_fixture):
        model = MMCTM(mmctm_fixture["K"], mmctm_fixture["alpha"], mmctm_fixture["X"])
        alpha = jnp.asarray([0.1, 0.1], model.config.dtype)
        # 5 on 4 devices (pad 3) AND 3 on 8 devices (pad 5 > restarts — the
        # cycling-pad case a single tail slice would underfill)
        for restarts, n_dev in [(5, 4), (3, 8)]:
            sm = smod.shmap_fit_restarts(
                jax.random.key(3), model.Xdense, model.config, alpha,
                restarts=restarts, maxiter=4,
                devices=jax.devices("cpu")[:n_dev],
            )
            assert np.asarray(sm.ll).shape == (restarts, 2)
            plain = rmod.fit_restarts(
                jax.random.key(3), model.Xdense, model.config, alpha,
                restarts=restarts, maxiter=4,
            )
            np.testing.assert_allclose(
                np.asarray(sm.ll), np.asarray(plain.ll), rtol=1e-6
            )

    def test_fused_kernel_runs_under_shard_map(self, mmctm_fixture, monkeypatch):
        """Where the gate says GPU, the kernel runs inside every device's
        shard_map body (interpret mode on the CPU mesh) and matches the XLA
        path."""
        import multimodalmusig_tpu.ops.pallas.lambda_kernel as lk

        model = MMCTM(
            mmctm_fixture["K"], mmctm_fixture["alpha"], mmctm_fixture["X"],
            dtype=jnp.float32,  # the kernel is f32
        )
        alpha = jnp.asarray([0.1, 0.1], jnp.float32)
        calls = []
        orig = lk.maximize_lambda_fused

        def spy(*a, **k):
            calls.append(1)
            k["interpret"] = True
            return orig(*a, **k)

        monkeypatch.setattr(lk, "maximize_lambda_fused", spy)
        monkeypatch.setattr(
            smod, "fused_lambda_enabled",
            lambda MK, dtype, devices: len(list(devices)) == 1,
        )
        sm = smod.shmap_fit_restarts(
            jax.random.key(5), model.Xdense, model.config, alpha,
            restarts=4, maxiter=3, devices=jax.devices("cpu")[:2],
        )
        assert calls, "fused kernel was not invoked under shard_map"
        plain = rmod.fit_restarts(
            jax.random.key(5), model.Xdense, model.config, alpha,
            restarts=4, maxiter=3,
        )
        np.testing.assert_allclose(
            np.asarray(sm.ll), np.asarray(plain.ll), rtol=1e-4, atol=1e-6
        )
