"""Device-vs-host parity of the f64 selection re-scoring executors.

parallel/rescore_device.py runs the exact-f64 selection scores on the
accelerator (native f64) instead of fetching states to the host; these
tests pin that the two executors compute the same numbers (to f64
reduction-order roundoff) on every family, with lane subsets, dead (NaN)
lanes, and the xlogy zero convention, and that the dispatchers route by the
MUSIG_DEVICE_RESCORE gate. On this CPU-backend suite the "device" path is
jitted jnp on CPU — the same code path the GPU runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multimodalmusig_tpu.models.ilda import ILDA
from multimodalmusig_tpu.models.immctm import IMMCTM
from multimodalmusig_tpu.models.lda import LDA
from multimodalmusig_tpu.models.mmctm import MMCTM
from multimodalmusig_tpu.parallel import rescore as rs
from multimodalmusig_tpu.parallel import rescore_device as rd
from multimodalmusig_tpu.parallel import restarts as rmod

FEATURES = np.array([[1, 1], [1, 2], [2, 1], [2, 2]])


@pytest.fixture
def immctm_fixture():
    """test/immctm.jl:6-51: K=[2,3], 2 docs x 2 modalities, 2 features each."""
    return dict(
        K=[2, 3],
        alpha=[0.1, 0.1],
        features=[FEATURES, FEATURES],
        X=[
            [np.array([[1, 5], [2, 8]]), np.array([[1, 2], [2, 5]])],
            [np.array([[3, 4], [4, 9]]), np.array([[3, 4], [4, 6]])],
        ],
    )


@pytest.fixture
def ilda_fixture():
    """test/ilda.jl:4-22: K=2, 2 docs, 4-term vocab over 2 features."""
    return dict(
        K=2, alpha=0.1, eta=0.1, features=FEATURES,
        X=[np.array([[1, 5], [2, 8]]), np.array([[3, 2], [4, 5]])],
    )


@pytest.fixture
def mmctm_states(mmctm_fixture):
    model = MMCTM(
        mmctm_fixture["K"], mmctm_fixture["alpha"], mmctm_fixture["X"],
        dtype=jnp.float32,
    )
    result = rmod.fit_restarts(
        jax.random.key(7), model.Xdense, model.config,
        jnp.asarray([0.1, 0.1], jnp.float32),
        restarts=5, maxiter=12, tol=1e-6,
    )
    return model, result


class TestMMCTMParity:
    def test_full_population(self, mmctm_states):
        model, result = mmctm_states
        host = rs.rescore_mmctm_f64(
            np.asarray(result.state.lam),
            [np.asarray(g) for g in result.state.gamma],
            [np.asarray(x) for x in model.Xdense], model.config,
        )
        dev = rd.rescore_mmctm_f64_dev(
            result.state.lam, result.state.gamma, model.Xdense, model.config
        )
        assert dev.shape == host.shape == (5, model.config.M)
        np.testing.assert_allclose(dev, host, rtol=1e-12, atol=1e-12)

    def test_lane_subset_matches_full(self, mmctm_states):
        model, result = mmctm_states
        full = rd.rescore_mmctm_f64_dev(
            result.state.lam, result.state.gamma, model.Xdense, model.config
        )
        sub = rd.rescore_mmctm_f64_dev(
            result.state.lam, result.state.gamma, model.Xdense, model.config,
            lanes=np.array([3, 1]),
        )
        np.testing.assert_array_equal(sub, full[[3, 1]])

    def test_nan_lane_scores_nan(self, mmctm_states):
        model, result = mmctm_states
        lam = np.asarray(result.state.lam).copy()
        lam[2] = np.nan
        dev = rd.rescore_mmctm_f64_dev(
            lam, result.state.gamma, model.Xdense, model.config
        )
        assert np.isnan(dev[2]).all()
        assert np.isfinite(dev[[0, 1, 3, 4]]).all()

    def test_zero_prob_on_positive_count_is_neg_inf(self, mmctm_states):
        """xlogy convention: X == 0 cells contribute 0 even at P == 0, but an
        X > 0 cell with a collapsed (all-zero γ row ⇒ P = 0) topic table
        scores -inf — exactly like the host nonzero-gather path."""
        model, result = mmctm_states
        gam = [np.asarray(g).copy() for g in result.state.gamma]
        # lane 1, modality 0: zero every topic's mass on vocab item 0 (which
        # has X > 0 somewhere) => P[:, 0] == 0 exactly, ll -> -inf
        gam[0][1, :, 0] = 0.0
        host = rs.rescore_mmctm_f64(
            np.asarray(result.state.lam), gam,
            [np.asarray(x) for x in model.Xdense], model.config,
        )
        dev = rd.rescore_mmctm_f64_dev(
            np.asarray(result.state.lam), gam, model.Xdense, model.config
        )
        assert np.isneginf(dev[1, 0]) or np.isnan(dev[1, 0])
        # identical classification, identical finite values
        np.testing.assert_array_equal(np.isfinite(dev), np.isfinite(host))
        np.testing.assert_allclose(
            dev[np.isfinite(dev)], host[np.isfinite(host)], rtol=1e-12
        )


class TestIMMCTMParity:
    def test_full_population(self, immctm_fixture):
        model = IMMCTM(
            immctm_fixture["K"], immctm_fixture["alpha"],
            immctm_fixture["features"], immctm_fixture["X"],
            dtype=jnp.float32,
        )
        result = rmod._immctm_restarts_from_keys(
            jax.random.split(jax.random.key(3), 4),
            model.Xdense, model.F, model.state.alpha,
            config=model.config, maxiter=10, tol=1e-6,
        )
        host = rs.rescore_immctm_f64(
            np.asarray(result.state.lam),
            [[np.asarray(g) for g in gm] for gm in result.state.gamma],
            [np.asarray(x) for x in model.Xdense], model.F, model.config,
        )
        dev = rd.rescore_immctm_f64_dev(
            result.state.lam, result.state.gamma, model.Xdense, model.F,
            model.config,
        )
        np.testing.assert_allclose(dev, host, rtol=1e-12, atol=1e-12)


class TestLDAParity:
    def test_full_and_subset(self, lda_fixture):
        model = LDA(
            lda_fixture["K"], lda_fixture["alpha"], lda_fixture["eta"],
            lda_fixture["X"], dtype=jnp.float32,
        )
        result = rmod._lda_restarts_from_keys(
            jax.random.split(jax.random.key(5), 6), model.Xdense,
            config=model.config, maxiter=10, tol=1e-6,
        )
        host = rs.rescore_lda_f64(
            np.asarray(result.state.gamma), np.asarray(result.state.lam),
            np.asarray(model.Xdense),
        )
        dev = rd.rescore_lda_f64_dev(
            result.state.gamma, result.state.lam, model.Xdense
        )
        np.testing.assert_allclose(dev, host, rtol=1e-12, atol=1e-12)
        sub = rd.rescore_lda_f64_dev(
            result.state.gamma, result.state.lam, model.Xdense,
            lanes=np.array([4, 0]),
        )
        np.testing.assert_array_equal(sub, dev[[4, 0]])


class TestILDAParity:
    def test_full_population(self, ilda_fixture):
        model = ILDA(
            ilda_fixture["K"], ilda_fixture["alpha"], ilda_fixture["eta"],
            ilda_fixture["features"], ilda_fixture["X"], dtype=jnp.float32,
        )
        result = rmod._ilda_restarts_from_keys(
            jax.random.split(jax.random.key(9), 4), model.Xdense, model.F,
            config=model.config, maxiter=10, tol=1e-6,
        )
        host = rs.rescore_ilda_f64(
            np.asarray(result.state.gamma),
            [np.asarray(l) for l in result.state.lam],
            np.asarray(model.Xdense), model.F,
        )
        dev = rd.rescore_ilda_f64_dev(
            result.state.gamma, result.state.lam, model.Xdense, model.F
        )
        np.testing.assert_allclose(dev, host, rtol=1e-12, atol=1e-12)


class TestDispatch:
    def test_auto_is_host_on_cpu(self):
        assert rs._use_device_rescore() is False  # suite runs on CPU backend

    def test_forced_device_routes_and_matches(self, mmctm_states, monkeypatch):
        model, result = mmctm_states
        monkeypatch.setattr(rs, "_use_device_rescore", lambda: True)
        dev = rs.rescore_mmctm(
            result.state.lam, result.state.gamma, model.Xdense, model.config
        )
        host = rs.rescore_mmctm_f64(
            np.asarray(result.state.lam),
            [np.asarray(g) for g in result.state.gamma],
            [np.asarray(x) for x in model.Xdense], model.config,
        )
        np.testing.assert_allclose(dev, host, rtol=1e-12, atol=1e-12)

    def test_device_failure_falls_back_to_host(self, mmctm_states, monkeypatch):
        """A failing device scorer raises: selection never carries on
        silently on the host (no fallback, nothing latched)."""
        model, result = mmctm_states
        monkeypatch.setattr(rs, "_use_device_rescore", lambda: True)

        def boom(*a, **k):
            raise RuntimeError("no f64 on this backend")

        import multimodalmusig_tpu.parallel.rescore_device as rdev

        monkeypatch.setattr(rdev, "rescore_mmctm_f64_dev", boom)
        with pytest.raises(RuntimeError, match="no f64"):
            rs.rescore_mmctm(
                result.state.lam, result.state.gamma, model.Xdense,
                model.config,
            )
        assert not hasattr(rs, "_DEVICE_RESCORE_FAILED")

    def test_broken_device_module_falls_back_to_host(self, mmctm_states,
                                                      monkeypatch):
        """A rescore_device that fails to IMPORT raises too: the device
        executor is chosen by the backend, and a broken one is an error."""
        import sys

        model, result = mmctm_states
        monkeypatch.setattr(rs, "_use_device_rescore", lambda: True)
        monkeypatch.setitem(
            sys.modules, "multimodalmusig_tpu.parallel.rescore_device", None
        )  # `from ... import` on a None module raises ImportError
        with pytest.raises(ImportError):
            rs.rescore_mmctm(
                np.asarray(result.state.lam),
                [np.asarray(g) for g in result.state.gamma],
                [np.asarray(x) for x in model.Xdense], model.config,
            )

    def test_forced_device_failure_propagates(self, mmctm_states, monkeypatch):
        """MUSIG_DEVICE_RESCORE=1 explicitly forces the device executor;
        its failures raise like any other."""
        from multimodalmusig_tpu.ops import flags

        model, result = mmctm_states
        monkeypatch.setattr(flags, "DEVICE_RESCORE", "1")

        def boom(*a, **k):
            raise RuntimeError("no f64 on this backend")

        import multimodalmusig_tpu.parallel.rescore_device as rdev

        monkeypatch.setattr(rdev, "rescore_mmctm_f64_dev", boom)
        with pytest.raises(RuntimeError, match="no f64"):
            rs.rescore_mmctm(
                result.state.lam, result.state.gamma, model.Xdense,
                model.config,
            )

    def test_dispatch_raises_instead_of_falling_back(self, monkeypatch):
        """_dispatch runs exactly one executor: the device thunk's error
        reaches the caller and the host thunk never runs."""
        monkeypatch.setattr(rs, "_use_device_rescore", lambda: True)
        host_calls = []

        def device():
            raise ValueError("device scorer failed")

        with pytest.raises(ValueError, match="device scorer failed"):
            rs._dispatch(device, lambda: host_calls.append(1))
        assert not host_calls
        monkeypatch.setattr(rs, "_use_device_rescore", lambda: False)
        assert rs._dispatch(device, lambda: "host") == "host"

    def test_out_of_range_lanes_raise_like_host(self, mmctm_states):
        """jit gathers clamp/fill out-of-range indices silently; the device
        path must raise IndexError exactly like the host path's lam[lanes]."""
        model, result = mmctm_states
        with pytest.raises(IndexError, match="out of range"):
            rd.rescore_mmctm_f64_dev(
                result.state.lam, result.state.gamma, model.Xdense,
                model.config, lanes=np.array([7]),  # only 5 lanes exist
            )

    def test_negative_lanes_match_host_semantics(self, mmctm_states):
        model, result = mmctm_states
        full = rd.rescore_mmctm_f64_dev(
            result.state.lam, result.state.gamma, model.Xdense, model.config
        )
        neg = rd.rescore_mmctm_f64_dev(
            result.state.lam, result.state.gamma, model.Xdense, model.config,
            lanes=np.array([-1, -5]),
        )
        np.testing.assert_array_equal(neg, full[[4, 0]])

    def test_selection_pick_identical_between_executors(self, mmctm_states,
                                                        monkeypatch):
        """The dense-rank pick and per-modality winners must not depend on
        which executor scored."""
        model, result = mmctm_states
        host_ll = rs.rescore_mmctm_f64(
            np.asarray(result.state.lam),
            [np.asarray(g) for g in result.state.gamma],
            [np.asarray(x) for x in model.Xdense], model.config,
        )
        dev_ll = rd.rescore_mmctm_f64_dev(
            result.state.lam, result.state.gamma, model.Xdense, model.config
        )
        assert rs.pick_optimal_restart_np(host_ll) == rs.pick_optimal_restart_np(dev_ll)
        np.testing.assert_array_equal(
            rs.pick_optimal_modality_restarts_np(host_ll),
            rs.pick_optimal_modality_restarts_np(dev_ll),
        )
