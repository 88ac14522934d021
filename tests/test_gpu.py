"""Tests that need the card (marker `gpu`): the fused λ kernel compiled for
the GPU (no interpret mode exists there), the f32 fit against f64 on the
device, and device f64 rescoring against the host. Elsewhere they skip.

    MUSIG_TEST_PLATFORMS=cuda,cpu python -m pytest -m gpu -o addopts="" tests/test_gpu.py
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import requires_brca_data

pytestmark = pytest.mark.gpu


def _brca_X():
    from multimodalmusig_tpu.utils.data import brca_counts_path
    from multimodalmusig_tpu.utils.fast_tsv import read_counts_tsv

    return [read_counts_tsv(brca_counts_path(f))[0].T
            for f in ("brca-eu_snv_counts.tsv", "brca-eu_sv_counts.tsv")]


@pytest.mark.parametrize("MK", [14, 19])
def test_fused_kernel_matches_reference_on_gpu(gpu, rng, MK):
    """Compiled through Triton at cold-start budgets: the exact-f32 kernel
    and the XLA reference reach the same optimum."""
    from multimodalmusig_tpu.ops.pallas.lambda_kernel import maximize_lambda_fused
    from multimodalmusig_tpu.ops.solvers import maximize_lambda

    R, D = 4, 560
    A = rng.normal(size=(R, MK, MK))
    invS = np.eye(MK) + 0.05 * np.einsum("rij,rkj->rik", A, A) / MK
    args = [rng.uniform(-1, 1, (R, D, MK)), rng.uniform(0.5, 1.5, (R, D, MK)),
            rng.uniform(1, 10, (R, D, MK)), rng.uniform(0, 5, (R, D, MK)),
            rng.normal(size=(R, MK)), invS]
    args = [jax.device_put(jnp.asarray(a, jnp.float32), gpu) for a in args]
    got = maximize_lambda_fused(*args)
    with jax.default_matmul_precision("highest"):
        ref = jax.vmap(maximize_lambda)(*args)
    assert got.devices() == {gpu}
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=5e-5)


@requires_brca_data
@pytest.mark.parametrize("force_fused", [True, False])
def test_f32_fit_tracks_f64_on_gpu(gpu, force_fused):
    """20 CAVI iterations of one BRCA lane in f32 against f64 with the same
    solver budgets: exact f32 drifts ~2e-7; every contraction at TF32 drifts
    ~2e-5 (chip_smoke.py's negative control), far outside 1e-6."""
    from multimodalmusig_tpu.models import mmctm as mm
    from multimodalmusig_tpu.models.ctm_base import resolved_budgets

    Xnp = _brca_X()
    cfg32 = mm.MMCTMConfig(K=(7, 7), V=(96, 48), D=Xnp[0].shape[0],
                           dtype=jnp.float32, force_fused=force_fused)
    fit = jax.jit(mm.fit, static_argnames=("config", "maxiter", "tol"))
    with jax.default_device(gpu):
        X32 = tuple(jnp.asarray(x, jnp.float32) for x in Xnp)
        s32 = mm.init_with_alpha(jax.random.key(7), cfg32, X32,
                                 jnp.asarray([0.1, 0.1], jnp.float32))
        h32 = np.asarray(fit(s32, X32, cfg32, maxiter=20, tol=0.0).ll_history)
        cfg64 = dataclasses.replace(cfg32, dtype=jnp.float64, force_fused=False,
                                    **resolved_budgets(cfg32))
        s64 = jax.tree_util.tree_map(
            lambda x: x.astype(jnp.float64) if jnp.issubdtype(x.dtype, jnp.floating)
            else x, s32)
        X64 = tuple(jnp.asarray(x, jnp.float64) for x in Xnp)
        h64 = np.asarray(fit(s64, X64, cfg64, maxiter=20, tol=0.0).ll_history)
    rel = np.abs(h32 - h64) / np.abs(h64)
    assert rel.max() < 1e-6, rel.max()


def test_device_rescore_matches_host_on_gpu(gpu, rng):
    from multimodalmusig_tpu.models.mmctm import MMCTMConfig
    from multimodalmusig_tpu.parallel.rescore import rescore_mmctm_f64
    from multimodalmusig_tpu.parallel.rescore_device import rescore_mmctm_f64_dev

    config = MMCTMConfig(K=(3, 2), V=(12, 7), D=40, dtype=jnp.float32)
    lam = rng.normal(size=(5, 40, 5))
    gamma = (rng.uniform(0.1, 3, (5, 3, 12)), rng.uniform(0.1, 3, (5, 2, 7)))
    X = [rng.integers(0, 6, (40, 12)).astype(float), rng.integers(0, 6, (40, 7)).astype(float)]
    with jax.default_device(gpu):
        dev = rescore_mmctm_f64_dev(lam, gamma, X, config)
    host = rescore_mmctm_f64(lam, gamma, X, config)
    np.testing.assert_allclose(dev, host, rtol=1e-12)
