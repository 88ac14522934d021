"""The fused λ kernel (Pallas through Triton) against the pure-jnp solver, in
interpret mode on the CPU; its Triton lowering for CUDA, and the gate that
decides where it runs."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multimodalmusig_tpu.models import ctm_base
from multimodalmusig_tpu.ops.pallas import lambda_kernel as lk
from multimodalmusig_tpu.ops.pallas.lambda_kernel import maximize_lambda_fused
from multimodalmusig_tpu.ops.solvers import lambda_grad, maximize_lambda


def _problem(rng, B, MK, lanes=None):
    shape = (B, MK) if lanes is None else (lanes, B, MK)
    n = 1 if lanes is None else lanes
    invS = []
    for _ in range(n):
        A = rng.normal(size=(MK, MK))
        invS.append(np.eye(MK) + 0.05 * (A @ A.T) / MK)
    invS = np.stack(invS) if lanes is not None else invS[0]
    mu_shape = (MK,) if lanes is None else (lanes, MK)
    f = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
    return dict(
        lam0=f(np.zeros(shape)),
        nu=f(rng.uniform(0.5, 1.5, shape)),
        ndz=f(rng.uniform(1, 10, shape)),
        st=f(rng.uniform(0, 5, shape)),
        mu=f(rng.normal(size=mu_shape)),
        invS=f(invS),
    )


def _args(p, sl=slice(None)):
    return (p["lam0"][sl], p["nu"][sl], p["ndz"][sl], p["st"][sl], p["mu"], p["invS"])


@pytest.fixture
def problem(rng):
    return _problem(rng, 96, 14)


def test_fused_lambda_matches_jnp_solver(problem):
    ref = np.asarray(maximize_lambda(*_args(problem)))
    fused = np.asarray(maximize_lambda_fused(*_args(problem), interpret=True))
    np.testing.assert_allclose(fused, ref, atol=5e-5)


@pytest.mark.parametrize("launch", [(16, 4), (32, 8), (64, 4)])
def test_launch_override_matches_default(problem, launch):
    """The sweep's (documents per program, warps) override changes only the
    grid: 96 documents in ragged tiles of 16, 32 or 64 give the same λ."""
    default = np.asarray(maximize_lambda_fused(*_args(problem), interpret=True))
    got = np.asarray(maximize_lambda_fused(*_args(problem), launch=launch, interpret=True))
    np.testing.assert_allclose(got, default, atol=1e-6)


@pytest.mark.parametrize("MK", [4, 19, 32])
def test_fused_lambda_widths(rng, MK):
    """Every padding class: 4 -> 16 columns, 19 -> 32, 32 -> 32 (none)."""
    p = _problem(rng, 40, MK)
    ref = np.asarray(maximize_lambda(*_args(p)))
    fused = np.asarray(maximize_lambda_fused(*_args(p), interpret=True))
    np.testing.assert_allclose(fused, ref, atol=5e-5)


def test_fused_lambda_is_stationary(problem):
    fused = maximize_lambda_fused(*_args(problem), interpret=True)
    g = np.asarray(
        jnp.stack(
            [
                lambda_grad(
                    fused[i], problem["nu"][i], problem["ndz"][i],
                    problem["st"][i], problem["mu"], problem["invS"],
                )
                for i in range(0, 96, 16)
            ]
        )
    )
    # float32 kernel: gradient small relative to the count scale (~10)
    assert np.abs(g).max() < 1e-2


def test_fused_lambda_ragged_batch(problem):
    """B not a multiple of the document tile exercises the masked rows."""
    sl = slice(0, 33)
    fused = np.asarray(maximize_lambda_fused(*_args(problem, sl), interpret=True))
    ref = np.asarray(maximize_lambda(*_args(problem, sl)))
    np.testing.assert_allclose(fused, ref, atol=5e-5)


def test_padded_topics_are_inert(problem):
    """A problem widened by inert topics (identity rows in Σ⁻¹, ν=1 and
    λ=μ=N/ζ=sumθ=0) solves to the same λ with the extra columns at 0 —
    what the kernel's own padding relies on."""
    lam0, nu, ndz, st, mu, invS = _args(problem)
    B, MK = lam0.shape
    pad = 3

    def widen(x, fill):
        return jnp.concatenate([x, jnp.full((B, pad), fill, x.dtype)], axis=1)

    invS_w = jnp.eye(MK + pad, dtype=jnp.float32).at[:MK, :MK].set(invS)
    wide = maximize_lambda_fused(
        widen(lam0, 0.0), widen(nu, 1.0), widen(ndz, 0.0), widen(st, 0.0),
        jnp.concatenate([mu, jnp.zeros(pad, jnp.float32)]), invS_w,
        cg_iter=MK, interpret=True,
    )
    narrow = maximize_lambda_fused(*_args(problem), cg_iter=MK, interpret=True)
    np.testing.assert_allclose(np.asarray(wide[:, :MK]), np.asarray(narrow), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(wide[:, MK:]), 0.0)


def test_mk_over_lane_budget_raises():
    big = jnp.zeros((8, 40), jnp.float32)
    with pytest.raises(ValueError, match="limit"):
        maximize_lambda_fused(
            big, big, big, big, jnp.zeros(40), jnp.eye(40), interpret=True
        )


def test_restart_batched_fused_matches_per_lane(rng):
    """Each restart lane has its own μ/Σ⁻¹; the lane grid must match
    per-lane jnp solves."""
    p = _problem(rng, 40, 14, lanes=3)
    fused = np.asarray(maximize_lambda_fused(*_args(p), interpret=True))
    for r in range(3):
        ref = np.asarray(
            maximize_lambda(p["lam0"][r], p["nu"][r], p["ndz"][r], p["st"][r],
                            p["mu"][r], p["invS"][r])
        )
        np.testing.assert_allclose(fused[r], ref, atol=5e-5)


def test_fused_lambda_under_vmap(rng):
    """The single-lane call under vmap (how the vmapped fit loops call it)
    equals the explicit lane grid."""
    p = _problem(rng, 37, 14, lanes=3)
    grid = maximize_lambda_fused(*_args(p), interpret=True)
    vm = jax.vmap(lambda *a: maximize_lambda_fused(*a, interpret=True))(*_args(p))
    np.testing.assert_allclose(np.asarray(vm), np.asarray(grid), atol=1e-6)


@pytest.mark.parametrize("MK,tile,MKP", [(4, 64, 16), (14, 64, 16), (19, 32, 32), (32, 32, 32)])
def test_launch_config(MK, tile, MKP):
    assert lk.padded_topics(MK) == MKP
    assert lk.launch_config(MK) == (tile, 4)


def _triton_ir(fn, *args):
    """Triton IR text of every pallas_call in fn, lowered for CUDA here on
    the CPU (lowering needs no GPU; compiling would)."""
    from jax._src.pallas.triton import pallas_call_registration as reg

    captured = []
    orig = reg.lowering.lower_jaxpr_to_triton_module

    def spy(*a, **k):
        res = orig(*a, **k)
        captured.append(res.module.operation.get_asm())
        return res

    reg.lowering.lower_jaxpr_to_triton_module = spy
    try:
        jax.jit(fn).trace(*args).lower(lowering_platforms=("cuda",))
    finally:
        reg.lowering.lower_jaxpr_to_triton_module = orig
    return captured


@pytest.mark.parametrize("MK", [14, 19])
def test_triton_ir_dots_are_ieee(MK):
    """Every tt.dot of the kernel carries IEEE input precision (Triton
    prints only a non-default precision, e.g. `inputPrecision = tf32`):
    the Σ⁻¹ matvecs never round their inputs to TF32."""
    x = jnp.zeros((2, 50, MK), jnp.float32)
    ir = _triton_ir(maximize_lambda_fused, x, x, x, x,
                    jnp.zeros((2, MK)), jnp.zeros((2, MK, MK)))
    assert len(ir) == 1
    dots = [l for l in ir[0].splitlines() if "tt.dot" in l]
    assert dots
    assert not [l for l in dots if "inputPrecision" in l and "ieee" not in l]


def _dev(platform):
    return types.SimpleNamespace(platform=platform)


@pytest.mark.parametrize(
    "platforms,MK,dtype,want",
    [
        (["gpu"], 14, jnp.float32, True),
        (["gpu"], 32, jnp.float32, True),
        (["cpu"], 14, jnp.float32, False),
        (["gpu"], 33, jnp.float32, False),
        (["gpu", "gpu"], 14, jnp.float32, False),
        (["gpu"], 14, jnp.float64, False),
    ],
)
def test_gate_by_platform_mk_devices(platforms, MK, dtype, want):
    """One GPU per program instance, MK within the kernel's limit, float32."""
    devices = [_dev(p) for p in platforms]
    assert ctm_base.fused_lambda_enabled(MK, dtype, devices) is want


def test_solve_lambda_routes_by_gate(problem, monkeypatch):
    """solve_lambda asks the gate (default device) unless force_fused says."""
    calls = []
    orig = lk.maximize_lambda_fused

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, interpret=True, **k)

    monkeypatch.setattr(lk, "maximize_lambda_fused", spy)
    args = _args(problem)
    ctm_base.solve_lambda(*args)  # CPU default device: XLA path
    assert not calls
    ctm_base.solve_lambda(*args, force_fused=True)
    assert len(calls) == 1
    monkeypatch.setattr(ctm_base, "fused_lambda_enabled", lambda *a: True)
    out = ctm_base.solve_lambda(*args)
    assert len(calls) == 2
    ctm_base.solve_lambda(*args, force_fused=False)
    assert len(calls) == 2
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(maximize_lambda(*args)), atol=5e-5
    )
