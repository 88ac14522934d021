"""Device-mesh sharding for restart- and data-parallel fitting.

The reference has no in-library parallelism at all (SURVEY.md §2.8): its only
fan-out is `Distributed.pmap` over restarts in the CLI script, with zero
communication during fitting. The equivalents here:

  * restart-parallel (the pmap analogue): restarts are a vmap axis; sharding
    that axis over the mesh runs lanes on different chips with zero
    communication — same semantics as the reference's process fan-out.
  * data-parallel (new capability): documents shard over a mesh axis; the
    M-step sufficient statistics (γ scatter-adds, μ/Σ sums —
    src/MMCTM.jl:200-242) are einsum reductions over D, so GSPMD inserts the
    psum/all-reduce across the data axis automatically. This is what scales
    a single fit to PCAWG-sized cohorts.

Everything goes through `jax.jit` + `NamedSharding` input constraints — XLA
chooses the collectives; no hand-written communication. On a host whose
cards are joined all to all (NVLink), the meshes follow the algorithm alone:
a flat "restart" axis and a flat "data" axis.

GSPMD cannot partition the fused λ kernel's pallas_call, so the partitioned
fits set `config.force_fused` from the mesh (fused_lambda_enabled: off on
more than one device); the shard_map fan-out runs one unpartitioned program
per device and keeps the kernel on GPUs.
"""

from __future__ import annotations

import dataclasses

from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models import mmctm as mmctm_mod
from ..models.ctm_base import fused_lambda_enabled
from ..models.mmctm import MMCTMConfig, init_with_alpha
from . import restarts as restarts_mod

__all__ = [
    "make_mesh",
    "sharded_fit_restarts",
    "shmap_fit_restarts",
    "sharded_data_parallel_fit",
    "dryrun_multichip",
]


def _with_kernel_gate(config, devices):
    """`config` with force_fused decided for a program over `devices`."""
    return dataclasses.replace(
        config,
        force_fused=fused_lambda_enabled(config.MK, config.dtype, devices),
    )


def make_mesh(
    n_restart: int, n_data: int, devices: Optional[Sequence] = None
) -> Mesh:
    """A ("restart", "data") mesh over the given (or all) devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if devices.size < n_restart * n_data:
        raise ValueError(
            f"need {n_restart * n_data} devices, have {devices.size}"
        )
    grid = devices[: n_restart * n_data].reshape(n_restart, n_data)
    return Mesh(grid, axis_names=("restart", "data"))


def sharded_fit_restarts(
    mesh: Mesh,
    key: jax.Array,
    X,
    config: MMCTMConfig,
    alpha: jnp.ndarray,
    restarts: int,
    maxiter: int = 1000,
    tol: float = 1e-4,
):
    """fit_restarts with the restart axis sharded over mesh axis "restart"
    and documents sharded over "data". Lane fits are communication-free
    across restarts; within a lane, D-reductions all-reduce over "data"."""
    keys = jax.random.split(key, restarts)
    keys = jax.device_put(keys, NamedSharding(mesh, P("restart")))
    X = tuple(
        jax.device_put(Xm, NamedSharding(mesh, P("data", None))) for Xm in X
    )
    config = _with_kernel_gate(config, mesh.devices.flat)
    return restarts_mod.fit_restarts_from_keys(
        keys, X, config, alpha, maxiter=maxiter, tol=tol
    )


def shmap_fit_restarts(
    key: jax.Array,
    X,
    config: MMCTMConfig,
    alpha: jnp.ndarray,
    restarts: int,
    maxiter: int = 1000,
    tol: float = 1e-4,
    init_method: str = "random",
    devices: Optional[Sequence] = None,
):
    """Restart fan-out as an explicit per-device program: shard_map over a
    flat "restart" mesh, data replicated, zero collectives.

    This is the multi-device path that KEEPS the fused λ kernel: GSPMD
    cannot partition a `pallas_call`, so the GSPMD route
    (sharded_fit_restarts) drops to the XLA solver on >1 device — but
    restart fitting is embarrassingly parallel (the reference's only fan-out,
    run_mmctm.jl:99-111, shares nothing between workers), so each device can
    simply run the unpartitioned single-device program on its slice of lanes.
    The kernel gate is decided for one device of the mesh. Lanes pad to a
    multiple of the device count with duplicate keys (deduplicated on
    return).
    """
    from jax import shard_map

    devs = list(devices) if devices is not None else jax.devices()
    n = len(devs)
    mesh = Mesh(np.asarray(devs), axis_names=("restart",))
    cfg = _with_kernel_gate(config, devs[:1])

    R_pad = ((restarts + n - 1) // n) * n
    keys = jax.random.split(key, restarts)
    # pad by cycling (a single slice underfills when R_pad - restarts > restarts,
    # e.g. 3 restarts on an 8-device mesh); duplicates are dropped on return
    keys = jnp.take(keys, jnp.arange(R_pad) % restarts, axis=0)
    X = tuple(X)

    @partial(jax.jit, static_argnames=())
    def run(keys, alpha, *X):
        def local(keys_l, alpha_l, *X_l):
            def one(k):
                state = init_with_alpha(k, cfg, X_l, alpha_l, init_method)
                return mmctm_mod.fit(state, X_l, cfg, maxiter=maxiter, tol=tol)

            return jax.vmap(one)(keys_l)

        # check_vma off: replicated inputs (X, alpha) feed loop carries that
        # become restart-varying, which the automatic varying-axes check
        # rejects; lanes are fully independent and every output is varying
        # over "restart", so the check has nothing to protect here.
        return shard_map(
            local,
            mesh=mesh,
            in_specs=(P("restart"), P()) + tuple(P() for _ in X),
            out_specs=P("restart"),
            check_vma=False,
        )(keys, alpha, *X)

    result = run(keys, alpha, *X)
    if R_pad != restarts:
        result = jax.tree_util.tree_map(lambda x: x[:restarts], result)
    return result


def sharded_data_parallel_fit(
    mesh: Mesh,
    state,
    X,
    config: MMCTMConfig,
    maxiter: int = 100,
    tol: float = 1e-4,
):
    """Single-model fit with documents sharded across the full mesh.

    Document-side state (λ/ν/ζ/θ — leading axis D) shards over "data";
    global state (μ/Σ/γ) replicates. XLA turns the M-step's D-reductions
    into all-reduces over the data axis.
    """
    flat_devices = mesh.devices.reshape(-1)
    data_mesh = Mesh(flat_devices, axis_names=("data",))
    dshard = NamedSharding(data_mesh, P("data"))
    replicated = NamedSharding(data_mesh, P())

    X = tuple(jax.device_put(Xm, NamedSharding(data_mesh, P("data", None))) for Xm in X)
    config = _with_kernel_gate(config, flat_devices)
    state = state._replace(
        lam=jax.device_put(state.lam, NamedSharding(data_mesh, P("data", None))),
        nu=jax.device_put(state.nu, NamedSharding(data_mesh, P("data", None))),
        zeta=jax.device_put(state.zeta, NamedSharding(data_mesh, P("data", None))),
        lam_pre=jax.device_put(state.lam_pre, NamedSharding(data_mesh, P("data", None))),
        logw_pre=tuple(jax.device_put(w, replicated) for w in state.logw_pre),
        mu=jax.device_put(state.mu, replicated),
        Sigma=jax.device_put(state.Sigma, replicated),
        invSigma=jax.device_put(state.invSigma, replicated),
        gamma=tuple(jax.device_put(g, replicated) for g in state.gamma),
        Elnphi=tuple(jax.device_put(g, replicated) for g in state.Elnphi),
        alpha=jax.device_put(state.alpha, replicated),
    )
    return jax.jit(
        mmctm_mod.fit, static_argnames=("config", "maxiter", "tol")
    )(state, X, config, maxiter=maxiter, tol=tol)


def dryrun_multichip(n_devices: int) -> None:
    """Driver hook: build an n-device mesh, jit the FULL MMCTM training
    step with real restart+data shardings, run 2 CAVI iterations on tiny
    shapes, and assert NUMERICAL EQUALITY against the same fit on one
    device (not just finiteness).

    Exercises both parallel axes this model family has (SURVEY.md §2.8):
    restart-parallel (the reference's only fan-out), the shard_map
    per-device fan-out, data-parallel with XLA-inserted all-reduces for the
    M-step, and the vocab-sharded TP analogue — each checked allclose
    against the single-device run.
    """
    # The virtual CPU mesh (xla_force_host_platform_device_count) is the
    # supported way to validate sharding without hardware.
    devices = jax.devices("cpu")
    if len(devices) < n_devices:
        raise RuntimeError(
            f"dryrun needs {n_devices} CPU devices, have {len(devices)}; "
            "set XLA_FLAGS=--xla_force_host_platform_device_count="
            f"{n_devices} (or call via __graft_entry__.dryrun_multichip, "
            "which spawns a correctly-configured subprocess)"
        )
    devices = devices[:n_devices]
    n_restart = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_data = n_devices // n_restart
    mesh = make_mesh(n_restart, n_data, devices)

    # tiny flagship-shaped problem: 2 modalities, K=[2,2]; D and V scale
    # with the mesh so every sharded axis stays divisible (D by the full
    # flattened "data" mesh in sharded_data_parallel_fit, V by the flat
    # "vocab" mesh below)
    D = max(8, 2 * n_devices)
    V = max(8, n_devices)
    config = MMCTMConfig(K=(2, 2), V=(V, V), D=D, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    X = tuple(
        jnp.asarray(rng.integers(0, 5, size=(config.D, V)), jnp.float32)
        for V in config.V
    )
    alpha = jnp.asarray([0.1, 0.1], jnp.float32)
    R = 2 * n_restart

    keys = jax.random.split(jax.random.key(0), R)
    keys = jax.device_put(keys, NamedSharding(mesh, P("restart")))
    Xs = tuple(jax.device_put(Xm, NamedSharding(mesh, P("data", None))) for Xm in X)

    def training_step(keys, X):
        def one(k):
            state = init_with_alpha(k, config, X, alpha)
            return mmctm_mod.fit(state, X, config, maxiter=2, tol=1e-4)

        return jax.vmap(one)(keys)

    result = jax.jit(training_step)(keys, Xs)
    ll = np.asarray(result.ll)
    assert ll.shape == (R, 2), ll.shape
    assert np.all(np.isfinite(ll)), ll

    # NUMERICAL EQUALITY, not just liveness: the
    # same 2-CAVI-iteration training step on unsharded single-device inputs
    # must agree with the mesh-sharded run — the psum'd M-step reductions
    # and the sharded E-step may reorder f32 sums but cannot change the
    # math. Reference analogue: pmap result equivalence,
    # scripts/run_mmctm.jl:101-107.
    result_ref = jax.jit(training_step)(
        jax.device_put(keys, devices[0]),
        tuple(jax.device_put(Xm, devices[0]) for Xm in X),
    )
    np.testing.assert_allclose(
        ll, np.asarray(result_ref.ll), rtol=2e-4, atol=1e-5,
        err_msg="restart+data-sharded fit diverged from single-device fit",
    )
    np.testing.assert_allclose(
        np.asarray(result.state.lam), np.asarray(result_ref.state.lam),
        rtol=2e-3, atol=1e-4,
        err_msg="sharded λ state diverged from single-device fit",
    )

    # explicit per-device restart fan-out (the multi-device path that keeps
    # the fused λ kernel on GPUs; XLA solver on the CPU mesh): lanes must
    # match the single-device vmapped fit up to f32 rounding
    result_sm = shmap_fit_restarts(
        jax.random.key(0), X, config, alpha, restarts=R, maxiter=2,
        devices=devices,
    )
    def one_ref(k):
        state = init_with_alpha(k, config, X, alpha)
        return mmctm_mod.fit(state, X, config, maxiter=2, tol=1e-4)
    result_sm_ref = jax.jit(jax.vmap(one_ref))(
        jax.random.split(jax.random.key(0), R)
    )
    np.testing.assert_allclose(
        np.asarray(result_sm.ll), np.asarray(result_sm_ref.ll),
        rtol=2e-4, atol=1e-5,
        err_msg="shard_map restart fan-out diverged from vmapped fit",
    )

    # data-parallel single fit over the full mesh == the same fit unsharded
    state = init_with_alpha(jax.random.key(1), config, X, alpha)
    result2 = sharded_data_parallel_fit(mesh, state, X, config, maxiter=2)
    result2_ref = jax.jit(
        mmctm_mod.fit, static_argnames=("config", "maxiter", "tol")
    )(state, X, config, maxiter=2)
    np.testing.assert_allclose(
        np.asarray(result2.ll), np.asarray(result2_ref.ll),
        rtol=2e-4, atol=1e-5,
        err_msg="data-parallel fit diverged from single-device fit",
    )

    # family best-of-N fan-out (fit_lda_restarts devices=...): the family
    # runners' shard_map path must agree with the plain vmapped fit
    from .restarts import fit_lda_restarts

    docs = [
        [np.array([v + 1, int(X[0][d, v])]) for v in range(config.V[0])
         if X[0][d, v] > 0]
        for d in range(min(D, 8))
    ]
    kwf = dict(restarts=2 * n_devices, maxiter=2, tol=1e-4, seed=5)
    fam_plain = fit_lda_restarts(2, 0.1, 0.1, docs, **kwf)
    fam_shard = fit_lda_restarts(2, 0.1, 0.1, docs, devices=devices, **kwf)
    np.testing.assert_allclose(
        fam_plain.ll, fam_shard.ll, rtol=2e-4,
        err_msg="family shard_map fan-out diverged from vmapped fit",
    )

    # vocab-sharded fit (the TP analog — SURVEY.md §2.8: shard the V axis of
    # counts/γ; XLA all-reduces the V-contractions in the M-step)
    flat = Mesh(np.asarray(devices).reshape(-1), axis_names=("vocab",))
    Xv = tuple(
        jax.device_put(Xm, NamedSharding(flat, P(None, "vocab"))) for Xm in X
    )
    state_v = state._replace(
        gamma=tuple(
            jax.device_put(g, NamedSharding(flat, P(None, "vocab")))
            for g in state.gamma
        ),
        Elnphi=tuple(
            jax.device_put(g, NamedSharding(flat, P(None, "vocab")))
            for g in state.Elnphi
        ),
    )
    result3 = jax.jit(
        mmctm_mod.fit, static_argnames=("config", "maxiter", "tol")
    )(state_v, Xv, config, maxiter=2)
    np.testing.assert_allclose(
        np.asarray(result3.ll), np.asarray(result2_ref.ll),
        rtol=2e-4, atol=1e-5,
        err_msg="vocab-sharded fit diverged from single-device fit",
    )
