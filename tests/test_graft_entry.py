"""The driver entry points must always compile and run — this gap let a
refactor break entry() without any test noticing."""

import jax
import numpy as np

import __graft_entry__ as graft


def test_entry_compiles_and_runs():
    fn, args = graft.entry()
    state, ll = jax.jit(fn)(*args)
    ll = np.asarray(ll)
    assert ll.shape == (2,)
    assert np.all(np.isfinite(ll))


def test_dryrun_multichip():
    # the driver hook: spawns a CPU child with 8 virtual devices
    graft.dryrun_multichip(8)


def test_dryrun_multichip_inprocess():
    # the underlying mesh dryrun, in this process's 8-device CPU mesh
    from multimodalmusig_tpu.parallel.sharding import dryrun_multichip

    dryrun_multichip(8)
