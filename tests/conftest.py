"""Test configuration: CPU backend with 8 virtual devices, float64 enabled.

Multi-device sharding tests run on a virtual CPU mesh
(xla_force_host_platform_device_count), the pattern recommended for testing
jax.sharding code without real multi-chip hardware. float64 is enabled for
numerical-parity tests against the (Float64 CPU) Julia reference semantics.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Pin this process (and every subprocess a test spawns) to the CPU backend
# with 8 virtual devices, before any backend initializes. The `gpu`-marked
# tests run on the card with MUSIG_TEST_PLATFORMS=cuda,cpu (README
# "Testing"); every other test still defaults to the CPU device.
_PLATFORMS = os.environ.get("MUSIG_TEST_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = _PLATFORMS

import jax  # noqa: E402

jax.config.update("jax_platforms", _PLATFORMS)
jax.config.update("jax_enable_x64", True)
# Persistent compilation cache OFF for the whole suite: jaxlib 0.9.0's
# XLA:CPU executable (de)serializer segfaults on this suite's programs —
# observed in put_executable_and_time (oracle module, large f64 programs)
# and later in get_executable_and_time on ordinary cache reads
# (test_solvers, after ~230 in-process compiles). The cache is a warm-run
# optimization only; compiling fresh is slower but cannot crash there.
# (Disable explicitly: JAX_COMPILATION_CACHE_DIR may have enabled it.)
jax.config.update("jax_enable_compilation_cache", False)
jax.config.update("jax_default_device", jax.devices("cpu")[0])

import numpy as np  # noqa: E402
import pytest  # noqa: E402


# Bundled BRCA-EU data: shipped in-repo under data/ (BSD-2, same files the
# reference bundles), with the read-only upstream mount as fallback — a bare
# clone runs the real-data tests. The skip guard remains for stripped
# checkouts without the data directory.
from multimodalmusig_tpu.utils.data import brca_data_dir  # noqa: E402

BRCA_DATA_DIR = brca_data_dir()
requires_brca_data = pytest.mark.skipif(
    not os.path.isfile(os.path.join(BRCA_DATA_DIR, "brca-eu_snv_counts.tsv")),
    reason="BRCA-EU data not present (stripped checkout)",
)


def pytest_collection_modifyitems(config, items):
    """Run the trajectory-oracle module FIRST. XLA:CPU (jaxlib 0.9.0)
    segfaults in backend_compile_and_load when this suite's largest (f64
    IMMCTM transform/heldout) programs compile after ~230 prior compilations
    in one process; the same module is green standalone and in tail subsets.
    Fronting the big compiles while the in-process compiler state is fresh
    sidesteps the crash; the many small fixture compiles that follow are
    unaffected. Under xdist --dist loadfile the reorder also hands this
    heaviest file to the first worker up front, and the per-worker split
    keeps every process comfortably under the crash threshold."""
    front = [it for it in items if "test_trajectory_oracle" in it.nodeid]
    rest = [it for it in items if "test_trajectory_oracle" not in it.nodeid]
    items[:] = front + rest


@pytest.fixture
def rng():
    return np.random.default_rng(12345)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none. Decided
    here, at test time, never while a module is imported."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU (MUSIG_TEST_PLATFORMS=cuda,cpu)")


# ---------------------------------------------------------------------------
# Shared fixtures: the reference's hand-computed tiny corpora
# (test/lda.jl:4-16, test/mmctm.jl:4-33, test/ilda.jl:4-22, test/immctm.jl:6-51)
# ---------------------------------------------------------------------------


@pytest.fixture
def lda_fixture():
    """K=2, α=0.1, η=0.1, 2 docs over a 2-term vocab (test/lda.jl:4-16)."""
    X = [
        np.array([[1, 5], [2, 8]]),
        np.array([[1, 2], [2, 5]]),
    ]
    return dict(K=2, alpha=0.1, eta=0.1, X=X)


@pytest.fixture
def mmctm_fixture():
    """K=[2,3], α=[0.1,0.1], 2 docs x 2 modalities (test/mmctm.jl:4-33)."""
    X = [
        [np.array([[1, 5], [2, 8]]), np.array([[1, 2], [2, 5]])],
        [np.array([[3, 4], [4, 9]]), np.array([[3, 4], [4, 6]])],
    ]
    return dict(K=[2, 3], alpha=[0.1, 0.1], X=X)
