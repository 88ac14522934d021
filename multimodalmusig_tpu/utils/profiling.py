"""Tracing, profiling, and numerical-debugging utilities.

The reference's only observability is per-iteration `println` of
log-likelihoods gated by `verbose` (src/MMCTM.jl:481-483) and a progress bar
around the restart pmap (run_mmctm.jl:101-104). Here (SURVEY.md §5):

  * every FitResult carries the full ll trajectory, iteration count, and
    convergence flag — metrics come out of the jitted loop as arrays;
  * `trace(logdir)` wraps `jax.profiler` for XLA/GPU timeline capture,
    viewable in TensorBoard/Perfetto;
  * `debug_nans()` / `check_finite(tree)` for numerical debugging — races
    are structurally excluded (pure-functional updates), so the analogue of
    the reference's (absent) sanitizers is NaN/Inf detection.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["trace", "annotate", "debug_nans", "check_finite", "Timer"]


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture an XLA/GPU profiler trace of the enclosed block.

    View with TensorBoard (`tensorboard --logdir <logdir>`) or Perfetto.
    """
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named profiler span (shows up in the trace timeline)."""
    return jax.profiler.TraceAnnotation(name)


@contextlib.contextmanager
def debug_nans(enable: bool = True) -> Iterator[None]:
    """Enable jax_debug_nans within the block: any NaN-producing op raises
    immediately with the offending primitive (re-runs un-jitted)."""
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", enable)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


def check_finite(tree, name: str = "state") -> None:
    """Host-side finiteness assertion over an arbitrary pytree (e.g. a model
    state or FitResult). Raises FloatingPointError naming the bad leaf."""
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    for path, leaf in leaves:
        arr = np.asarray(leaf)
        if np.issubdtype(arr.dtype, np.floating) and not np.all(np.isfinite(arr)):
            bad = int(np.sum(~np.isfinite(arr)))
            raise FloatingPointError(
                f"{name}{jax.tree_util.keystr(path)}: {bad}/{arr.size} non-finite values"
            )


class Timer:
    """Wall-clock section timer that blocks on device results.

    >>> with Timer() as t:
    ...     np.asarray(model.fit(...))
    >>> t.elapsed
    """

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        return False
