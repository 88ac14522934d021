"""Example: large-scale multi-restart fitting with pilot-derived compaction.

The production workflow for reference-CLI-default scale (1000 restarts,
run_mmctm.jl:52) and beyond:

1. run a small PILOT fit (or reuse stage-1 diagnostics) to measure the
   iteration-to-convergence distribution of this dataset/tolerance;
2. `suggest_compact_schedule` turns that distribution into compaction
   boundaries by exact DP (cost model: lane-iterations with power-of-two
   survivor bucketing plus a per-boundary round-trip charge; up to 3
   boundaries by default);
3. fit the full restart fleet with `compact_schedule=...` — converged
   lanes are compacted out on device instead of idling until the slowest
   straggler finishes (bit-identical results on CPU, f32-rounding-
   equivalent on the GPU).

    python examples/large_scale.py [--restarts N] [--pilot N]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp

from multimodalmusig_tpu.models.mmctm import MMCTMConfig
from multimodalmusig_tpu.parallel.restarts import (
    auto_compact_schedule,
    fit_restarts,
    pick_optimal_modality_restarts,
)
from multimodalmusig_tpu.utils.fast_tsv import read_counts_tsv
from multimodalmusig_tpu.utils.data import brca_data_dir


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", default=None,
        help="counts directory (default: the bundled data/ TSVs)")
    ap.add_argument("--restarts", type=int, default=1000)
    ap.add_argument("--pilot", type=int, default=64)
    ap.add_argument("--tol", type=float, default=1e-5)
    args = ap.parse_args()
    if args.data_dir is None:
        args.data_dir = brca_data_dir()

    X = []
    for fname in ("brca-eu_snv_counts.tsv", "brca-eu_sv_counts.tsv"):
        counts, _, _ = read_counts_tsv(os.path.join(args.data_dir, fname))
        X.append(jnp.asarray(counts.T, jnp.float32))  # (D, V)
    config = MMCTMConfig(
        K=(7, 7), V=tuple(x.shape[1] for x in X), D=X[0].shape[0],
        dtype=jnp.float32,
    )
    alpha = jnp.asarray([0.1, 0.1], jnp.float32)

    # 1+2. pilot + schedule derivation in one call: fits a pilot fleet,
    # measures this device's lane-iterations/s (warm rerun, compile
    # excluded) and its boundary round-trip cost, then places boundaries by
    # exact DP. The CLI's --auto-compact runs exactly this.
    t0 = time.perf_counter()
    schedule, info = auto_compact_schedule(
        jax.random.key(42), tuple(X), config, alpha,
        restarts=args.restarts, maxiter=1000, tol=args.tol,
        pilot_restarts=args.pilot,
    )
    print(f"pilot: {info['pilot_restarts']} restarts "
          f"(p50={info['pilot_iters_median']:.0f} iters, "
          f"{info['lane_iters_per_s']:.0f} lane-iters/s) in "
          f"{time.perf_counter()-t0:.2f} s")
    print(f"suggested compact_schedule: {schedule} "
          f"(boundary {info['boundary_s']*1e3:.0f} ms = "
          f"{info['boundary_cost_lane_iters']:.0f} lane-iters)")

    # 3. the production fleet
    t0 = time.perf_counter()
    result = fit_restarts(
        jax.random.key(42), tuple(X), config, alpha,
        restarts=args.restarts, maxiter=1000, tol=args.tol,
        compact_schedule=schedule,  # () means "no boundary pays": unchunked
    )
    ll = np.asarray(result.ll)
    t = time.perf_counter() - t0
    best = np.asarray(pick_optimal_modality_restarts(result.ll))
    print(f"fleet: {args.restarts} restarts in {t:.2f} s "
          f"({args.restarts/t:.1f} restarts/s), "
          f"{int(np.isfinite(ll).all(axis=1).sum())}/{args.restarts} lanes finite")
    print(f"per-modality best ll: {[float(ll[best[m], m]) for m in range(2)]}")


if __name__ == "__main__":
    main()
