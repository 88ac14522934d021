"""PCAWG-scale benchmark: ~2800 samples x 3
modalities (SNV/SV/indel-shaped vocabularies), K=(7,7,5), R vmapped restarts.

The PCAWG cohort itself is not bundled, so the corpus is synthesized at the
published scale: documents drawn from a ground-truth topic mixture over the
same vocabulary sizes as the bundled BRCA-EU data (96-term SNV, 48-term SV)
plus an indel-like 24-term modality, with per-document total counts matching
the BRCA-EU empirical scale. Measures wall-clock, CAVI iterations/sec at
full (R, D) batch, and restarts/hour.

Run (GPU):   python tools/pcawg_bench.py --restarts 100
Run (CPU):   python tools/pcawg_bench.py --cpu --restarts 4 --docs 512
Prints one JSON object {"metric": "pcawg_scale_fit", ...}.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
from multimodalmusig_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def synthesize_corpus(rng, D, V_list, K_list, mean_counts=(3000, 250, 120)):
    """Topic-model-distributed synthetic counts at PCAWG scale."""
    import numpy as np

    X = []
    for V, K, mean_n in zip(V_list, K_list, mean_counts):
        topics = rng.dirichlet(np.full(V, 0.3), size=K)  # (K, V)
        props = rng.dirichlet(np.full(K, 0.5), size=D)   # (D, K)
        P = props @ topics
        N = rng.poisson(mean_n, size=D)
        counts = np.stack([rng.multinomial(n, p) for n, p in zip(N, P)])
        X.append(counts.astype(np.float32))
    return X


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=2800)
    ap.add_argument("--restarts", type=int, default=100)
    ap.add_argument("--maxiter", type=int, default=1000)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--chunk-iters", type=int, default=0,
                    help="0 = unchunked single-execution fit")
    ap.add_argument("--compact-at", type=int, nargs="+", default=None,
                    help="2-phase straggler compaction budgets (see "
                    "fit_restarts compact_schedule)")
    ap.add_argument("--auto", action="store_true",
                    help="zero-config folded-pilot auto compaction "
                    "(fit_restarts_auto)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    import numpy as np

    from multimodalmusig_tpu.models.mmctm import MMCTMConfig
    from multimodalmusig_tpu.parallel.restarts import (
        fit_restarts,
        fit_restarts_auto,
    )

    K = (7, 7, 5)
    V = (96, 48, 24)
    rng = np.random.default_rng(0)
    Xnp = synthesize_corpus(rng, args.docs, V, K)
    config = MMCTMConfig(K=K, V=V, D=args.docs, dtype=jnp.float32)
    X = tuple(jnp.asarray(x) for x in Xnp)
    alpha = jnp.asarray([0.1, 0.1, 0.1], jnp.float32)
    key = jax.random.key(7)

    kwargs = dict(
        restarts=args.restarts, maxiter=args.maxiter, tol=args.tol,
        chunk_iters=args.chunk_iters or None,
        compact_schedule=tuple(args.compact_at) if args.compact_at else None,
    )
    if args.auto:
        if args.compact_at or args.chunk_iters:
            raise SystemExit(
                "--auto is mutually exclusive with --compact-at/--chunk-iters")

        def fit_restarts(key, X, config, alpha, restarts, maxiter, tol,
                         chunk_iters=None, compact_schedule=None):
            r, info = fit_restarts_auto(
                key, X, config, alpha, restarts=restarts,
                maxiter=maxiter, tol=tol)
            print("auto schedule:", info["schedule"], file=sys.stderr)
            return r
    platform = jax.devices()[0].platform
    print(f"platform={platform} D={args.docs} R={args.restarts} K={K} V={V}",
          file=sys.stderr)

    # warm (compiles every bucket the compacted driver will use)
    t0 = time.perf_counter()
    np.asarray(fit_restarts(key, X, config, alpha, **kwargs).ll)
    t_warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    result = fit_restarts(key, X, config, alpha, **kwargs)
    ll = np.asarray(result.ll)
    t = time.perf_counter() - t0
    iters = np.asarray(result.n_iters)
    total_iters = int(iters.sum())

    out = {
        "metric": "pcawg_scale_fit",
        "platform": platform,
        "D": args.docs,
        "restarts": args.restarts,
        "K": list(K),
        "V": list(V),
        "tol": args.tol,
        "wall_clock_s": round(t, 3),
        "warm_run_s": round(t_warm, 3),
        "restart_iters_per_s": round(total_iters / t, 2),
        "restarts_per_hour": round(args.restarts / t * 3600, 1),
        "iters_median": int(np.median(iters)),
        "iter_percentiles": {
            str(p): int(np.percentile(iters, p)) for p in (50, 75, 90, 95, 100)
        },
        "compact_at": "auto" if args.auto else args.compact_at,
        "best_ll": [float(v) for v in ll.max(axis=0)],
        "all_finite": bool(np.isfinite(ll).all()),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
