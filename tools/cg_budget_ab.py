"""A/B the lambda-solve inner CG budget (CG_ITER_F32_CAP) on the BRCA fit.

The round-3 measurements behind the f32 cap (ops/solvers.py): interleaved
repeated arms so device drift cancels. Config's lambda_cg_iter is a static
jit arg, so each value compiles its own executable — same-process A/B is
sound here (unlike the env-flag gates, which need subprocess arms).

    python tools/cg_budget_ab.py [cg ...]   # default arms: None(=capped), 14, 8
    python tools/cg_budget_ab.py --pcawg [cg ...]  # PCAWG-shaped corpus
    python tools/cg_budget_ab.py --restarts N [cg ...]
"""

import json
import os
import sys
import time
import dataclasses

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from multimodalmusig_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np


def main(argv):
    import jax
    import jax.numpy as jnp

    from bench import load_counts_np
    from multimodalmusig_tpu.models.mmctm import MMCTMConfig
    from multimodalmusig_tpu.parallel.restarts import fit_restarts

    pcawg = "--pcawg" in argv
    argv = [a for a in argv if a != "--pcawg"]
    restarts = 100
    if "--restarts" in argv:
        i = argv.index("--restarts")
        restarts = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    lambda_n = None
    if "--lambda-n" in argv:  # probe the Newton budget at a fixed cg
        i = argv.index("--lambda-n")
        lambda_n = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]

    if pcawg:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from pcawg_bench import synthesize_corpus

        # same corpus as tools/pcawg_bench.py (rng seed 0, published scale)
        Xnp = synthesize_corpus(
            np.random.default_rng(0), 2800, [96, 48, 24], [7, 7, 5]
        )
        K = (7, 7, 5)
        alpha_list = [0.1, 0.1, 0.1]
    else:
        Xnp = load_counts_np()
        K = (7, 7)
        alpha_list = [0.1, 0.1]
    base = MMCTMConfig(
        K=K, V=tuple(x.shape[1] for x in Xnp), D=Xnp[0].shape[0],
        dtype=jnp.float32,
    )
    X = tuple(jnp.asarray(x, jnp.float32) for x in Xnp)
    alpha = jnp.asarray(alpha_list, jnp.float32)
    key = jax.random.key(147959412)
    arms = [None if a == "None" else int(a) for a in (argv or ["None", "14", "8"])]

    def timed(cg):
        cfg = dataclasses.replace(base, lambda_cg_iter=cg, lambda_n_iter=lambda_n)
        kw = dict(restarts=restarts, maxiter=1000, tol=1e-5)
        t0 = time.perf_counter()
        r = fit_restarts(key, X, cfg, alpha, **kw)
        ll = np.asarray(r.ll)
        return time.perf_counter() - t0, r, ll

    for cg in arms:  # warm (compile) every arm first
        timed(cg)
    results = {str(cg): [] for cg in arms}
    last = {}
    for _ in range(3):  # interleave reps so device drift cancels
        for cg in arms:
            t, r, ll = timed(cg)
            results[str(cg)].append(round(t, 3))
            last[str(cg)] = (r, ll)
    for cg in arms:
        r, ll = last[str(cg)]  # stats from the final rep (no extra fit)
        it = np.asarray(r.n_iters)
        fin = np.isfinite(ll).all(axis=1)
        print(json.dumps({
            "cg": cg, "wall_s": results[str(cg)],
            "iters_median": int(np.median(it)), "iters_max": int(it.max()),
            "finite": int(fin.sum()),
            "best_ll": [float(v) for v in ll.max(axis=0)],
            # population quality: equal-quality optima under a looser inner
            # solve show as matching means/sds, not matching per-lane values
            "mean_ll": [float(v) for v in ll[fin].mean(axis=0)],
            "sd_ll": [float(v) for v in ll[fin].std(axis=0)],
            "sem_ll": [float(v) for v in ll[fin].std(axis=0) / np.sqrt(fin.sum())],
        }))


if __name__ == "__main__":
    main(sys.argv[1:])
