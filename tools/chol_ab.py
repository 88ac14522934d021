"""A/B the λ Newton-direction solver on the BRCA/PCAWG restart fit.

Arms (all static jit args → same-process interleaved arms are sound, as in
tools/cg_budget_ab.py):

    fused  — default path: Jacobi-PCG direction inside the fused λ kernel
    pcg    — XLA Jacobi-PCG (force_fused=False), cg budget CG_F32_CAVI
    chol   — XLA direct unrolled Cholesky (ops/solvers.py _chol_solve): the
             structurally different λ solver — no sequential CG chain, no MK-reductions, one
             elementwise DAG over the document batch, machine-exact
             directions.

    python tools/chol_ab.py [arm ...]            # default: fused pcg chol
    python tools/chol_ab.py --pcawg [arm ...]
    python tools/chol_ab.py --restarts N [arm ...]
    python tools/chol_ab.py --lambda-n N [arm ...]   # Newton budget override
"""

import dataclasses
import json
import os
import sys
import time

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
        argv = argv[:i] + argv[i + 2 :]
    lambda_n = None
    if "--lambda-n" in argv:
        i = argv.index("--lambda-n")
        lambda_n = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2 :]

    if pcawg:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from pcawg_bench import synthesize_corpus

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
        dtype=jnp.float32, lambda_n_iter=lambda_n,
    )
    X = tuple(jnp.asarray(x, jnp.float32) for x in Xnp)
    alpha = jnp.asarray(alpha_list, jnp.float32)
    key = jax.random.key(147959412)

    ARMS = {
        "fused": dict(),
        "pcg": dict(force_fused=False),
        "chol": dict(force_fused=False, lambda_solver="chol"),
    }
    arms = argv or ["fused", "pcg", "chol"]

    def timed(arm):
        cfg = dataclasses.replace(base, **ARMS[arm])
        t0 = time.perf_counter()
        r = fit_restarts(key, X, cfg, alpha, restarts=restarts, maxiter=1000,
                         tol=1e-5)
        ll = np.asarray(r.ll)
        return time.perf_counter() - t0, r, ll

    compile_s = {}
    for arm in arms:  # warm (compile) every arm first; record cold walls
        t0 = time.perf_counter()
        timed(arm)
        compile_s[arm] = round(time.perf_counter() - t0, 1)
    results = {arm: [] for arm in arms}
    last = {}
    for _ in range(3):  # interleave reps so device drift cancels
        for arm in arms:
            t, r, ll = timed(arm)
            results[arm].append(round(t, 3))
            last[arm] = (r, ll)
    for arm in arms:
        r, ll = last[arm]
        it = np.asarray(r.n_iters)
        fin = np.isfinite(ll).all(axis=1)
        print(json.dumps({
            "arm": arm, "wall_s": results[arm], "cold_wall_s": compile_s[arm],
            "iters_median": int(np.median(it)), "iters_max": int(it.max()),
            "finite": int(fin.sum()),
            "best_ll": [float(v) for v in ll.max(axis=0)],
            "mean_ll": [float(v) for v in ll[fin].mean(axis=0)],
            "sem_ll": [float(v) for v in ll[fin].std(axis=0) / np.sqrt(fin.sum())],
        }))


if __name__ == "__main__":
    main(sys.argv[1:])
