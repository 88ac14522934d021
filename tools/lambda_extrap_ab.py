"""A/B the secant-extrapolated λ warm start (CTMBaseConfig.lambda_extrap)
against the Newton budget on the BRCA/PCAWG restart fits.

Hypothesis: the CAVI iteration is bound by the sequential λ Newton/PCG
dependency chain, and the warm-start quality — not the concavity — is
what the 3rd Newton step buys. A secant predictor λ_t + c·(λ_t − λ_{t-1})
starts the solve closer to the optimum, so Newton n=2 (one fewer
sequential step) may hold the population-level quality that plain n=2
measurably loses (lambda_budget_r4: n=2 wiggles PCAWG's 3rd modality 3e-5).

Methodology = tools/cg_budget_ab.py: lambda_n_iter/lambda_extrap are
static jit args (fields of the frozen config), so same-process arms are
sound; arms interleave over reps so device drift cancels; quality gates
are population mean/sd/sem of per-lane final ll (equal-quality local
optima match in distribution, not per lane) plus best-of-N ll and the
outer-iteration distribution.

    python tools/lambda_extrap_ab.py                 # BRCA R=100 default arms
    python tools/lambda_extrap_ab.py --restarts 1000
    python tools/lambda_extrap_ab.py --pcawg --restarts 100
    python tools/lambda_extrap_ab.py 3:None 2:None 2:1.0   # explicit n:c arms
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


def parse_arm(s):
    n, c = s.split(":")
    return (None if n == "None" else int(n), None if c == "None" else float(c))


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
        dtype=jnp.float32,
    )
    X = tuple(jnp.asarray(x, jnp.float32) for x in Xnp)
    alpha = jnp.asarray(alpha_list, jnp.float32)
    key = jax.random.key(147959412)
    # default arms: pinned baseline (n=3 via None), plain n=2 (the known
    # borderline), and n=2 with secant coefficients around the geometric
    # convergence ratio
    arms = [parse_arm(a) for a in (argv or ["None:None", "2:None", "2:0.5", "2:1.0", "3:1.0"])]

    def timed(arm):
        n, c = arm
        cfg = dataclasses.replace(base, lambda_n_iter=n, lambda_extrap=c)
        t0 = time.perf_counter()
        r = fit_restarts(key, X, cfg, alpha, restarts=restarts, maxiter=1000, tol=1e-5)
        ll = np.asarray(r.ll)
        return time.perf_counter() - t0, r, ll

    for arm in arms:  # compile every arm first
        timed(arm)
    results = {str(arm): [] for arm in arms}
    last = {}
    for _ in range(3):
        for arm in arms:
            t, r, ll = timed(arm)
            results[str(arm)].append(round(t, 3))
            last[str(arm)] = (r, ll)
    for arm in arms:
        r, ll = last[str(arm)]
        it = np.asarray(r.n_iters)
        fin = np.isfinite(ll).all(axis=1)
        print(json.dumps({
            "n_iter": arm[0], "extrap": arm[1], "wall_s": results[str(arm)],
            "iters_median": int(np.median(it)), "iters_max": int(it.max()),
            "finite": int(fin.sum()),
            "best_ll": [float(v) for v in ll.max(axis=0)],
            "mean_ll": [float(v) for v in ll[fin].mean(axis=0)],
            "sd_ll": [float(v) for v in ll[fin].std(axis=0)],
            "sem_ll": [float(v) for v in ll[fin].std(axis=0) / np.sqrt(fin.sum())],
        }))


if __name__ == "__main__":
    main(sys.argv[1:])
