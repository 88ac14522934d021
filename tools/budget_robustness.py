"""Do the f32 warm-start solver budgets hold on HARSHER geometry than they
were tuned on?

The capped budgets (ops/solvers.py: LAMBDA_NITER_F32_CAVI=3, polish=1,
nu=4, CG_F32_CAVI=4) were probed to their population-quality cliffs on
BRCA-EU and PCAWG-scale synthetic data only; a harsher dataset could silently degrade without error (the documented escape
hatch is CTMBaseConfig.lambda_n_iter / MUSIG_F32_FULL_BUDGETS). This probe
turns that caveat into a measurement: synthesize corpora deliberately
harsher than both tuning workloads along the axes the solvers care about —

  * logistic-normal (not Dirichlet) ground-truth mixing with a
    condition-number-controlled Σ (default cond 1e4; BRCA's fitted Σ sits
    near ~1e4, so this matches its worst and stresses the Jacobi-PCG
    directions the caps starve first),
  * larger joint topic space MK=24 (K=(12,12)) — above BRCA's 14, PCAWG's
    19, and the unrolled-Cholesky Σ⁻¹ threshold (20), so the cho_solve
    fallback path is what runs,
  * lognormal document totals (sigma=1.5: ~30x spread) — extreme Ndivζ
    scales across documents in the same batch,
  * sharper topics (Dirichlet 0.05) — more extreme Elnϕ / sumθ.

and fit R restarts under (a) the default capped f32 budgets and (b) the
full f32 budgets (n=7, polish=2, nu=8, cg=min(MK,10)), same keys. The caps
"hold" if the per-lane final-ll populations match within ~2 sem per
modality, the best-of-R values agree to ~1e-3 (equal-quality local optima
jitter ±1e-4 even on BRCA), and every lane is
finite in both arms.

Run (GPU):  python tools/budget_robustness.py
            python tools/budget_robustness.py --cond 1e6 --restarts 50
Prints the result as JSON.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
from multimodalmusig_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def synthesize_harsh(rng, D, V_list, K_list, cond, doc_sigma=1.5, topic_conc=0.05,
                     mean_log_n=(6.5, 4.5)):
    """Logistic-normal corpus with ill-conditioned cross-modality Σ."""
    import numpy as np

    MK = sum(K_list)
    # Σ with spectrum logspace(0, -log10(cond)) under a random rotation:
    # every direction pair is correlated, none axis-aligned.
    Q, _ = np.linalg.qr(rng.standard_normal((MK, MK)))
    eig = np.logspace(0.0, -np.log10(cond), MK)
    Sigma = (Q * eig) @ Q.T
    L = np.linalg.cholesky(Sigma)
    eta = rng.standard_normal((D, MK)) @ L.T  # (D, MK), μ = 0

    X = []
    off = 0
    for V, K, mln in zip(V_list, K_list, mean_log_n):
        topics = rng.dirichlet(np.full(V, topic_conc), size=K)  # (K, V)
        block = eta[:, off:off + K]
        off += K
        props = np.exp(block - block.max(axis=1, keepdims=True))
        props /= props.sum(axis=1, keepdims=True)
        P = props @ topics
        N = np.ceil(np.exp(rng.normal(mln, doc_sigma, size=D))).astype(int)
        N = np.clip(N, 1, None)
        counts = np.stack([rng.multinomial(n, p) for n, p in zip(N, P)])
        X.append(counts.astype(np.float32))
    return X


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=600)
    ap.add_argument("--restarts", type=int, default=50)
    ap.add_argument("--cond", type=float, default=1e4)
    ap.add_argument("--K", type=int, nargs="+", default=[12, 12])
    ap.add_argument("--V", type=int, nargs="+", default=[96, 48])
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--maxiter", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax


    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    import numpy as np

    from multimodalmusig_tpu.models.mmctm import MMCTMConfig
    from multimodalmusig_tpu.parallel.restarts import fit_restarts

    K, V = tuple(args.K), tuple(args.V)
    MK = sum(K)
    rng = np.random.default_rng(args.seed)
    Xnp = synthesize_harsh(rng, args.docs, V, K, args.cond)
    X = tuple(jnp.asarray(x) for x in Xnp)
    base = MMCTMConfig(K=K, V=V, D=args.docs, dtype=jnp.float32)
    alpha = jnp.full((len(K),), 0.1, dtype=jnp.float32)
    key = jax.random.key(20260819)

    arms = {
        "capped_default": base,  # solve_eta resolves the tuned f32 caps
        "full_budgets": dataclasses.replace(
            base, lambda_n_iter=7, lambda_polish_iter=2, nu_n_iter=8,
            lambda_cg_iter=min(MK, 10),
        ),
    }

    def timed(cfg):
        t0 = time.perf_counter()
        r = fit_restarts(key, X, cfg, alpha, restarts=args.restarts,
                         maxiter=args.maxiter, tol=args.tol)
        ll = np.asarray(r.ll, dtype=np.float64)  # device_get = the barrier
        return time.perf_counter() - t0, r, ll

    for cfg in arms.values():  # compile + warm every arm first
        timed(cfg)

    out = {"platform": jax.devices()[0].platform, "docs": args.docs,
           "restarts": args.restarts, "K": list(K), "V": list(V),
           "cond": args.cond, "tol": args.tol, "seed": args.seed}
    stats = {}
    for name, cfg in arms.items():
        walls = []
        for _ in range(3):
            t, r, ll = timed(cfg)
            walls.append(round(t, 3))
        it = np.asarray(r.n_iters)
        fin = np.isfinite(ll).all(axis=1)
        stats[name] = ll
        out[name] = {
            "wall_s": walls,
            "finite": int(fin.sum()),
            "iters_median": int(np.median(it)), "iters_max": int(it.max()),
            "best_ll": [float(v) for v in ll[fin].max(axis=0)],
            "mean_ll": [float(v) for v in ll[fin].mean(axis=0)],
            "sem_ll": [float(v) for v in ll[fin].std(axis=0) / np.sqrt(max(fin.sum(), 1))],
        }

    a, b = stats["capped_default"], stats["full_budgets"]
    fin = np.isfinite(a).all(axis=1) & np.isfinite(b).all(axis=1)
    sem = np.maximum(a[fin].std(axis=0), b[fin].std(axis=0)) / np.sqrt(max(fin.sum(), 1))
    mean_gap = a[fin].mean(axis=0) - b[fin].mean(axis=0)
    best_gap = a[fin].max(axis=0) - b[fin].max(axis=0)
    out["verdict"] = {
        "mean_gap_per_modality": [float(v) for v in mean_gap],
        "gap_in_sems": [float(v) for v in mean_gap / np.maximum(sem, 1e-30)],
        "best_gap_per_modality": [float(v) for v in best_gap],
        # One-sided: the caps fail only when the capped arm is WORSE —
        # mean more than 2 sem below the full-budget arm, best-of-R more
        # than the measured local-optima jitter below it, or lanes lost.
        "caps_hold": bool(
            np.all(mean_gap >= -2.0 * sem)
            and np.all(best_gap >= -2e-3)
            and int(np.isfinite(a).all(axis=1).sum()) == int(np.isfinite(b).all(axis=1).sum())
        ),
    }
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
