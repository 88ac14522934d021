"""Benchmark: R=100 MMCTM([7,7], α=0.1) restarts on the bundled BRCA-EU
SNV+SV cohort (560 samples; the reference README's flagship workload,
README.md:20-42), fitted to tol=1e-5 on the GPU with the zero-config
auto-compaction schedule, plus the R=1000 scale of the reference CLI.

Baseline = ONE restart of the reference's architecture, measured live on
this host's CPU: the reference is single-threaded Julia with per-document
NLopt solves (src/MMCTM.jl:457-494) and publishes no numbers (BASELINE.md),
and Julia is not in this image — so `tools/reference_proxy_bench.py`'s
faithful stand-in (per-document ragged θ updates + bound-constrained scipy
maximizations) gives seconds/CAVI-iteration, times the median iteration
count our converged restarts needed at tol=1e-5.

Prints the device line, then ONE JSON line:
  {"metric": "mmctm_restarts_per_sec_brca_tol1e-5", "value": R/t_gpu,
   "unit": "restarts/s", "vs_baseline": (R/t_gpu) x t_proxy_restart, ...}

Needs a GPU: with any other backend it exits non-zero and prints no result.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

RESTARTS = 100
R1000 = 1000
TOL = 1e-5
MAXITER = 1000
PROXY_ITERS = 2
METRIC = "mmctm_restarts_per_sec_brca_tol1e-5"


def load_counts_np():
    """(D,V) float32 numpy count matrices for SNV+SV (no JAX touched)."""
    from multimodalmusig_tpu.utils.data import brca_counts_path
    from multimodalmusig_tpu.utils.fast_tsv import read_counts_tsv

    rows = []
    for fname in ("brca-eu_snv_counts.tsv", "brca-eu_sv_counts.tsv"):
        counts, _, _ = read_counts_tsv(brca_counts_path(fname))
        rows.append(counts.T)  # (D, V)
    return rows


def measure_proxy_iteration_seconds(Xnp, iters=PROXY_ITERS):
    """Seconds per CAVI iteration of the reference-architecture proxy
    (tools/reference_proxy_bench.py) on this machine's CPU. NumPy/SciPy
    only — never touches JAX."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    import numpy as np
    from reference_proxy_bench import proxy_iteration

    from multimodalmusig_tpu.utils.formatting import make_count_matrix

    K = [7, 7]
    MK = sum(K)
    D = Xnp[0].shape[0]
    X = [
        [make_count_matrix(Xnp[m].T[:, d]) for d in range(D)]
        for m in range(len(Xnp))
    ]
    rng = np.random.default_rng(0)
    state = dict(
        lam=np.zeros((D, MK)),
        nu=np.ones((D, MK)),
        mu=np.zeros(MK),
        Sigma=np.eye(MK),
        invSigma=np.eye(MK),
        gamma=[
            rng.integers(1, 101, size=(K[m], Xnp[m].shape[1])).astype(float)
            for m in range(len(Xnp))
        ],
    )
    t0 = time.perf_counter()
    for _ in range(iters):
        state = proxy_iteration(X, K, state)
    return (time.perf_counter() - t0) / iters


def timed_fit(X, config, alpha, restarts):
    """(wall seconds of a warm fit, result, its lls): the first call
    compiles every executable the auto schedule needs, the second is timed."""
    import jax
    import numpy as np

    from multimodalmusig_tpu.parallel.restarts import fit_restarts_auto

    key = jax.random.key(147959412)
    kwargs = dict(restarts=restarts, maxiter=MAXITER, tol=TOL)
    np.asarray(fit_restarts_auto(key, X, config, alpha, **kwargs)[0].ll)
    t0 = time.perf_counter()
    result, _ = fit_restarts_auto(key, X, config, alpha, **kwargs)
    ll = np.asarray(result.ll)
    return time.perf_counter() - t0, result, ll


def run_benchmark():
    """The measurement itself, on the default (GPU) device."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from multimodalmusig_tpu.models.mmctm import MMCTMConfig

    Xnp = load_counts_np()
    D = Xnp[0].shape[0]
    config = MMCTMConfig(
        K=(7, 7), V=(Xnp[0].shape[1], Xnp[1].shape[1]), D=D, dtype=jnp.float32
    )
    alpha = jnp.asarray([0.1, 0.1], jnp.float32)
    X = tuple(jnp.asarray(x, jnp.float32) for x in Xnp)

    t_gpu, result, ll = timed_fit(X, config, alpha, RESTARTS)
    iters = np.asarray(result.n_iters)
    finite = np.isfinite(ll).all(axis=1)
    # dead lanes terminate early (truncated n_iters) and have NaN ll
    median_iters = int(np.median(iters[finite])) if finite.any() else int(np.median(iters))
    t1000, _, ll1000 = timed_fit(X, config, alpha, R1000)

    per_iter_proxy = measure_proxy_iteration_seconds(Xnp)
    t_ref_restart = per_iter_proxy * median_iters
    value = RESTARTS / t_gpu
    dev = jax.devices()[0]
    out = {
        "metric": METRIC,
        "value": round(value, 4),
        "unit": "restarts/s",
        "vs_baseline": round(value * t_ref_restart, 4),
        "r1000_restarts_per_sec": round(R1000 / t1000, 2),
        "r1000_wall_s": round(t1000, 3),
        "r1000_finite_lanes": int(np.isfinite(ll1000).all(axis=1).sum()),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    diag = (
        f"restarts={RESTARTS} t_gpu={t_gpu:.3f}s iters_median={median_iters} "
        f"finite_lanes={int(finite.sum())}/{RESTARTS} "
        f"best_ll={np.nanmax(np.where(np.isfinite(ll), ll, np.nan), axis=0)} "
        f"proxy_s_per_iter={per_iter_proxy:.2f} "
        f"t_ref_restart={t_ref_restart:.1f}s"
    )
    return out, diag


def main():
    from multimodalmusig_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    dev = jax.devices()[0]
    print(f"bench: device {dev.platform} {dev.device_kind} (count {len(jax.devices())})")
    if dev.platform != "gpu":
        print(f"bench: needs a GPU, found {dev.platform!r}", file=sys.stderr)
        return 1
    out, diag = run_benchmark()
    print(diag, file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
