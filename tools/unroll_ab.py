"""A/B the solver inner-loop unrolling (ops/solvers.py `_loop`) on the device.

Hypothesis: XLA While ops are fusion barriers whose loop carries round-trip
device memory every iteration; at the f32 warm-start budgets (Newton 3 x
CG 4 + polish, nu 4+4) the trip counts are tiny and static, so unrolling
into one straight-line graph might win. Results are bit-identical between
arms; only the schedule differs.

`unroll` is a static jit argument, so both arms are distinct executables —
same-process A/B is sound.

    python tools/unroll_ab.py [--restarts R] [--reps N]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from multimodalmusig_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--restarts", type=int, default=100)
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from multimodalmusig_tpu.ops.solvers import maximize_lambda, maximize_nu

    MK = 14
    B = args.restarts * 560
    rng = np.random.default_rng(0)

    # BRCA-like magnitudes: lam near optimum (warm start), nu ~ 1e-2..1,
    # Ndivzeta ~ N/zeta with N ~ 1e3..1e4, invSigma cond ~ 1e3.
    A = rng.standard_normal((MK, MK))
    Sigma = A @ A.T / MK + np.diag(np.linspace(0.05, 1.0, MK))
    invS = np.linalg.inv(Sigma)
    lam = rng.standard_normal((B, MK)) * 0.5
    nu = np.abs(rng.standard_normal((B, MK))) * 0.1 + 1e-3
    Ndz = np.abs(rng.standard_normal((B, MK))) * 50 + 1.0
    st = np.abs(rng.standard_normal((B, MK))) * 30
    mu = rng.standard_normal(MK) * 0.3

    def arms(dtype, n_iter, cg_iter, polish_iter, nu_n):
        cast = lambda x: jnp.asarray(x, dtype)
        a = dict(
            lam=cast(lam), nu=cast(nu), Ndz=cast(Ndz), st=cast(st),
            mu=cast(mu), invS=cast(invS),
        )
        out = {}
        for unroll in (False, True):
            f = lambda: maximize_lambda(
                a["lam"], a["nu"], a["Ndz"], a["st"], a["mu"], a["invS"],
                n_iter=n_iter, cg_iter=cg_iter, polish_iter=polish_iter,
                unroll=unroll,
            )
            g = lambda: maximize_nu(
                a["nu"], a["lam"], a["Ndz"], jnp.diagonal(a["invS"])[None, :],
                n_iter=nu_n, unroll=unroll,
            )
            for name, fn in (("lambda", f), ("nu", g)):
                np.asarray(fn())  # compile + warm
                t0 = time.perf_counter()
                for _ in range(args.reps):
                    r = fn()
                np.asarray(r)
                dt = (time.perf_counter() - t0) / args.reps
                out[f"{name}_unroll={unroll}"] = dt * 1e3
        return out

    print(f"platform={jax.default_backend()} B={B} MK={MK} reps={args.reps}")
    f32 = arms(jnp.float32, 3, 4, 1, 4)
    print("f32 CAVI budget (n=3 cg=4 polish=1, nu=4):")
    for k, v in f32.items():
        print(f"  {k:24s} {v:8.3f} ms")
    lf, lu = f32["lambda_unroll=False"], f32["lambda_unroll=True"]
    nf, nu_ = f32["nu_unroll=False"], f32["nu_unroll=True"]
    print(f"  lambda speedup {lf/lu:.3f}x   nu speedup {nf/nu_:.3f}x")

    f64 = {}
    if jax.config.read("jax_enable_x64"):
        f64 = arms(jnp.float64, 7, MK, 2, 8)
        print("f64 cold budget (n=7 cg=MK polish=2, nu=8):")
        for k, v in f64.items():
            print(f"  {k:24s} {v:8.3f} ms")

    # parity between arms (same arithmetic, different fusion)
    a32 = lambda u: maximize_lambda(
        jnp.asarray(lam, jnp.float32), jnp.asarray(nu, jnp.float32),
        jnp.asarray(Ndz, jnp.float32), jnp.asarray(st, jnp.float32),
        jnp.asarray(mu, jnp.float32), jnp.asarray(invS, jnp.float32),
        n_iter=3, cg_iter=4, polish_iter=1, unroll=u,
    )
    d = np.max(np.abs(np.asarray(a32(True)) - np.asarray(a32(False))))
    print(f"max |lambda(unroll) - lambda(fori)| = {d:.3e}")


if __name__ == "__main__":
    main()
