"""Marginal per-component cost of the MMCTM CAVI iteration, measured by
ablation: time the REAL fit step (fixed iteration count, capped in-loop
budgets, fused-λ gate as production resolves it) with one component removed
at a time. Unlike timing components in
isolation, where per-dispatch overheads and missing fusion distort the
numbers — the difference full − ablated is the component's true marginal
cost inside the compiled loop.

Also microbenchmarks raw exp/log throughput at the iteration's own
tensor sizes (measure, don't assert, the transcendental floor) so the ll's log bill can be compared to its speed-of-light.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from multimodalmusig_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax
import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--restarts", type=int, default=100)
    ap.add_argument("--chain", type=int, default=60)
    args = ap.parse_args()
    R, CH = args.restarts, args.chain

    from bench import load_counts_np
    from multimodalmusig_tpu.models import mmctm as mmod
    from multimodalmusig_tpu.models.ctm_base import counts_per_doc, solve_eta
    from multimodalmusig_tpu.models.mmctm import MMCTMConfig, init_with_alpha

    Xnp = load_counts_np()
    config = MMCTMConfig(
        K=(7, 7), V=(Xnp[0].shape[1], Xnp[1].shape[1]), D=Xnp[0].shape[0],
        dtype=jnp.float32,
    )
    X = tuple(jnp.asarray(x, jnp.float32) for x in Xnp)
    alpha = jnp.asarray([0.1, 0.1], jnp.float32)
    keys = jax.random.split(jax.random.key(0), R)
    states = jax.vmap(lambda k: init_with_alpha(k, config, X, alpha))(keys)
    N = counts_per_doc(X)

    real_step = mmod.fit_step_fn(X, N, config)
    warm = jax.jit(jax.vmap(lambda s: jax.lax.fori_loop(
        0, 20, lambda _, c: real_step(c[0]),
        (s, jnp.zeros((config.M,), jnp.float32))
    )[0]))
    states = warm(states)
    jax.block_until_ready(states)

    def make_step(no_ll=False, no_sigma=False, no_mu=False, no_gamma=False,
                  no_eta=False):
        """The production step with single components ablated (the loop
        still carries/consumes everything so nothing is DCE'd)."""

        def step(s):
            if no_eta:
                # skip ζ/ν/λ solves but keep the θ moments the rest consumes
                _, scatters = mmod.e_step_moments(
                    s, X, N, config, want_scatter=True)
            else:
                s, scatters = mmod.e_step_moments(s, X, N, config)
            if not no_mu:
                s = mmod.update_mu(s)
            if not no_sigma:
                s = mmod.update_Sigma(s, config)
            if not no_gamma:
                s = mmod.update_gamma(s, X, config, scatter=scatters)
            if no_ll:
                ll_i = s.lam[0, : config.M] * 1e-20
            else:
                ll_i = mmod.modality_loglikelihoods(
                    X, mmod.props_from(s.lam, config),
                    mmod.phi_point(s.gamma))
            return s, ll_i

        return step

    def timed(label, step):
        @jax.jit
        def run(states):
            def one(s):
                return jax.lax.fori_loop(
                    0, CH, lambda _, c: step(c[0]),
                    (s, jnp.zeros((config.M,), jnp.float32)))

            return jax.vmap(one)(states)

        out = run(states)
        jax.block_until_ready(out)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(run(states))
            best = min(best, time.perf_counter() - t0)
        print(f"  {label:<22s} {best / CH * 1e3:8.3f} ms/iter")
        return best / CH

    print(f"platform={jax.devices()[0].platform} R={R} chain={CH}")
    full = timed("full step", make_step())
    for name, kw in [
        ("no ll", dict(no_ll=True)),
        ("no Sigma", dict(no_sigma=True)),
        ("no mu+Sigma", dict(no_sigma=True, no_mu=True)),
        ("no gamma+Elnphi", dict(no_gamma=True)),
        ("no eta solves", dict(no_eta=True)),
    ]:
        t = timed(name, make_step(**kw))
        print(f"    -> marginal {name[3:]:<18s} {(full - t) * 1e3:8.3f} ms")

    # raw transcendental throughput at the ll's own shapes
    cells = R * config.D * sum(config.V)
    big = jnp.asarray(
        np.random.default_rng(0).uniform(0.1, 2.0, (R, config.D, sum(config.V))),
        jnp.float32)

    def raw(label, fn):
        @jax.jit
        def run(x):
            def body(i, acc):
                return acc * 0.0 + jnp.sum(fn(x + acc * 1e-30))

            return jax.lax.fori_loop(0, CH, body, jnp.float32(0.0))

        jax.block_until_ready(run(big))
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(run(big))
            best = min(best, time.perf_counter() - t0)
        per = best / CH
        print(f"  raw {label:<10s} {per * 1e3:8.3f} ms for {cells/1e6:.1f}M cells "
              f"= {cells / per / 1e9:.1f} G{label}/s")
        return per

    raw("log", jnp.log)
    raw("exp", jnp.exp)
    raw("mul+sum", lambda x: x * 1.0000001)
    raw("xlogy", lambda x: x * jnp.log(x))


if __name__ == "__main__":
    main()
