"""Decompose the η-solve chain (ζ → ν → λ), the dominant per-iteration cost
(tools/iter_marginal.py: 1.16 of 1.76 ms at R=100 — the ll, γ, and μ/Σ
updates are marginal). Ablations run inside the REAL fit step at production
budgets; budget variants use the config's static solver fields and the
XLA-vs-fused-kernel arms use config.force_fused — both are jit-static, so all
arms are distinct executables in one process (unlike env-flag A/Bs, which
silently reuse the first arm's executable)."""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from multimodalmusig_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import dataclasses

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
    from multimodalmusig_tpu.models.ctm_base import (
        calculate_Ndivzeta,
        counts_per_doc,
        resolved_budgets,
        solve_lambda,
        update_zeta,
    )
    from multimodalmusig_tpu.models.mmctm import MMCTMConfig, init_with_alpha
    from multimodalmusig_tpu.ops.solvers import maximize_nu

    Xnp = load_counts_np()
    base = MMCTMConfig(
        K=(7, 7), V=(Xnp[0].shape[1], Xnp[1].shape[1]), D=Xnp[0].shape[0],
        dtype=jnp.float32,
    )
    X = tuple(jnp.asarray(x, jnp.float32) for x in Xnp)
    alpha = jnp.asarray([0.1, 0.1], jnp.float32)
    keys = jax.random.split(jax.random.key(0), R)
    states = jax.vmap(lambda k: init_with_alpha(k, base, X, alpha))(keys)
    N = counts_per_doc(X)

    real_step = mmod.fit_step_fn(X, N, base)
    warm = jax.jit(jax.vmap(lambda s: jax.lax.fori_loop(
        0, 20, lambda _, c: real_step(c[0]),
        (s, jnp.zeros((base.M,), jnp.float32))
    )[0]))
    states = warm(states)
    jax.block_until_ready(states)
    print("resolved budgets:", resolved_budgets(base))

    def make_step(config, skip_nu=False, skip_lambda=False):
        budgets = resolved_budgets(config)

        def step(s):
            logw = mmod.smoothed_logw(s)
            from multimodalmusig_tpu.models.ctm_base import theta_moments_auto

            sumtheta, scatters = theta_moments_auto(s.lam, logw, X, config)
            zeta = update_zeta(s.lam, s.nu, config)
            Ndivzeta = calculate_Ndivzeta(N, zeta, config)
            if skip_nu:
                nu2 = s.nu
            else:
                nu_kw = ({} if budgets["nu_n_iter"] is None
                         else {"n_iter": budgets["nu_n_iter"]})
                nu2 = maximize_nu(
                    s.nu, s.lam, Ndivzeta,
                    jnp.diagonal(s.invSigma)[None, :], **nu_kw)
            if skip_lambda:
                lam2 = s.lam + 1e-20 * sumtheta
            else:
                kw = {
                    k: budgets[f]
                    for k, f in (("n_iter", "lambda_n_iter"),
                                 ("cg_iter", "lambda_cg_iter"),
                                 ("polish_iter", "lambda_polish_iter"))
                    if budgets[f] is not None
                }
                lam2 = solve_lambda(
                    s.lam, nu2, Ndivzeta, sumtheta, s.mu, s.invSigma,
                    force_fused=config.force_fused, **kw)
            s = s._replace(zeta=zeta, lam_pre=s.lam, logw_pre=logw,
                           nu=nu2, lam=lam2)
            s = mmod.update_mu(s)
            s = mmod.update_Sigma(s, config)
            s = mmod.update_gamma(s, X, config, scatter=scatters)
            ll_i = mmod.modality_loglikelihoods(
                X, mmod.props_from(s.lam, config), mmod.phi_point(s.gamma))
            return s, ll_i

        return step

    def timed(label, step):
        @jax.jit
        def run(states):
            def one(s):
                return jax.lax.fori_loop(
                    0, CH, lambda _, c: step(c[0]),
                    (s, jnp.zeros((base.M,), jnp.float32)))

            return jax.vmap(one)(states)

        out = run(states)
        jax.block_until_ready(out)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(run(states))
            best = min(best, time.perf_counter() - t0)
        print(f"  {label:<30s} {best / CH * 1e3:8.3f} ms/iter")
        return best / CH

    print(f"platform={jax.devices()[0].platform} R={R} chain={CH}")
    full = timed("full (production)", make_step(base))
    for label, cfg, kw in [
        ("no nu solve", base, dict(skip_nu=True)),
        ("no lambda solve", base, dict(skip_lambda=True)),
        ("no nu, no lambda", base, dict(skip_nu=True, skip_lambda=True)),
        ("lambda n_iter=1", dataclasses.replace(base, lambda_n_iter=1), {}),
        ("lambda n_iter=2", dataclasses.replace(base, lambda_n_iter=2), {}),
        ("lambda cg=6", dataclasses.replace(base, lambda_cg_iter=6), {}),
        ("lambda cg=4", dataclasses.replace(base, lambda_cg_iter=4), {}),
        ("nu n_iter=2", dataclasses.replace(base, nu_n_iter=2), {}),
        ("XLA lambda (force_fused=F)",
         dataclasses.replace(base, force_fused=False), {}),
    ]:
        t = timed(label, make_step(cfg, **kw))
        print(f"    -> delta vs full {(full - t) * 1e3:+8.3f} ms")


if __name__ == "__main__":
    main()
