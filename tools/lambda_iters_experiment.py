"""How many Newton iterations does the λ solve actually need?

The λ solver runs a fixed n_iter of line-searched Newton + 4 polish steps
(ops/solvers.py). Each Newton iteration costs 14 CG matvecs — at benchmark
batch sizes the matvec FLOPs are the iteration's dominant cost — so the
minimum n_iter that still reaches machine-precision solves (the property the
trajectory-parity oracle relies on) is worth knowing exactly.

Runs the BRCA-EU MMCTM fit on CPU float64, and after every λ solve records
the residual gradient norm for several n_iter settings, from both cold
(iteration 1) and warm starts.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from multimodalmusig_tpu.models import mmctm as mmod
from multimodalmusig_tpu.models.ctm_base import (
    calculate_Ndivzeta,
    calculate_sumtheta,
    counts_per_doc,
)
from multimodalmusig_tpu.models.mmctm import MMCTMConfig, init_with_alpha
from multimodalmusig_tpu.ops.solvers import maximize_lambda
from multimodalmusig_tpu.utils.fast_tsv import read_counts_tsv
from multimodalmusig_tpu.utils.data import brca_counts_path


def main(outer_iters=30, n_iter_settings=(20, 14, 10, 8, 6)):
    Xnp = []
    for fname in ("brca-eu_snv_counts.tsv", "brca-eu_sv_counts.tsv"):
        counts, _, _ = read_counts_tsv(brca_counts_path(fname))
        Xnp.append(counts.T[:128])  # subset of docs for speed
    D = Xnp[0].shape[0]
    config = MMCTMConfig(
        K=(7, 7), V=(Xnp[0].shape[1], Xnp[1].shape[1]), D=D, dtype=jnp.float64
    )
    X = tuple(jnp.asarray(x, jnp.float64) for x in Xnp)
    alpha = jnp.asarray([0.1, 0.1], jnp.float64)
    state = init_with_alpha(jax.random.key(0), config, X, alpha)
    N = counts_per_doc(X)

    def grad_norm(lam, nu, ndz, st, mu, invS):
        w = ndz * jnp.exp(lam + 0.5 * nu)
        g = -jnp.sum((lam - mu)[..., :, None] * invS, axis=-2) + st - w
        return jnp.max(jnp.abs(g))

    step = jax.jit(mmod.fit_step_fn(X, N, config))

    # Drive the reference-n_iter fit; at selected outer iterations, re-solve
    # that iteration's λ problem with each candidate n_iter and report the
    # residual gradient and the deviation from the n_iter=20 solution.
    probe_at = {1, 2, 3, 5, 10, 20, 30}
    for it in range(1, outer_iters + 1):
        zeta = mmod.update_zeta(state, config)
        logw = mmod.smoothed_logw(state)
        theta = mmod.theta_from(state.lam, logw, config)
        ndz = calculate_Ndivzeta(N, zeta, config)
        from multimodalmusig_tpu.ops.solvers import maximize_nu

        nu = maximize_nu(state.nu, state.lam, ndz, jnp.diagonal(state.invSigma)[None, :])
        st = calculate_sumtheta(theta, X, config)

        if it in probe_at:
            sols = {}
            for n in n_iter_settings:
                lam_n = maximize_lambda(
                    state.lam, nu, ndz, st, state.mu, state.invSigma, n_iter=n
                )
                gn = float(grad_norm(lam_n, nu, ndz, st, state.mu, state.invSigma))
                sols[n] = (lam_n, gn)
            ref = sols[20][0]
            msg = " ".join(
                f"n={n}: |g|={gn:.2e} dev={float(jnp.max(jnp.abs(lam_n - ref))):.2e}"
                for n, (lam_n, gn) in sols.items()
            )
            print(f"outer {it:3d}: {msg}")

        state, _ = step(state)


if __name__ == "__main__":
    main()
