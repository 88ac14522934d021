"""How many (P)CG iterations does the λ Newton system actually need?

The Newton systems (Σ⁻¹ + diag(w)) δ = g are solved with plain CG at
cg_iter = MK (exact in exact arithmetic). With a Jacobi preconditioner
M = diag(Σ⁻¹) + w the spectrum should cluster wherever w dominates — this
tool measures, on REAL systems harvested from a BRCA-EU fit (float64 CPU),
the relative solution error of CG and Jacobi-PCG at each iteration count
against a direct solve.
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
from multimodalmusig_tpu.utils.fast_tsv import read_counts_tsv
from multimodalmusig_tpu.utils.data import brca_counts_path


def harvest_systems(outer_iters=40, probe_at=(1, 3, 10, 25, 40)):
    """Run a BRCA fit; at probe points capture (w, g, invSigma) batches."""
    Xnp = []
    for fname in ("brca-eu_snv_counts.tsv", "brca-eu_sv_counts.tsv"):
        counts, _, _ = read_counts_tsv(brca_counts_path(fname))
        Xnp.append(counts.T[:256])
    D = Xnp[0].shape[0]
    config = MMCTMConfig(
        K=(7, 7), V=(Xnp[0].shape[1], Xnp[1].shape[1]), D=D, dtype=jnp.float64
    )
    X = tuple(jnp.asarray(x, jnp.float64) for x in Xnp)
    alpha = jnp.asarray([0.1, 0.1], jnp.float64)
    state = init_with_alpha(jax.random.key(0), config, X, alpha)
    N = counts_per_doc(X)
    step = jax.jit(mmod.fit_step_fn(X, N, config))
    from multimodalmusig_tpu.ops.solvers import maximize_nu

    systems = []
    for it in range(1, max(probe_at) + 1):
        if it in probe_at:
            zeta = mmod.update_zeta(state, config)
            theta = mmod.theta_from(state.lam, mmod.smoothed_logw(state), config)
            ndz = calculate_Ndivzeta(N, zeta, config)
            nu = maximize_nu(
                state.nu, state.lam, ndz, jnp.diagonal(state.invSigma)[None, :]
            )
            st = calculate_sumtheta(theta, X, config)
            w = np.asarray(ndz * jnp.exp(state.lam + 0.5 * nu))
            g = np.asarray(
                -(np.asarray(state.lam) - np.asarray(state.mu))
                @ np.asarray(state.invSigma)
                + np.asarray(st)
                - w
            )
            systems.append((it, w, g, np.asarray(state.invSigma)))
        state, _ = step(state)
    return systems


def cg_errors(w, g, S, n_max, precond):
    """Per-iteration relative solution error vs direct solve, batched."""
    B, MK = g.shape
    H = S[None] + np.zeros((B, 1, 1)) * 0  # (B, MK, MK) view built below
    H = np.broadcast_to(S, (B, MK, MK)).copy()
    H[:, np.arange(MK), np.arange(MK)] += w
    exact = np.linalg.solve(H, g[..., None])[..., 0]
    scale = np.abs(exact).max()

    M = (np.diagonal(S)[None, :] + w) if precond else np.ones_like(w)
    x = np.zeros_like(g)
    r = g.copy()
    z = r / M
    p = z.copy()
    rz = np.sum(r * z, axis=-1)
    errs = []
    for _ in range(n_max):
        Ap = p @ S + w * p
        alpha = rz / (np.sum(p * Ap, axis=-1) + 1e-300)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        z = r / M
        rz_new = np.sum(r * z, axis=-1)
        beta = rz_new / (rz + 1e-300)
        p = z + beta[:, None] * p
        rz = rz_new
        errs.append(np.abs(x - exact).max() / scale)
    return errs


def main():
    systems = harvest_systems()
    for it, w, g, S in systems:
        cond = np.linalg.cond(S)
        plain = cg_errors(w, g, S, 14, precond=False)
        pcg = cg_errors(w, g, S, 14, precond=True)
        fmt = lambda e: " ".join(f"{v:.0e}" for v in e)
        print(f"outer {it:3d} (cond(invS)={cond:.1e}):")
        print(f"  CG : {fmt(plain)}")
        print(f"  PCG: {fmt(pcg)}")


if __name__ == "__main__":
    main()
