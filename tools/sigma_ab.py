"""A/B the per-iteration Σ⁻¹ computation (update_Sigma_mats' spd_inverse):
XLA's batched cho_factor/cho_solve at (R, MK, MK) lowers to dynamic-slice
While loops, and the M-step pays it once per CAVI iteration per restart
lane. Candidate: a fully unrolled static-MK Cholesky factor + unit
forward substitution + one HIGHEST-precision matmul — ~2·MK sequential
steps of batched vector ops instead of XLA's dynamic-slice While loops.

Correctness arm checks f64 agreement with np.linalg.inv at BRCA-like
conditioning; the timing arms run inside the production iteration frame.
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


from multimodalmusig_tpu.models.ctm_base import (  # noqa: E402
    _spd_inverse_unrolled as spd_inverse_unrolled,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--restarts", type=int, default=100)
    ap.add_argument("--chain", type=int, default=60)
    args = ap.parse_args()
    R, CH = args.restarts, args.chain

    def cho_inv(S):
        chol = jax.scipy.linalg.cho_factor(S)
        return jax.scipy.linalg.cho_solve(
            chol, jnp.eye(S.shape[-1], dtype=S.dtype))

    # correctness at BRCA-like conditioning (diagonals down to ~5e-3)
    rng = np.random.default_rng(0)
    n = 14
    A = rng.normal(size=(8, n, n))
    S64 = np.einsum("bij,bkj->bik", A, A) / n + np.eye(n) * 5e-3
    got = np.asarray(spd_inverse_unrolled(jnp.asarray(S64)))
    want = np.linalg.inv(S64)
    rel = np.abs(got - want).max() / np.abs(want).max()
    print(f"f64 max rel err vs np.linalg.inv: {rel:.3e}")

    f32 = jnp.asarray(S64, jnp.float32)
    got32 = np.asarray(spd_inverse_unrolled(f32))
    ref32 = np.asarray(jax.vmap(cho_inv)(f32))
    print(f"f32 max |unrolled - cho_solve|/max: "
          f"{np.abs(got32 - ref32).max() / np.abs(ref32).max():.3e}")

    # timing inside the production iteration frame
    from bench import load_counts_np
    from multimodalmusig_tpu.models import mmctm as mmod
    from multimodalmusig_tpu.models.ctm_base import (
        counts_per_doc,
        update_Sigma_mats,
    )
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
    step0 = mmod.fit_step_fn(X, N, config)
    warm = jax.jit(jax.vmap(lambda s: jax.lax.fori_loop(
        0, 20, lambda _, c: step0(c[0]),
        (s, jnp.zeros((config.M,), jnp.float32)))[0]))
    states = warm(states)
    jax.block_until_ready(states)

    def make_step(inv_fn):
        def update_Sigma(s):
            E = s.lam - s.mu[None, :]
            gram = jnp.matmul(E.T, E, precision=jax.lax.Precision.HIGHEST)
            Sigma = (jnp.diag(s.nu.sum(axis=0)) + gram) / config.D
            return s._replace(Sigma=Sigma, invSigma=inv_fn(Sigma))

        def step(s):
            s, scatters = mmod.e_step_moments(s, X, N, config)
            s = mmod.update_mu(s)
            s = update_Sigma(s)
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
                    (s, jnp.zeros((config.M,), jnp.float32)))

            return jax.vmap(one)(states)

        jax.block_until_ready(run(states))
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(run(states))
            best = min(best, time.perf_counter() - t0)
        print(f"  {label:<22s} {best / CH * 1e3:8.3f} ms/iter")

    print(f"platform={jax.devices()[0].platform} R={R} chain={CH}")
    timed("cho_factor/cho_solve", make_step(cho_inv))
    timed("unrolled chol", make_step(spd_inverse_unrolled))
    timed("lu inv (jnp)", make_step(jnp.linalg.inv))


if __name__ == "__main__":
    main()
