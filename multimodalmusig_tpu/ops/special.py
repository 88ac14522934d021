"""Special-function kernels shared by all variational updates.

Batched re-implementation of the reference's shared math substrate
(reference: src/common.jl:1-9 `logmvbeta`; src/LDA.jl:78-80,96-98 and
src/MMCTM.jl:214-222 Dirichlet digamma expectations). Everything here is
batched, jit-safe and dtype-polymorphic (float32 fast path on the GPU,
float64 for parity tests against the Julia reference).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax.scipy.special import digamma, gammaln

__all__ = [
    "digamma",
    "gammaln",
    "logmvbeta",
    "logmvbeta_symmetric",
    "dirichlet_expectation",
    "xlogx",
    "safe_xlogy",
]


def logmvbeta(vals: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """log multivariate Beta: sum(lgamma(v_i)) - lgamma(sum(v_i)).

    Batched along all axes except `axis` (reference: src/common.jl:1-9
    loops over a single vector; here one call handles all topics at once).
    """
    return jnp.sum(gammaln(vals), axis=axis) - gammaln(jnp.sum(vals, axis=axis))


def logmvbeta_symmetric(alpha: jnp.ndarray, n) -> jnp.ndarray:
    """logmvbeta(fill(alpha, n)) without materializing the filled vector.

    Used by the Dirichlet prior ELBO terms (reference: src/MMCTM.jl:276,
    src/IMMCTM.jl:253 call `logmvbeta(fill(α, V))`).
    """
    return n * gammaln(alpha) - gammaln(n * alpha)


def dirichlet_expectation(params: jnp.ndarray, axis: int) -> jnp.ndarray:
    """E[ln p] under Dirichlet(params), normalizing over `axis`.

    digamma(p) - digamma(sum(p, axis)) (reference: src/LDA.jl:78-80,
    src/MMCTM.jl:214-222).
    """
    return digamma(params) - digamma(jnp.sum(params, axis=axis, keepdims=True))


def xlogx(x: jnp.ndarray) -> jnp.ndarray:
    """x * log(x) with the 0*log(0) = 0 convention.

    The entropy terms ElnQZ (reference: src/LDA.jl:160-166,
    src/MMCTM.jl:362-370) compute `log(ϕ^ϕ)`; in float32 responsibilities
    can underflow to exactly 0, so guard the log.
    """
    safe = jnp.where(x > 0, x, 1.0)
    return jnp.where(x > 0, x * jnp.log(safe), 0.0)


def safe_xlogy(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """x * log(y) treating x == 0 as exact zero (avoids 0 * -inf -> NaN).

    Used for count-weighted log-likelihoods where zero-count cells of the
    dense count tensor must not contribute (reference keeps counts sparse
    so the issue never arises: src/LDA.jl:174-196, src/MMCTM.jl:384-407).
    """
    safe = jnp.where(x != 0, y, 1.0)
    return jnp.where(x != 0, x * jnp.log(safe), 0.0)
