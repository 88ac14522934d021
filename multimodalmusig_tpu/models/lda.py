"""Smoothed LDA fit by coordinate-ascent variational inference.

Re-implementation of the reference's src/LDA.jl (295 LoC Julia) as a pure
functional JAX core plus a thin stateful wrapper mirroring the Julia API.

Idiomatic differences from the reference (same math, accelerator layout):
  * Counts are a dense (D, V) tensor instead of ragged (n, 2) sparse docs
    (src/LDA.jl keeps per-doc sparse matrices); at V <= a few thousand the
    dense form turns every update into one batched matmul.
  * Responsibilities ϕ are a dense (D, V, K) tensor; the reference stores
    per-document (K, n_d) matrices (src/LDA.jl:47-50). Zero-count cells carry
    a well-defined softmax value but never contribute to count-weighted sums.
  * The per-document update loops (src/LDA.jl:69-76, 82-90, 100-108) are
    single einsums over all documents.
  * exp-then-normalize is computed as a stabilized softmax — identical values,
    no overflow (the reference exponentiates raw digammas, src/LDA.jl:71-75).
  * The fit loop runs under jit as a lax.while_loop with the reference's
    convergence rule (rel. Δll < tol after iteration 10; src/LDA.jl:216-219,
    src/common.jl:48-56).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.convergence import MIN_ITERS_BEFORE_CONVERGENCE, relative_change
from ..ops.special import dirichlet_expectation, gammaln, safe_xlogy, xlogx
from .ctm_base import carry_converged
from ..utils.formatting import infer_vocab_size, sparse_to_dense

# float32 contractions pin HIGHEST: unpinned, a GPU may run them in TF32
# (10 mantissa bits).
_HI = jax.lax.Precision.HIGHEST

__all__ = ["LDAConfig", "LDAState", "LDAFitResult", "LDA", "transform", "fit_heldout"]


@dataclasses.dataclass(frozen=True)
class LDAConfig:
    """Static model configuration (hashable -> usable as a jit static arg)."""

    K: int              # topics (src/LDA.jl:2)
    V: int              # vocabulary size (src/LDA.jl:5)
    D: int              # documents (src/LDA.jl:3)
    alpha: float        # doc-topic Dirichlet hyperparameter α (src/LDA.jl:11)
    eta: float          # topic-word Dirichlet hyperparameter η (src/LDA.jl:7)
    dtype: Any = jnp.float32


class LDAState(NamedTuple):
    """Variational state; a pytree of dense arrays.

    Layouts are row-major batch-first ((D, K), (V, K), (D, V, K)); the
    reference's column layouts ((K, D) etc., src/LDA.jl)
    are restored by the wrapper's accessor properties.
    """

    lam: jnp.ndarray           # (V, K) topic-word Dirichlet variational params λ
    Elnbeta: jnp.ndarray       # (V, K) E[ln β]
    gamma: jnp.ndarray         # (D, K) doc-topic Dirichlet variational params γ
    Elntheta: jnp.ndarray      # (D, K) E[ln θ]
    # The responsibilities ϕ (reference field src/LDA.jl:14, the dominant
    # (D, V, K) tensor) are not stored: ϕ = softmax(Elnθ_pre + logw_pre) is
    # fully determined by the tables the last ϕ-update consumed, so only that
    # tiny snapshot is carried and ϕ reconstructs exactly (phi_from /
    # reconstruct_phi). Zero snapshots at init reproduce the reference's
    # uniform 1/K init ϕ (src/LDA.jl:47-50).
    Elntheta_pre: jnp.ndarray  # (D, K)
    logw_pre: jnp.ndarray      # (V, K) Elnβ (training) or ln β (inference)


class LDAFitResult(NamedTuple):
    state: LDAState
    ll_history: jnp.ndarray  # (maxiter,) log-likelihood trajectory (0 past n_iters)
    n_iters: jnp.ndarray     # iterations actually run
    converged: jnp.ndarray   # bool
    elbo: jnp.ndarray        # final ELBO (src/LDA.jl:221)
    ll: jnp.ndarray          # final per-word log-likelihood


# ---------------------------------------------------------------------------
# Initialization (src/LDA.jl:24-55)
# ---------------------------------------------------------------------------


def init(key: jax.Array, config: LDAConfig) -> LDAState:
    """Random initialization matching the reference's distributional choices:
    λ ~ Uniform{1..100} (src/LDA.jl:36), γ = 1 (src/LDA.jl:41), ϕ uniform
    (src/LDA.jl:47-50). RNG is an explicit key instead of global state.
    """
    dt = config.dtype
    lam = jax.random.randint(key, (config.V, config.K), 1, 101).astype(dt)
    gamma = jnp.ones((config.D, config.K), dt)
    return LDAState(
        lam=lam,
        Elnbeta=dirichlet_expectation(lam, axis=0),
        gamma=gamma,
        Elntheta=dirichlet_expectation(gamma, axis=1),
        Elntheta_pre=jnp.zeros((config.D, config.K), dt),
        logw_pre=jnp.zeros((config.V, config.K), dt),
    )


# ---------------------------------------------------------------------------
# CAVI updates (src/LDA.jl:69-112)
# ---------------------------------------------------------------------------


def phi_from(Elntheta: jnp.ndarray, logw: jnp.ndarray) -> jnp.ndarray:
    """(D, V, K) responsibilities: softmax over topics of Elnθ[d,:]+logw[v,:]."""
    return jax.nn.softmax(Elntheta[:, None, :] + logw[None, :, :], axis=-1)


def reconstruct_phi(state: LDAState) -> jnp.ndarray:
    """The ϕ of the last ϕ-update, from the carried snapshot (exact)."""
    return phi_from(state.Elntheta_pre, state.logw_pre)


def update_gamma(
    state: LDAState, X: jnp.ndarray, config: LDAConfig, phi: jnp.ndarray = None
) -> LDAState:
    """γ[d,:] = α + ϕ_d·counts_d, then refresh E[ln θ] (src/LDA.jl:82-90).
    ϕ defaults to the last ϕ-update's (reconstructed)."""
    if phi is None:
        phi = reconstruct_phi(state)
    gamma = config.alpha + jnp.einsum(
        "dv,dvk->dk", X, phi, preferred_element_type=config.dtype, precision=_HI
    )
    return state._replace(gamma=gamma, Elntheta=dirichlet_expectation(gamma, axis=1))


def update_phi(state: LDAState) -> LDAState:
    """ϕ[d,v,:] ∝ exp(Elnθ[d,:] + Elnβ[v,:]) (src/LDA.jl:69-76). Records the
    snapshot the reconstruction replays."""
    return state._replace(Elntheta_pre=state.Elntheta, logw_pre=state.Elnbeta)


def unsmoothed_update_phi(state: LDAState, beta: jnp.ndarray) -> LDAState:
    """Inference-mode ϕ using the point estimate β (src/LDA.jl:226-231)."""
    return state._replace(Elntheta_pre=state.Elntheta, logw_pre=jnp.log(beta))


def update_lambda(
    state: LDAState, X: jnp.ndarray, config: LDAConfig, phi: jnp.ndarray = None
) -> LDAState:
    """λ[v,:] = η + Σ_d ϕ[d,v,:]·X[d,v], then refresh E[ln β] (src/LDA.jl:100-108)."""
    if phi is None:
        phi = reconstruct_phi(state)
    lam = config.eta + jnp.einsum(
        "dv,dvk->vk", X, phi, preferred_element_type=config.dtype, precision=_HI
    )
    return state._replace(lam=lam, Elnbeta=dirichlet_expectation(lam, axis=0))


def beta_point(state: LDAState) -> jnp.ndarray:
    """β = λ normalized over the vocab axis (src/LDA.jl:110-112). (V, K)."""
    return state.lam / jnp.sum(state.lam, axis=0, keepdims=True)


def theta_point(state: LDAState) -> jnp.ndarray:
    """θ = γ normalized over the topic axis (src/LDA.jl:92-94). (D, K)."""
    return state.gamma / jnp.sum(state.gamma, axis=1, keepdims=True)


# ---------------------------------------------------------------------------
# Metrics (src/LDA.jl:114-196)
# ---------------------------------------------------------------------------


def loglikelihood(X: jnp.ndarray, theta: jnp.ndarray, beta: jnp.ndarray) -> jnp.ndarray:
    """Per-word mixture log-likelihood Σ X·log(θ·βᵀ) / N (src/LDA.jl:174-190)."""
    P = jnp.matmul(theta, beta.T, precision=_HI)  # (D, V)
    return jnp.sum(safe_xlogy(X, P)) / jnp.sum(X)


def calculate_elbo(
    state: LDAState, X: jnp.ndarray, config: LDAConfig, phi: jnp.ndarray = None
) -> jnp.ndarray:
    """Dirichlet-multinomial ELBO, the 7 terms of src/LDA.jl:114-172.
    ϕ defaults to the last ϕ-update's (reconstructed), matching the state
    the reference computes the final ELBO from (src/LDA.jl:221)."""
    if phi is None:
        phi = reconstruct_phi(state)
    K, V, D = config.K, config.V, config.D
    alpha, eta = config.alpha, config.eta
    present = (X > 0).astype(phi.dtype)

    ElnPbeta = K * (gammaln(V * eta) - V * gammaln(eta)) + (eta - 1.0) * jnp.sum(state.Elnbeta)
    ElnPtheta = D * (gammaln(K * alpha) - K * gammaln(alpha)) + (alpha - 1.0) * jnp.sum(state.Elntheta)
    ElnPZ = jnp.einsum("dvk,dk,dv->", phi, state.Elntheta, X, precision=_HI)
    ElnPX = jnp.einsum("dvk,vk,dv->", phi, state.Elnbeta, X, precision=_HI)
    ElnQbeta = (
        jnp.sum(gammaln(state.lam))
        - jnp.sum(gammaln(jnp.sum(state.lam, axis=0)))
        - jnp.sum((state.lam - 1.0) * state.Elnbeta)
    )
    ElnQtheta = (
        jnp.sum(gammaln(state.gamma))
        - jnp.sum(gammaln(jnp.sum(state.gamma, axis=1)))
        - jnp.sum((state.gamma - 1.0) * state.Elntheta)
    )
    # The reference sums ϕ·ln(ϕ) over *present* tokens only, unweighted by
    # counts (src/LDA.jl:160-166) — mask rather than count-weight.
    ElnQZ = jnp.sum(xlogx(phi) * present[:, :, None])

    return ElnPbeta + ElnPtheta + ElnPZ + ElnPX - ElnQbeta - ElnQtheta - ElnQZ


# ---------------------------------------------------------------------------
# Fit loops (src/LDA.jl:198-295)
# ---------------------------------------------------------------------------


def _run_cavi(state, X, config, maxiter, tol, step_fn, verbose=False):
    """Scalar-metric CAVI driver: the shared loop of ctm_base with a
    (maxiter,) log-likelihood buffer (src/LDA.jl:198-224 convergence rule)."""
    from .ctm_base import run_cavi_from

    carry = (state, jnp.zeros((maxiter,), config.dtype), jnp.int32(0), jnp.array(False))
    return run_cavi_from(
        carry, maxiter, tol, step_fn, verbose, verbose_label="Log-likelihood"
    )


def _fit_step(state, X, config):
    """One full CAVI iteration in the reference's order (src/LDA.jl:201-209)."""
    state = update_gamma(state, X, config)
    state = update_phi(state)
    state = update_lambda(state, X, config)
    ll_i = loglikelihood(X, theta_point(state), beta_point(state))
    return state, ll_i


def fit(
    state: LDAState,
    X: jnp.ndarray,
    config: LDAConfig,
    maxiter: int = 1000,
    tol: float = 1e-4,
    verbose: bool = False,
) -> LDAFitResult:
    """Full smoothed-LDA fit (src/LDA.jl:198-224). Pure; jit/vmap-safe."""
    state, ll_buf, n_iters, converged = _run_cavi(
        state, X, config, maxiter, tol, lambda s: _fit_step(s, X, config), verbose
    )
    return LDAFitResult(
        state=state,
        ll_history=ll_buf,
        n_iters=n_iters,
        converged=carry_converged(ll_buf, n_iters, converged),
        elbo=calculate_elbo(state, X, config),
        ll=ll_buf[n_iters - 1],
    )


def transform_states(
    trained: LDAState,
    state: LDAState,
    Xnew: jnp.ndarray,
    config: LDAConfig,
    maxiter: int = 1000,
    tol: float = 1e-4,
    verbose: bool = False,
):
    """Fold in new documents with the trained point estimate β frozen
    (src/LDA.jl:233-263). Returns (θ (D,K), fit diagnostics).

    The reference's transform leaves the new model's topic-side state at its
    random init and never computes an ELBO; here the trained λ/Elnβ are
    copied in so the returned state is coherent and the ELBO is the real
    ELBO of {trained topics, new-document γ, inference ϕ} (round-1 review:
    the previous placeholder elbo=0.0 was a silent wrong-number trap)."""
    beta = beta_point(trained)
    state = state._replace(lam=trained.lam, Elnbeta=trained.Elnbeta)

    def step(s):
        s = update_gamma(s, Xnew, config)
        s = unsmoothed_update_phi(s, beta)
        ll_i = loglikelihood(Xnew, theta_point(s), beta)
        return s, ll_i

    state, ll_buf, n_iters, converged = _run_cavi(
        state, Xnew, config, maxiter, tol, step, verbose
    )
    return theta_point(state), LDAFitResult(
        state=state,
        ll_history=ll_buf,
        n_iters=n_iters,
        converged=carry_converged(ll_buf, n_iters, converged),
        elbo=calculate_elbo(state, Xnew, config),
        ll=ll_buf[n_iters - 1],
    )


def fit_heldout_states(
    trained: LDAState,
    state: LDAState,
    Xheldout: jnp.ndarray,
    config: LDAConfig,
    maxiter: int = 100,
    tol: float = 1e-4,
    verbose: bool = False,
) -> LDAFitResult:
    """Document-side-only refit with copied λ/β/Elnβ (src/LDA.jl:265-295)."""
    state = state._replace(lam=trained.lam, Elnbeta=trained.Elnbeta)
    beta = beta_point(trained)

    def step(s):
        s = update_gamma(s, Xheldout, config)
        s = update_phi(s)
        ll_i = loglikelihood(Xheldout, theta_point(s), beta)
        return s, ll_i

    state, ll_buf, n_iters, converged = _run_cavi(
        state, Xheldout, config, maxiter, tol, step, verbose
    )
    return LDAFitResult(
        state=state,
        ll_history=ll_buf,
        n_iters=n_iters,
        converged=carry_converged(ll_buf, n_iters, converged),
        elbo=calculate_elbo(state, Xheldout, config),
        ll=ll_buf[n_iters - 1],
    )


# ---------------------------------------------------------------------------
# Stateful wrapper mirroring the Julia API (constructors at src/LDA.jl:24-67)
# ---------------------------------------------------------------------------


class LDA:
    """Stateful wrapper with the reference's constructor/field surface.

    ``LDA(k, α, η, X)`` or ``LDA(k, α, η, V, X)`` where X is a list of
    (n, 2) 1-based (vocab_index, count) matrices (src/LDA.jl:24-67).
    Unicode aliases (``model.λ`` etc.) expose arrays in the reference's
    orientation: λ/β/Elnβ are (V, K); γ/θ/Elnθ are (K, D).
    """

    def __init__(self, k, alpha, eta, *args, seed: int = 0, dtype=None):
        if len(args) == 2:
            V, X = args
        elif len(args) == 1:
            X = args[0]
            V = infer_vocab_size(X)
        else:
            raise TypeError("LDA(k, alpha, eta, [V,] X)")
        dtype = dtype or (jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
        self.X = [np.asarray(doc) for doc in X]
        self.config = LDAConfig(
            K=int(k), V=int(V), D=len(X), alpha=float(alpha), eta=float(eta), dtype=dtype
        )
        self.Xdense = jnp.asarray(sparse_to_dense(self.X, self.config.V), dtype=dtype)
        self.state = init(jax.random.key(seed), self.config)
        self.converged = False
        self.elbo = None
        self.ll = None

    # -- reference scalar fields (src/LDA.jl:2-16) --
    @property
    def K(self):
        return self.config.K

    @property
    def D(self):
        return self.config.D

    @property
    def V(self):
        return self.config.V

    @property
    def N(self) -> List[int]:
        return [int(np.asarray(doc)[:, 1].sum()) if len(doc) else 0 for doc in self.X]

    @property
    def alpha(self):
        return self.config.alpha

    @property
    def eta(self):
        return self.config.eta

    # -- reference arrays, reference orientation --
    @property
    def lam(self):
        return np.asarray(self.state.lam)

    @property
    def beta(self):
        return np.asarray(beta_point(self.state))

    @property
    def Elnbeta(self):
        return np.asarray(self.state.Elnbeta)

    @property
    def gamma(self):
        return np.asarray(self.state.gamma).T  # (K, D) as in src/LDA.jl:12

    @property
    def theta(self):
        return np.asarray(theta_point(self.state)).T  # (K, D)

    @property
    def Elntheta(self):
        return np.asarray(self.state.Elntheta).T  # (K, D)

    @property
    def phi(self) -> List[np.ndarray]:
        """Per-document (K, n_d) responsibilities over present terms, in the
        sparse row order of X (matches src/LDA.jl:14 ϕ layout)."""
        dense = np.asarray(reconstruct_phi(self.state))
        out = []
        for d, doc in enumerate(self.X):
            idx = doc[:, 0].astype(np.int64) - 1
            out.append(dense[d, idx, :].T)
        return out

    # unicode aliases for drop-in parity with the Julia field names
    λ = lam
    β = beta
    Elnβ = Elnbeta
    γ = gamma
    θ = theta
    Elnθ = Elntheta
    ϕ = phi
    α = alpha
    η = eta

    def fit(self, maxiter: int = 1000, tol: float = 1e-4, verbose: bool = True):
        """`fit!` (src/LDA.jl:198-224). Returns the log-likelihood history."""
        result = _jit_fit(self.state, self.Xdense, self.config, maxiter, tol, verbose)
        self.state = result.state
        n = int(result.n_iters)
        self.converged = bool(result.converged)
        self.elbo = float(result.elbo)
        self.ll = float(result.ll)
        return list(np.asarray(result.ll_history[:n], dtype=np.float64))

    fit_ = fit  # `fit!` spelling

    def __repr__(self):
        status = f"fitted, ll={self.ll:.5f}" if self.ll is not None else "unfitted"
        return f"LDA(K={self.K}, D={self.D}, V={self.V}, {status})"


def _jit_fit(state, X, config, maxiter, tol, verbose):
    return jax.jit(fit, static_argnames=("config", "maxiter", "tol", "verbose"))(
        state, X, config, maxiter=maxiter, tol=tol, verbose=verbose
    )


def transform(model: LDA, X, maxiter: int = 1000, tol: float = 1e-4, verbose: bool = False):
    """Reference `transform(model, X)` (src/LDA.jl:233-263): fold-in new docs
    against the trained β; returns θ as (K, D_new) like the Julia version.

    Divergence from reference: the not-converged branch warns via Python
    `warnings` instead of crashing (src/LDA.jl:259 calls a nonexistent
    pre-1.0 `warn`).
    """
    X = [np.asarray(doc) for doc in X]
    cfg = dataclasses.replace(model.config, D=len(X))
    Xdense = jnp.asarray(sparse_to_dense(X, cfg.V), dtype=cfg.dtype)
    fresh = init(jax.random.key(0), cfg)
    theta, result = jax.jit(
        transform_states, static_argnames=("config", "maxiter", "tol", "verbose")
    )(model.state, fresh, Xdense, cfg, maxiter=maxiter, tol=tol, verbose=verbose)
    if not bool(result.converged):
        import warnings

        warnings.warn("transform did not converge")
    return np.asarray(theta).T


def fit_heldout(Xheldout, model: LDA, maxiter: int = 100, verbose: bool = False) -> LDA:
    """Reference `fit_heldout` (src/LDA.jl:265-295): doc-side refit with the
    trained topics; returns a new fitted LDA wrapper."""
    heldout = LDA(
        model.K, model.alpha, model.eta, model.V, [np.asarray(d) for d in Xheldout],
        dtype=model.config.dtype,
    )
    result = jax.jit(
        fit_heldout_states, static_argnames=("config", "maxiter", "tol", "verbose")
    )(model.state, heldout.state, heldout.Xdense, heldout.config, maxiter=maxiter,
      verbose=verbose)
    heldout.state = result.state
    heldout.converged = bool(result.converged)
    heldout.elbo = float(result.elbo)
    heldout.ll = float(result.ll)
    return heldout
