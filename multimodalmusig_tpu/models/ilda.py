"""Independent-feature LDA (ILDA) on accelerators.

Re-implementation of the reference's src/ILDA.jl (353 LoC Julia): LDA where
the vocabulary factorizes into I independent features via a lookup table
`features[v, i] ∈ 1..J_i`; the topic-word distribution is a product of
per-feature Dirichlets, p(v|k) = Π_i β_i[features[v,i], k]
(src/ILDA.jl:18, 222-229).

Accelerator re-architecture: the feature lookup becomes per-feature one-hot
matrices F_i : (V, J_i), so every gather/scatter in the reference's token
loops becomes a matmul (at HIGHEST precision, an exact lookup) —
  * summed log-topic terms Σ_i Elnβ_i[features[v,i], :] = Σ_i F_i @ Elnβ_i
    (replaces the w×i loop at src/ILDA.jl:65-79);
  * the λ scatter-add λ_i[j,:] += Nϕ[w,:] becomes F_iᵀ @ (Σ_d X·ϕ)
    (src/ILDA.jl:107-126);
  * the likelihood's per-feature product Π_i β_i[j,k] is exp of the summed
    log gathers (src/ILDA.jl:209-236).

Documented divergences from reference behavior (bug fixes):
  * `transform` works: the reference's ILDA transform constructs an LDA with
    a vector η, a method that does not exist (src/ILDA.jl:293 ⇒ MethodError;
    dead code). Ours runs the obviously-intended loop — frozen per-feature
    point β, unsmoothed ϕ updates (src/ILDA.jl:274-290).
  * `calculate_ElnQβ` accumulates over features; the reference overwrites
    `lnq =` inside the feature loop so only the last feature counts
    (src/ILDA.jl:174-181).
  * the not-converged `warn(...)` crash (src/ILDA.jl:317) is a Python warning.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.convergence import MIN_ITERS_BEFORE_CONVERGENCE, relative_change
from ..ops.special import dirichlet_expectation, gammaln, safe_xlogy, xlogx
from .ctm_base import carry_converged
from ..utils.formatting import infer_vocab_size, sparse_to_dense

# float32 contractions pin HIGHEST: unpinned, a GPU may run them in TF32
# (10 mantissa bits). The one-hot feature products at HIGHEST are exact
# lookups.
_HI = jax.lax.Precision.HIGHEST

__all__ = ["ILDAConfig", "ILDAState", "ILDAFitResult", "ILDA", "transform", "fit_heldout"]


@dataclasses.dataclass(frozen=True)
class ILDAConfig:
    """Static model configuration (hashable -> jit static arg)."""

    K: int                   # topics (src/ILDA.jl:2)
    V: int                   # vocabulary size
    D: int                   # documents
    J: Tuple[int, ...]       # values per feature (src/ILDA.jl:5)
    alpha: float             # doc-topic Dirichlet hyperparameter
    eta: Tuple[float, ...]   # per-feature topic Dirichlet hyperparameters
    dtype: Any = jnp.float32

    @property
    def I(self) -> int:
        return len(self.J)


class ILDAState(NamedTuple):
    """Variational state; per-feature collections are tuples (pytree)."""

    lam: Tuple[jnp.ndarray, ...]      # per feature (J_i, K) topic params λ_i
    Elnbeta: Tuple[jnp.ndarray, ...]  # per feature (J_i, K)
    gamma: jnp.ndarray                # (D, K)
    Elntheta: jnp.ndarray             # (D, K)
    # ϕ (D, V, K) is not stored — reconstructed exactly from the snapshot
    # the last ϕ-update consumed (see models/lda.py LDAState for rationale)
    Elntheta_pre: jnp.ndarray         # (D, K)
    logw_pre: jnp.ndarray             # (V, K) Σ_i Elnβ_i or Σ_i ln β_i


class ILDAFitResult(NamedTuple):
    state: ILDAState
    ll_history: jnp.ndarray
    n_iters: jnp.ndarray
    converged: jnp.ndarray
    elbo: jnp.ndarray
    ll: jnp.ndarray


def feature_onehots(features: np.ndarray, J: Sequence[int], dtype) -> Tuple[jnp.ndarray, ...]:
    """features (V, I) with 1-based values -> per-feature one-hot (V, J_i)."""
    features = np.asarray(features)
    out = []
    for i, Ji in enumerate(J):
        F = np.zeros((features.shape[0], Ji), dtype=np.float64)
        F[np.arange(features.shape[0]), features[:, i] - 1] = 1.0
        out.append(jnp.asarray(F, dtype=dtype))
    return tuple(out)


# ---------------------------------------------------------------------------
# Initialization (src/ILDA.jl:26-57)
# ---------------------------------------------------------------------------


def init(key: jax.Array, config: ILDAConfig) -> ILDAState:
    """λ_i ~ Uniform{1..100}, γ = 1, ϕ uniform (src/ILDA.jl:38-50)."""
    dt = config.dtype
    keys = jax.random.split(key, config.I)
    lam = tuple(
        jax.random.randint(keys[i], (config.J[i], config.K), 1, 101).astype(dt)
        for i in range(config.I)
    )
    gamma = jnp.ones((config.D, config.K), dt)
    return ILDAState(
        lam=lam,
        Elnbeta=tuple(dirichlet_expectation(l, axis=0) for l in lam),
        gamma=gamma,
        Elntheta=dirichlet_expectation(gamma, axis=1),
        # zero snapshots ⇒ reconstructed ϕ is the uniform init (src/ILDA.jl:44-47)
        Elntheta_pre=jnp.zeros((config.D, config.K), dt),
        logw_pre=jnp.zeros((config.V, config.K), dt),
    )


# ---------------------------------------------------------------------------
# CAVI updates (src/ILDA.jl:65-130)
# ---------------------------------------------------------------------------


def summed_Elnbeta(
    Elnbeta: Sequence[jnp.ndarray], F: Sequence[jnp.ndarray]
) -> jnp.ndarray:
    """(V, K): Σ_i Elnβ_i[features[v,i], :] as one-hot matmuls
    (replaces the per-token feature loop at src/ILDA.jl:65-79)."""
    total = jnp.matmul(F[0], Elnbeta[0], precision=_HI)
    for i in range(1, len(F)):
        total = total + jnp.matmul(F[i], Elnbeta[i], precision=_HI)
    return total


def phi_from(Elntheta: jnp.ndarray, logw: jnp.ndarray) -> jnp.ndarray:
    """(D, V, K) responsibilities: softmax over topics of Elnθ[d,:]+logw[v,:]."""
    return jax.nn.softmax(Elntheta[:, None, :] + logw[None, :, :], axis=-1)


def reconstruct_phi(state: ILDAState) -> jnp.ndarray:
    """The ϕ of the last ϕ-update, from the carried snapshot (exact)."""
    return phi_from(state.Elntheta_pre, state.logw_pre)


def update_phi(state: ILDAState, F: Sequence[jnp.ndarray]) -> ILDAState:
    """ϕ[d,v,:] ∝ exp(Elnθ[d,:] + Σ_i Elnβ_i[j_v,:]) (src/ILDA.jl:65-79)."""
    return state._replace(
        Elntheta_pre=state.Elntheta, logw_pre=summed_Elnbeta(state.Elnbeta, F)
    )


def unsmoothed_update_phi(
    state: ILDAState, beta: Sequence[jnp.ndarray], F: Sequence[jnp.ndarray]
) -> ILDAState:
    """Inference-mode ϕ using point β products (src/ILDA.jl:274-290)."""
    logB = summed_Elnbeta(tuple(jnp.log(b) for b in beta), F)  # Σ_i log β_i
    return state._replace(Elntheta_pre=state.Elntheta, logw_pre=logB)


def update_gamma(
    state: ILDAState, X: jnp.ndarray, config: ILDAConfig, phi: jnp.ndarray = None
) -> ILDAState:
    """γ[d,:] = α + ϕ_d·counts_d (src/ILDA.jl:85-93)."""
    if phi is None:
        phi = reconstruct_phi(state)
    gamma = config.alpha + jnp.einsum(
        "dv,dvk->dk", X, phi, preferred_element_type=config.dtype, precision=_HI
    )
    return state._replace(gamma=gamma, Elntheta=dirichlet_expectation(gamma, axis=1))


def update_lambda(
    state: ILDAState, X: jnp.ndarray, F: Sequence[jnp.ndarray],
    config: ILDAConfig, phi: jnp.ndarray = None
) -> ILDAState:
    """λ_i[j,:] = η_i + F_iᵀ·(Σ_d X·ϕ) (src/ILDA.jl:107-126)."""
    if phi is None:
        phi = reconstruct_phi(state)
    W = jnp.einsum(
        "dv,dvk->vk", X, phi, preferred_element_type=config.dtype, precision=_HI
    )
    lam = tuple(
        config.eta[i] + jnp.matmul(F[i].T, W, precision=_HI)
        for i in range(config.I)
    )
    return state._replace(
        lam=lam, Elnbeta=tuple(dirichlet_expectation(l, axis=0) for l in lam)
    )


def beta_point(state: ILDAState) -> Tuple[jnp.ndarray, ...]:
    """β_i = λ_i normalized over the value axis (src/ILDA.jl:128-130)."""
    return tuple(l / jnp.sum(l, axis=0, keepdims=True) for l in state.lam)


def theta_point(state: ILDAState) -> jnp.ndarray:
    """θ = γ normalized over topics (src/ILDA.jl:95-97). (D, K)."""
    return state.gamma / jnp.sum(state.gamma, axis=1, keepdims=True)


# ---------------------------------------------------------------------------
# Metrics (src/ILDA.jl:132-236)
# ---------------------------------------------------------------------------


def vocab_topic_probs(beta: Sequence[jnp.ndarray], F: Sequence[jnp.ndarray]) -> jnp.ndarray:
    """(V, K): p(v|k) = Π_i β_i[features[v,i], k] (src/ILDA.jl:222-229)."""
    return jnp.exp(summed_Elnbeta(tuple(jnp.log(b) for b in beta), F))


def loglikelihood(
    X: jnp.ndarray, theta: jnp.ndarray, beta: Sequence[jnp.ndarray], F: Sequence[jnp.ndarray]
) -> jnp.ndarray:
    """Per-word mixture log-likelihood (src/ILDA.jl:209-236)."""
    P = jnp.matmul(theta, vocab_topic_probs(beta, F).T, precision=_HI)  # (D, V)
    return jnp.sum(safe_xlogy(X, P)) / jnp.sum(X)


def calculate_elbo(
    state: ILDAState, X: jnp.ndarray, F: Sequence[jnp.ndarray], config: ILDAConfig
) -> jnp.ndarray:
    """Dirichlet-multinomial ELBO with per-feature β terms
    (src/ILDA.jl:132-207; ElnQβ accumulation bug fixed — see module docs)."""
    phi = reconstruct_phi(state)
    K, D = config.K, config.D
    alpha = config.alpha
    present = (X > 0).astype(phi.dtype)

    ElnPbeta = jnp.zeros((), config.dtype)
    for i in range(config.I):
        eta_i, Ji = config.eta[i], config.J[i]
        ElnPbeta += K * (gammaln(Ji * eta_i) - Ji * gammaln(eta_i))
        ElnPbeta += (eta_i - 1.0) * jnp.sum(state.Elnbeta[i])

    ElnPtheta = D * (gammaln(K * alpha) - K * gammaln(alpha)) + (alpha - 1.0) * jnp.sum(state.Elntheta)
    ElnPZ = jnp.einsum("dvk,dk,dv->", phi, state.Elntheta, X, precision=_HI)
    ElnPX = jnp.einsum(
        "dvk,vk,dv->", phi, summed_Elnbeta(state.Elnbeta, F), X, precision=_HI
    )

    ElnQbeta = jnp.zeros((), config.dtype)
    for i in range(config.I):
        ElnQbeta += (
            jnp.sum(gammaln(state.lam[i]))
            - jnp.sum(gammaln(jnp.sum(state.lam[i], axis=0)))
            - jnp.sum((state.lam[i] - 1.0) * state.Elnbeta[i])
        )

    ElnQtheta = (
        jnp.sum(gammaln(state.gamma))
        - jnp.sum(gammaln(jnp.sum(state.gamma, axis=1)))
        - jnp.sum((state.gamma - 1.0) * state.Elntheta)
    )
    # unweighted over present tokens, as in LDA (src/ILDA.jl:183-189)
    ElnQZ = jnp.sum(xlogx(phi) * present[:, :, None])

    return ElnPbeta + ElnPtheta + ElnPZ + ElnPX - ElnQbeta - ElnQtheta - ElnQZ


# ---------------------------------------------------------------------------
# Fit loops (src/ILDA.jl:246-353)
# ---------------------------------------------------------------------------


def _run_cavi(state, config, maxiter, tol, step_fn, verbose=False):
    """Scalar-metric CAVI driver: the shared loop of ctm_base with a
    (maxiter,) log-likelihood buffer (src/ILDA.jl:246-272 convergence rule)."""
    from .ctm_base import run_cavi_from

    carry = (state, jnp.zeros((maxiter,), config.dtype), jnp.int32(0), jnp.array(False))
    return run_cavi_from(
        carry, maxiter, tol, step_fn, verbose, verbose_label="Log-likelihood"
    )


def fit_step_fn(X, F, config: ILDAConfig):
    """One CAVI iteration (the loop body of src/ILDA.jl:246-272,
    γ → ϕ → λ → ll) as a state -> (state, ll) step. The single source of
    the iteration used by both `fit` and the compacted restart driver
    (parallel/restarts.py), so their lanes can never drift apart."""

    def step(s):
        s = update_gamma(s, X, config)
        s = update_phi(s, F)
        s = update_lambda(s, X, F, config)
        ll_i = loglikelihood(X, theta_point(s), beta_point(s), F)
        return s, ll_i

    return step


def fit(
    state: ILDAState,
    X: jnp.ndarray,
    F: Tuple[jnp.ndarray, ...],
    config: ILDAConfig,
    maxiter: int = 1000,
    tol: float = 1e-4,
    verbose: bool = False,
) -> ILDAFitResult:
    """Full ILDA fit, the loop of src/ILDA.jl:246-272 (γ → ϕ → λ → ll)."""
    step = fit_step_fn(X, F, config)
    state, ll_buf, n_iters, converged = _run_cavi(state, config, maxiter, tol, step, verbose)
    return ILDAFitResult(
        state=state,
        ll_history=ll_buf,
        n_iters=n_iters,
        converged=carry_converged(ll_buf, n_iters, converged),
        elbo=calculate_elbo(state, X, F, config),
        ll=ll_buf[n_iters - 1],
    )


def transform_states(
    trained: ILDAState,
    state: ILDAState,
    Xnew: jnp.ndarray,
    F: Tuple[jnp.ndarray, ...],
    config: ILDAConfig,
    maxiter: int = 1000,
    tol: float = 1e-4,
    verbose: bool = False,
):
    """Fold-in with frozen per-feature point β (fixes the reference's dead
    transform, src/ILDA.jl:288-321). The trained λ/Elnβ are copied so the
    returned state is coherent and its ELBO is the real ELBO of {trained
    topics, new-document γ, inference ϕ} (the round-1 placeholder elbo=0.0
    was a silent wrong-number trap)."""
    beta = beta_point(trained)
    state = state._replace(lam=trained.lam, Elnbeta=trained.Elnbeta)

    def step(s):
        s = update_gamma(s, Xnew, config)
        s = unsmoothed_update_phi(s, beta, F)
        ll_i = loglikelihood(Xnew, theta_point(s), beta, F)
        return s, ll_i

    state, ll_buf, n_iters, converged = _run_cavi(state, config, maxiter, tol, step, verbose)
    return theta_point(state), ILDAFitResult(
        state=state,
        ll_history=ll_buf,
        n_iters=n_iters,
        converged=carry_converged(ll_buf, n_iters, converged),
        elbo=calculate_elbo(state, Xnew, F, config),
        ll=ll_buf[n_iters - 1],
    )


def fit_heldout_states(
    trained: ILDAState,
    state: ILDAState,
    Xheldout: jnp.ndarray,
    F: Tuple[jnp.ndarray, ...],
    config: ILDAConfig,
    maxiter: int = 100,
    tol: float = 1e-4,
    verbose: bool = False,
) -> ILDAFitResult:
    """Doc-side-only refit with copied λ/β/Elnβ (src/ILDA.jl:323-353)."""
    state = state._replace(lam=trained.lam, Elnbeta=trained.Elnbeta)
    beta = beta_point(trained)

    def step(s):
        s = update_gamma(s, Xheldout, config)
        s = update_phi(s, F)
        ll_i = loglikelihood(Xheldout, theta_point(s), beta, F)
        return s, ll_i

    state, ll_buf, n_iters, converged = _run_cavi(state, config, maxiter, tol, step, verbose)
    return ILDAFitResult(
        state=state,
        ll_history=ll_buf,
        n_iters=n_iters,
        converged=carry_converged(ll_buf, n_iters, converged),
        elbo=calculate_elbo(state, Xheldout, F, config),
        ll=ll_buf[n_iters - 1],
    )


# ---------------------------------------------------------------------------
# Stateful wrapper mirroring the Julia API (src/ILDA.jl:26-63)
# ---------------------------------------------------------------------------


class ILDA:
    """``ILDA(k, α, η, features, X)`` with η a scalar or per-feature vector
    (src/ILDA.jl:26-63). `features` is (V, I) with 1-based values."""

    def __init__(self, k, alpha, eta, features, X, *, seed: int = 0, dtype=None):
        dtype = dtype or (jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
        features = np.asarray(features)
        I = features.shape[1]
        if np.isscalar(eta) or isinstance(eta, float) or isinstance(eta, int):
            eta = [float(eta)] * I
        if len(eta) != I:
            raise ValueError("eta must be a scalar or have one entry per feature")
        J = tuple(int(features[:, i].max()) for i in range(I))
        self.X = [np.asarray(doc) for doc in X]
        self.features = features
        self.config = ILDAConfig(
            K=int(k),
            V=int(features.shape[0]),
            D=len(X),
            J=J,
            alpha=float(alpha),
            eta=tuple(float(e) for e in eta),
            dtype=dtype,
        )
        self.F = feature_onehots(features, J, dtype)
        self.Xdense = jnp.asarray(sparse_to_dense(self.X, self.config.V), dtype=dtype)
        self.state = init(jax.random.key(seed), self.config)
        self.converged = False
        self.elbo = None
        self.ll = None

    # -- reference scalar fields (src/ILDA.jl:2-23) --
    @property
    def K(self):
        return self.config.K

    @property
    def D(self):
        return self.config.D

    @property
    def I(self):
        return self.config.I

    @property
    def J(self):
        return list(self.config.J)

    @property
    def V(self):
        return self.config.V

    @property
    def alpha(self):
        return self.config.alpha

    @property
    def eta(self):
        return list(self.config.eta)

    # -- reference arrays, reference orientation --
    @property
    def lam(self):
        return [np.asarray(l) for l in self.state.lam]

    @property
    def beta(self):
        return [np.asarray(b) for b in beta_point(self.state)]

    @property
    def Elnbeta(self):
        return [np.asarray(e) for e in self.state.Elnbeta]

    @property
    def gamma(self):
        return np.asarray(self.state.gamma).T  # (K, D)

    @property
    def theta(self):
        return np.asarray(theta_point(self.state)).T  # (K, D)

    @property
    def Elntheta(self):
        return np.asarray(self.state.Elntheta).T

    @property
    def phi(self) -> List[np.ndarray]:
        dense = np.asarray(reconstruct_phi(self.state))
        out = []
        for d, doc in enumerate(self.X):
            idx = doc[:, 0].astype(np.int64) - 1
            out.append(dense[d, idx, :].T)
        return out

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
        """`fit!` (src/ILDA.jl:246-272). Returns the log-likelihood history."""
        result = jax.jit(
            fit, static_argnames=("config", "maxiter", "tol", "verbose")
        )(self.state, self.Xdense, self.F, self.config, maxiter=maxiter, tol=tol, verbose=verbose)
        self.state = result.state
        n = int(result.n_iters)
        self.converged = bool(result.converged)
        self.elbo = float(result.elbo)
        self.ll = float(result.ll)
        return list(np.asarray(result.ll_history[:n], dtype=np.float64))

    fit_ = fit

    def __repr__(self):
        status = f"fitted, ll={self.ll:.5f}" if self.ll is not None else "unfitted"
        return f"ILDA(K={self.K}, D={self.D}, I={self.I}, J={self.J}, {status})"


def transform(model: ILDA, X, maxiter: int = 1000, tol: float = 1e-4, verbose: bool = False):
    """ILDA fold-in; returns θ (K, D_new). Fixes the reference's dead code
    at src/ILDA.jl:293 (MethodError) — see module docstring."""
    X = [np.asarray(doc) for doc in X]
    cfg = dataclasses.replace(model.config, D=len(X))
    Xdense = jnp.asarray(sparse_to_dense(X, cfg.V), dtype=cfg.dtype)
    fresh = init(jax.random.key(0), cfg)
    theta, result = jax.jit(
        transform_states, static_argnames=("config", "maxiter", "tol", "verbose")
    )(model.state, fresh, Xdense, model.F, cfg, maxiter=maxiter, tol=tol, verbose=verbose)
    if not bool(result.converged):
        import warnings

        warnings.warn("transform did not converge")
    return np.asarray(theta).T


def fit_heldout(Xheldout, model: ILDA, maxiter: int = 100, verbose: bool = False) -> ILDA:
    """Reference `fit_heldout` (src/ILDA.jl:323-353)."""
    heldout = ILDA(
        model.K, model.alpha, model.eta, model.features,
        [np.asarray(d) for d in Xheldout], dtype=model.config.dtype,
    )
    result = jax.jit(
        fit_heldout_states, static_argnames=("config", "maxiter", "tol", "verbose")
    )(model.state, heldout.state, heldout.Xdense, heldout.F, heldout.config,
      maxiter=maxiter, verbose=verbose)
    heldout.state = result.state
    heldout.converged = bool(result.converged)
    heldout.elbo = float(result.elbo)
    heldout.ll = float(result.ll)
    return heldout
