"""TF32 audit: every contraction on the four families' fit, fold-in and
metric paths runs at Precision.HIGHEST, or is an exact gather.

A float32 dot_general without a precision may run in TF32 on a GPU (10
mantissa bits); these tests walk the jaxprs of the f32 fit step, the
fold-in programs and the public log-likelihood / ELBO helpers, and fail on
any dot_general that does not ask for HIGHEST.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax._src import source_info_util
from jax.extend.core import ClosedJaxpr, Jaxpr

from multimodalmusig_tpu.models import ctm_base, ilda, immctm, lda, mmctm
from multimodalmusig_tpu.ops import solvers

HI = jax.lax.Precision.HIGHEST
F32 = jnp.float32

LDA_X = [np.array([[1, 5], [2, 8]]), np.array([[1, 2], [2, 5]])]
ILDA_F = np.array([[1, 1], [1, 2], [2, 1], [2, 2]])
ILDA_X = [np.array([[1, 5], [2, 8]]), np.array([[3, 2], [4, 5]])]
MM_X = [
    [np.array([[1, 5], [2, 8]]), np.array([[1, 2], [2, 5]])],
    [np.array([[3, 4], [4, 9]]), np.array([[3, 4], [4, 6]])],
]
MM_F = [ILDA_F, ILDA_F]


def _subjaxprs(params):
    for v in params.values():
        for item in v if isinstance(v, (tuple, list)) else (v,):
            if isinstance(item, ClosedJaxpr):
                yield item.jaxpr
            elif isinstance(item, Jaxpr):
                yield item


def _dots(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for sub in _subjaxprs(eqn.params):
            yield from _dots(sub)


def _is_highest(precision):
    if isinstance(precision, tuple):
        return all(p == HI for p in precision)
    return precision == HI


def _audit(fn, *args):
    jaxpr = jax.make_jaxpr(fn)(*args).jaxpr
    dots = list(_dots(jaxpr))
    loose = [
        f"{e.params['precision']} at {source_info_util.summarize(e.source_info)}"
        for e in dots
        if not _is_highest(e.params["precision"])
    ]
    assert not loose, "dot_general below HIGHEST:\n" + "\n".join(loose)
    return len(dots)


def _lda():
    m = lda.LDA(2, 0.1, 0.1, LDA_X, dtype=F32)
    return m, lda.LDA(2, 0.1, 0.1, LDA_X, dtype=F32)


def _ilda():
    m = ilda.ILDA(2, 0.1, 0.1, ILDA_F, ILDA_X, dtype=F32)
    return m, ilda.ILDA(2, 0.1, 0.1, ILDA_F, ILDA_X, dtype=F32)


def _mmctm():
    m = mmctm.MMCTM([2, 3], [0.1, 0.1], MM_X, dtype=F32)
    return m, mmctm.MMCTM([2, 3], [0.1, 0.1], MM_X, dtype=F32)


def _immctm():
    m = immctm.IMMCTM([2, 3], [0.1, 0.1], MM_F, MM_X, dtype=F32)
    return m, immctm.IMMCTM([2, 3], [0.1, 0.1], MM_F, MM_X, dtype=F32)


def _obs_mmctm(model):
    return mmctm.MMCTM([model.K[1]], [0.1], [model.V[1]],
                       [[doc[1]] for doc in MM_X], dtype=F32)


def _obs_immctm(model):
    return immctm.IMMCTM([model.K[1]], [0.1], [MM_F[1]],
                         [[doc[1]] for doc in MM_X], dtype=F32)


def _mmctm_metrics(state, X, config):
    props = mmctm.props_from(state.lam, config)
    phi = mmctm.phi_point(state.gamma)
    return (
        mmctm.modality_loglikelihoods(X, props, phi),
        mmctm.docmodality_loglikelihoods(X, props, phi),
        mmctm.doc_modality_loglikelihood(X[0][0], props[0][0], phi[0]),
        mmctm.calculate_elbo(state, X, ctm_base.counts_per_doc(X), config),
    )


def _immctm_metrics(state, X, F, config):
    return (
        immctm.modality_loglikelihoods(X, state.lam, state.gamma, F, config),
        immctm.docmodality_loglikelihoods(X, state.lam, state.gamma, F, config),
        immctm.calculate_elbo(state, X, ctm_base.counts_per_doc(X), F, config),
    )


def _case(name):
    kw = dict(maxiter=3, tol=1e-4)
    if name.startswith("lda"):
        t, n = _lda()
        fns = {
            "fit": lambda: (functools.partial(lda.fit, X=t.Xdense, config=t.config, **kw), t.state),
            "transform": lambda: (functools.partial(lda.transform_states, Xnew=n.Xdense, config=n.config, **kw), t.state, n.state),
            "heldout": lambda: (functools.partial(lda.fit_heldout_states, Xheldout=n.Xdense, config=n.config, **kw), t.state, n.state),
            "metrics": lambda: (lambda s: (
                lda.loglikelihood(t.Xdense, lda.theta_point(s), lda.beta_point(s)),
                lda.calculate_elbo(s, t.Xdense, t.config)), t.state),
        }
    elif name.startswith("ilda"):
        t, n = _ilda()
        fns = {
            "fit": lambda: (functools.partial(ilda.fit, X=t.Xdense, F=t.F, config=t.config, **kw), t.state),
            "transform": lambda: (functools.partial(ilda.transform_states, Xnew=n.Xdense, F=n.F, config=n.config, **kw), t.state, n.state),
            "heldout": lambda: (functools.partial(ilda.fit_heldout_states, Xheldout=n.Xdense, F=n.F, config=n.config, **kw), t.state, n.state),
            "metrics": lambda: (lambda s: (
                ilda.loglikelihood(t.Xdense, ilda.theta_point(s), ilda.beta_point(s), t.F),
                ilda.calculate_elbo(s, t.Xdense, t.F, t.config)), t.state),
        }
    elif name.startswith("mmctm"):
        t, n = _mmctm()
        o = _obs_mmctm(t)
        fns = {
            "fit": lambda: (functools.partial(mmctm.fit, X=t.Xdense, config=t.config, **kw), t.state),
            "transform": lambda: (functools.partial(mmctm.transform_states, Xnew=n.Xdense, config=n.config, **kw), t.state, n.state),
            "heldout": lambda: (functools.partial(mmctm.fit_heldout_states, Xheldout=n.Xdense, config=n.config, **kw), t.state, n.state),
            "predict_eta": lambda: (functools.partial(mmctm.predict_modality_eta_states, Xobs=o.Xdense, m=0, config=t.config, obs_config=o.config, **kw), t.state, o.state),
            "metrics": lambda: (functools.partial(_mmctm_metrics, X=t.Xdense, config=t.config), t.state),
        }
    else:
        t, n = _immctm()
        o = _obs_immctm(t)
        fns = {
            "fit": lambda: (functools.partial(immctm.fit, X=t.Xdense, F=t.F, config=t.config, **kw), t.state),
            "transform": lambda: (functools.partial(immctm.transform_states, Xnew=n.Xdense, F=n.F, config=n.config, **kw), t.state, n.state),
            "heldout": lambda: (functools.partial(immctm.fit_heldout_states, Xheldout=n.Xdense, F=n.F, config=n.config, **kw), t.state, n.state),
            "predict_eta": lambda: (functools.partial(immctm.predict_modality_eta_states, Xobs=o.Xdense, m=0, Fobs=o.F, config=t.config, obs_config=o.config, **kw), t.state, o.state),
            "metrics": lambda: (functools.partial(_immctm_metrics, X=t.Xdense, F=t.F, config=t.config), t.state),
        }
    return fns[name.split("_", 1)[1]]()


CASES = [
    "lda_fit", "lda_transform", "lda_heldout", "lda_metrics",
    "ilda_fit", "ilda_transform", "ilda_heldout", "ilda_metrics",
    "mmctm_fit", "mmctm_transform", "mmctm_heldout", "mmctm_predict_eta", "mmctm_metrics",
    "immctm_fit", "immctm_transform", "immctm_heldout", "immctm_predict_eta", "immctm_metrics",
]


@pytest.mark.parametrize("name", CASES)
def test_every_dot_is_highest(name):
    fn, *args = _case(name)
    assert _audit(fn, *args) > 0


def test_lambda_objective_has_no_loose_dot():
    """The public single-document λ objective and gradient keep their
    quadratic form exact (no dot below HIGHEST)."""
    mk = 3
    v = jnp.linspace(0.1, 0.3, mk, dtype=F32)
    S = jnp.eye(mk, dtype=F32) * 2.0
    for fn in (solvers.lambda_objective, solvers.lambda_grad):
        _audit(fn, v, v, v, v, 0.5 * v, S)


def test_audit_catches_default_precision():
    """The walker sees a DEFAULT-precision dot inside a while loop."""

    def f(x):
        return jax.lax.fori_loop(0, 2, lambda i, y: y @ y, x)

    with pytest.raises(AssertionError, match="below HIGHEST"):
        _audit(f, jnp.ones((3, 3), F32))
