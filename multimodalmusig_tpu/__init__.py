"""multimodalmusig_tpu — multi-modal mutation-signature topic models in JAX.

A from-scratch JAX/XLA/Pallas re-architecture of the capabilities of
shahcompbio/MultiModalMuSig.jl (reference mounted at /root/reference): four
Bayesian topic models (LDA, ILDA, MMCTM, IMMCTM) fit by coordinate-ascent
variational inference, with the reference's public surface
(src/MultiModalMuSig.jl:9 exports) plus accelerator extensions (vmapped
multi-restart fitting, device-mesh sharding, jitted fit loops) for NVIDIA
GPUs.
"""

from .models.ilda import ILDA, fit_heldout as ilda_fit_heldout, transform as ilda_transform
from .models.immctm import (
    IMMCTM,
    fit_heldout as immctm_fit_heldout,
    predict_modality_eta as immctm_predict_modality_eta,
    transform as immctm_transform,
)
from .models.lda import LDA, fit_heldout as lda_fit_heldout, transform as lda_transform
from .models.mmctm import (
    CTM,
    MMCTM,
    fit_heldout as mmctm_fit_heldout,
    predict_modality_eta as mmctm_predict_modality_eta,
    transform as mmctm_transform,
)
from .parallel.restarts import (
    fit_ilda_restarts,
    fit_immctm_restarts,
    fit_lda_restarts,
    fit_mmctm_restarts,
    suggest_compact_schedule,
)
from .utils.formatting import (
    format_counts_ctm,
    format_counts_lda,
    format_counts_mmctm,
    make_count_matrix,
)
from .utils.io import load_model, save_model

# Single source of the version: pyproject.toml reads this attribute via
# [tool.setuptools.dynamic] (matches the reference Project.toml:4 v0.3.0).
__version__ = "0.3.0"

__all__ = [
    "LDA",
    "ILDA",
    "CTM",
    "MMCTM",
    "IMMCTM",
    "format_counts_lda",
    "format_counts_ctm",
    "format_counts_mmctm",
    "make_count_matrix",
    "transform",
    "fit_heldout",
    "predict_modality_eta",
    "fit_mmctm_restarts",
    "fit_lda_restarts",
    "fit_ilda_restarts",
    "fit_immctm_restarts",
    "suggest_compact_schedule",
    "save_model",
    "load_model",
    "calculate_elbo",
    "calculate_loglikelihood",
    "calculate_loglikelihoods",
    "calculate_docmodality_loglikelihoods",
]

# Generic dispatch mirroring Julia's multiple dispatch on fit!/transform/...
_TRANSFORM_DISPATCH = {
    LDA: lda_transform,
    ILDA: ilda_transform,
    MMCTM: mmctm_transform,
    IMMCTM: immctm_transform,
}
_FIT_HELDOUT_DISPATCH = {
    LDA: lda_fit_heldout,
    ILDA: ilda_fit_heldout,
    MMCTM: mmctm_fit_heldout,
    IMMCTM: immctm_fit_heldout,
}


def transform(model, X, **kwargs):
    """Dispatch to the model-specific transform (reference: `transform` methods)."""
    for cls, fn in _TRANSFORM_DISPATCH.items():
        if isinstance(model, cls):
            return fn(model, X, **kwargs)
    raise TypeError(f"no transform for {type(model)!r}")


def fit_heldout(Xheldout, model, **kwargs):
    """Dispatch to the model-specific fit_heldout (reference: `fit_heldout`)."""
    for cls, fn in _FIT_HELDOUT_DISPATCH.items():
        if isinstance(model, cls):
            return fn(Xheldout, model, **kwargs)
    raise TypeError(f"no fit_heldout for {type(model)!r}")


def predict_modality_eta(Xobs, m, model, **kwargs):
    """Dispatch `predict_modality_η(Xobs, m, model)` (1-based m, as in Julia)."""
    if isinstance(model, IMMCTM):
        return immctm_predict_modality_eta(Xobs, m, model, **kwargs)
    if isinstance(model, MMCTM):
        return mmctm_predict_modality_eta(Xobs, m, model, **kwargs)
    raise TypeError(f"no predict_modality_eta for {type(model)!r}")


def calculate_elbo(model):
    """ELBO of the model's current variational state (reference:
    `calculate_elbo` methods, e.g. src/MMCTM.jl:372-382)."""
    import jax.numpy as jnp

    from .models import ctm_base, ilda as ilda_m, immctm as immctm_m, lda as lda_m
    from .models import mmctm as mmctm_m

    if isinstance(model, IMMCTM):
        N = ctm_base.counts_per_doc(model.Xdense)
        return float(immctm_m.calculate_elbo(model.state, model.Xdense, N, model.F, model.config))
    if isinstance(model, MMCTM):
        N = ctm_base.counts_per_doc(model.Xdense)
        return float(mmctm_m.calculate_elbo(model.state, model.Xdense, N, model.config))
    if isinstance(model, ILDA):
        return float(ilda_m.calculate_elbo(model.state, model.Xdense, model.F, model.config))
    if isinstance(model, LDA):
        return float(lda_m.calculate_elbo(model.state, model.Xdense, model.config))
    raise TypeError(f"no calculate_elbo for {type(model)!r}")


def calculate_loglikelihood(*args):
    """LDA/ILDA per-word log-likelihood: `calculate_loglikelihood(model)` or
    `calculate_loglikelihood(X, model)` (src/LDA.jl:174-196,
    src/ILDA.jl:209-236)."""
    import jax.numpy as jnp

    from .models import ilda as ilda_m, lda as lda_m
    from .utils.formatting import sparse_to_dense

    model = args[-1]
    if isinstance(model, ILDA):
        Xd = (
            model.Xdense
            if len(args) == 1
            else jnp.asarray(sparse_to_dense(args[0], model.V), model.config.dtype)
        )
        return float(
            ilda_m.loglikelihood(
                Xd, ilda_m.theta_point(model.state), ilda_m.beta_point(model.state), model.F
            )
        )
    if isinstance(model, LDA):
        Xd = (
            model.Xdense
            if len(args) == 1
            else jnp.asarray(sparse_to_dense(args[0], model.V), model.config.dtype)
        )
        return float(
            lda_m.loglikelihood(Xd, lda_m.theta_point(model.state), lda_m.beta_point(model.state))
        )
    raise TypeError(f"no calculate_loglikelihood for {type(model)!r}")


def calculate_loglikelihoods(*args):
    """MMCTM/IMMCTM per-modality log-likelihoods:
    `calculate_loglikelihoods(model)` or `(X, model)`
    (src/MMCTM.jl:384-448, src/IMMCTM.jl:388-428)."""
    import jax.numpy as jnp
    import numpy as np

    from .models import immctm as immctm_m, mmctm as mmctm_m
    from .utils.formatting import sparse_to_dense

    model = args[-1]
    if len(args) == 1:
        Xd = model.Xdense
    else:
        X = args[0]
        Xd = tuple(
            jnp.asarray(
                sparse_to_dense([doc[m] for doc in X], model.V[m]), model.config.dtype
            )
            for m in range(model.M)
        )
    if isinstance(model, IMMCTM):
        ll = immctm_m.modality_loglikelihoods(
            Xd, model.state.lam, model.state.gamma, model.F, model.config
        )
    elif isinstance(model, MMCTM):
        ll = mmctm_m.modality_loglikelihoods(
            Xd,
            mmctm_m.props_from(model.state.lam, model.config),
            mmctm_m.phi_point(model.state.gamma),
        )
    else:
        raise TypeError(f"no calculate_loglikelihoods for {type(model)!r}")
    return list(np.asarray(ll, dtype=np.float64))


def calculate_docmodality_loglikelihoods(*args):
    """MMCTM/IMMCTM per-document per-modality normalized log-likelihoods as a
    (D, M) array: `calculate_docmodality_loglikelihoods(model)` or
    `(X, model)` — the full matrix behind the reference's
    `calculate_docmodality_loglikelihood` (src/MMCTM.jl:384-401,
    src/IMMCTM.jl:362-386). Documents with zero counts in a modality get
    NaN, matching the reference's division by N_d=0 (its modality-level
    aggregation skips such docs)."""
    import jax.numpy as jnp
    import numpy as np

    from .models import immctm as immctm_m, mmctm as mmctm_m
    from .utils.formatting import sparse_to_dense

    model = args[-1]
    if len(args) == 1:
        Xd = model.Xdense
    else:
        X = args[0]
        Xd = tuple(
            jnp.asarray(
                sparse_to_dense([doc[m] for doc in X], model.V[m]), model.config.dtype
            )
            for m in range(model.M)
        )
    if isinstance(model, IMMCTM):
        ll = immctm_m.docmodality_loglikelihoods(
            Xd, model.state.lam, model.state.gamma, model.F, model.config
        )
    elif isinstance(model, MMCTM):
        ll = mmctm_m.docmodality_loglikelihoods(
            Xd,
            mmctm_m.props_from(model.state.lam, model.config),
            mmctm_m.phi_point(model.state.gamma),
        )
    else:
        raise TypeError(f"no calculate_docmodality_loglikelihoods for {type(model)!r}")
    return np.asarray(ll, dtype=np.float64)
