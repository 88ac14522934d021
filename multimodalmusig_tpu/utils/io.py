"""Model checkpointing and TSV writers.

The reference's only persistence is a final-model JLD dump
(scripts/run_mmctm.jl:272-274) plus TSV writers for μ/Σ/correlation,
signatures, and proportions (run_mmctm.jl:184-240). Here:

  * `save_model` / `load_model` — full-fidelity checkpoints of any of the
    four model wrappers (config + variational state + data) as a single
    .npz; works mid-fit, enabling resume (`load_model(...).fit(...)`
    continues coordinate ascent exactly where it stopped — the reference's
    mutable-struct warm-start pattern, src/MMCTM.jl:514-520, as an API).
  * `cov2cor`, `write_mean/cov/cor/sigs/props` — the CLI's TSV outputs.
"""

from __future__ import annotations

import json
from typing import List

import jax.numpy as jnp
import numpy as np

from ..models.ilda import ILDA
from ..models.immctm import IMMCTM
from ..models.lda import LDA
from ..models.mmctm import MMCTM

__all__ = [
    "save_model",
    "load_model",
    "cov2cor",
    "topic_dataframe",
    "prop_dataframe",
    "write_mean",
    "write_cov",
    "write_cor",
    "write_sigs",
    "write_props",
]

_MODEL_TYPES = {"LDA": LDA, "ILDA": ILDA, "MMCTM": MMCTM, "IMMCTM": IMMCTM}


def _flatten_state(state, prefix: str, out: dict):
    if hasattr(state, "_asdict"):
        for name, val in state._asdict().items():
            _flatten_state(val, f"{prefix}{name}.", out)
    elif isinstance(state, tuple):
        for i, item in enumerate(state):
            _flatten_state(item, f"{prefix}{i}.", out)
    else:
        out[prefix.rstrip(".")] = np.asarray(state)


def _unflatten_into(template, prefix: str, arrays: dict, dtype):
    if hasattr(template, "_asdict"):
        return type(template)(
            **{
                name: _unflatten_into(val, f"{prefix}{name}.", arrays, dtype)
                for name, val in template._asdict().items()
            }
        )
    if isinstance(template, tuple):
        return tuple(
            _unflatten_into(item, f"{prefix}{i}.", arrays, dtype)
            for i, item in enumerate(template)
        )
    return jnp.asarray(arrays[prefix.rstrip(".")], dtype=dtype)


def save_model(path: str, model) -> None:
    """Checkpoint a model wrapper (any of LDA/ILDA/MMCTM/IMMCTM) to .npz.

    Captures everything needed to reconstruct and resume: constructor
    arguments, the sparse count data, and the full variational state.
    """
    if isinstance(model, IMMCTM):
        kind = "IMMCTM"
    elif isinstance(model, MMCTM):  # includes CTM
        kind = "MMCTM"
    elif isinstance(model, ILDA):
        kind = "ILDA"
    elif isinstance(model, LDA):
        kind = "LDA"
    else:
        raise TypeError(f"cannot checkpoint {type(model)!r}")
    arrays: dict = {}
    _flatten_state(model.state, "state.", arrays)

    meta = {"kind": kind, "dtype": np.dtype(model.config.dtype).name}
    if kind == "LDA":
        meta["ctor"] = {"k": model.K, "alpha": model.alpha, "eta": model.eta, "V": model.V}
        docs = model.X
    elif kind == "ILDA":
        meta["ctor"] = {"k": model.K, "alpha": model.alpha, "eta": model.eta}
        arrays["features"] = model.features
        docs = model.X
    elif kind == "MMCTM":
        meta["ctor"] = {"k": model.K, "alpha": model.alpha, "V": model.V}
        docs = None
    else:  # IMMCTM
        meta["ctor"] = {"k": model.K, "alpha": model.alpha}
        for m, f in enumerate(model.features):
            arrays[f"features.{m}"] = f
        docs = None

    if docs is not None:
        meta["n_docs"] = len(docs)
        for d, doc in enumerate(docs):
            arrays[f"X.{d}"] = np.asarray(doc)
    else:
        meta["n_docs"] = len(model.X)
        meta["n_modalities"] = model.M
        for d, doc in enumerate(model.X):
            for m in range(model.M):
                arrays[f"X.{d}.{m}"] = np.asarray(doc[m])

    meta["fitted"] = {
        "converged": bool(model.converged),
        "elbo": model.elbo,
        "ll": model.ll,
    }
    def _np_default(o):
        if isinstance(o, np.generic):
            return o.item()
        raise TypeError(f"not JSON serializable: {type(o)}")

    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta, default=_np_default).encode(), dtype=np.uint8
    )
    np.savez_compressed(path, **arrays)


def load_model(path: str):
    """Reconstruct a model wrapper from a save_model checkpoint."""
    with np.load(path, allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files}
    meta = json.loads(bytes(arrays.pop("__meta__")).decode())
    kind, ctor = meta["kind"], meta["ctor"]
    dtype = jnp.dtype(meta["dtype"])

    if kind == "LDA":
        X = [arrays[f"X.{d}"] for d in range(meta["n_docs"])]
        model = LDA(ctor["k"], ctor["alpha"], ctor["eta"], ctor["V"], X, dtype=dtype)
    elif kind == "ILDA":
        X = [arrays[f"X.{d}"] for d in range(meta["n_docs"])]
        model = ILDA(ctor["k"], ctor["alpha"], ctor["eta"], arrays["features"], X, dtype=dtype)
    elif kind == "MMCTM":
        X = [
            [arrays[f"X.{d}.{m}"] for m in range(meta["n_modalities"])]
            for d in range(meta["n_docs"])
        ]
        model = MMCTM(ctor["k"], ctor["alpha"], ctor["V"], X, dtype=dtype)
    elif kind == "IMMCTM":
        X = [
            [arrays[f"X.{d}.{m}"] for m in range(meta["n_modalities"])]
            for d in range(meta["n_docs"])
        ]
        features = [arrays[f"features.{m}"] for m in range(meta["n_modalities"])]
        model = IMMCTM(ctor["k"], ctor["alpha"], features, X, dtype=dtype)
    else:
        raise ValueError(f"unknown model kind {kind!r}")

    model.state = _unflatten_into(model.state, "state.", arrays, dtype)
    fitted = meta["fitted"]
    model.converged = fitted["converged"]
    model.elbo = fitted["elbo"]
    model.ll = fitted["ll"]
    return model


# ---------------------------------------------------------------------------
# TSV writers mirroring the CLI outputs (run_mmctm.jl:184-240, 272-290)
# ---------------------------------------------------------------------------


def cov2cor(C: np.ndarray) -> np.ndarray:
    """Covariance -> correlation (run_mmctm.jl:184-187)."""
    C = np.asarray(C)
    sigma = np.sqrt(np.diag(C))
    return C / np.outer(sigma, sigma)


def _topic_rows(model: MMCTM, terms: List[List[str]], modalities: List[str]):
    rows = []
    gamma = model.gamma
    for m in range(model.M):
        for k in range(model.K[m]):
            g = np.asarray(gamma[m][k], dtype=np.float64)
            probs = g / g.sum()
            for v in range(model.V[m]):
                rows.append(
                    (modalities[m], k + 1, v + 1, terms[m][v], float(probs[v]))
                )
    return rows


_TOPIC_COLUMNS = ["modality", "topic", "value", "term", "probability"]


def _prop_table(model: MMCTM, modalities: List[str]):
    props = np.empty((sum(model.K), model.D))
    for d, lam in enumerate(model.lam):
        start = 0
        for m in range(model.M):
            stop = start + model.K[m]
            e = np.exp(lam[start:stop] - lam[start:stop].max())
            props[start:stop, d] = e / e.sum()
            start = stop
    labels = [
        f"{modalities[m]}-{k + 1}" for m in range(model.M) for k in range(model.K[m])
    ]
    return labels, props


def topic_dataframe(model: MMCTM, terms: List[List[str]], modalities: List[str]):
    """Tidy signature table (run_mmctm.jl:189-209): one row per
    modality x topic x vocab item with its probability."""
    import pandas as pd

    return pd.DataFrame(_topic_rows(model, terms, modalities), columns=_TOPIC_COLUMNS)


def prop_dataframe(model: MMCTM, samples: List[str], modalities: List[str]):
    """Per-sample signature proportions: softmax of λ per modality block
    (run_mmctm.jl:216-240)."""
    import pandas as pd

    labels, props = _prop_table(model, modalities)
    df = pd.DataFrame(props, columns=samples)
    df.insert(0, "topic", labels)
    return df


def _write_tsv(path, header, rows):
    """A tab-separated table, formatted as pandas' to_csv(sep="\t",
    index=False) writes it, without needing pandas."""
    import csv

    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n")
        w.writerow(header)
        w.writerows(rows)


def write_mean(path, model):
    np.savetxt(path, model.mu, delimiter="\t")


def write_cov(path, model):
    np.savetxt(path, model.Sigma, delimiter="\t")


def write_cor(path, model):
    np.savetxt(path, cov2cor(model.Sigma), delimiter="\t")


def write_sigs(path, model, terms, modalities):
    _write_tsv(path, _TOPIC_COLUMNS, _topic_rows(model, terms, modalities))


def write_props(path, model, samples, modalities):
    labels, props = _prop_table(model, modalities)
    _write_tsv(
        path, ["topic", *samples],
        ([label, *map(float, row)] for label, row in zip(labels, props)),
    )
