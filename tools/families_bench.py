"""Restart-scale per-family benchmarks on the bundled BRCA-EU data.

Each family runs its production best-of-N entry point
(parallel/restarts.py) at R restarts on the real data: LDA and ILDA
best-of-N with f64-rescored argmax selection, IMMCTM with the dense-rank
selection, MMCTM two-stage for completeness (bench.py's fit-only numbers
are the headline; this one includes selection + rescoring). Feature
factorizations for ILDA/IMMCTM match chip_smoke.py (substitution
x trinucleotide context for SNV, type x size/region for SV — the shape the
reference's fixtures use, test/ilda.jl:4-22, test/immctm.jl:6-51).

Walls are warm (each arm runs twice; the second is timed), include
selection/rescoring, and exclude compile. Prints one JSON object per
family and one for the run.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from multimodalmusig_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--restarts", type=int, default=100)
    ap.add_argument("--maxiter", type=int, default=1000)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--auto", action="store_true",
                    help="run every family with compact_schedule='auto' "
                         "(folded-pilot zero-config compaction)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import pandas as pd

    import multimodalmusig_tpu as mm
    from multimodalmusig_tpu.parallel.restarts import (
        fit_ilda_restarts,
        fit_immctm_restarts,
        fit_lda_restarts,
        fit_mmctm_restarts,
    )
    from multimodalmusig_tpu.utils.data import brca_counts_path

    snv = pd.read_csv(brca_counts_path("brca-eu_snv_counts.tsv"), sep="\t")
    sv = pd.read_csv(brca_counts_path("brca-eu_sv_counts.tsv"), sep="\t")
    cols = list(snv.columns[1:])
    X_lda = mm.format_counts_lda(snv, cols)
    X_mm = mm.format_counts_mmctm([snv, sv], cols)

    terms = snv["term"].tolist()
    subs = sorted({t.split("[")[1].split("]")[0] for t in terms})
    ctx = sorted({t.split("[")[0] + "_" + t.split("]")[1] for t in terms})
    feats = np.array([[subs.index(t.split("[")[1].split("]")[0]) + 1,
                       ctx.index(t.split("[")[0] + "_" + t.split("]")[1]) + 1]
                      for t in terms])
    sv_terms = sv["term"].tolist()
    svt = sorted({t.split(":")[0] for t in sv_terms})
    svr = sorted({":".join(t.split(":")[1:]) for t in sv_terms})
    feats_sv = np.array([[svt.index(t.split(":")[0]) + 1,
                          svr.index(":".join(t.split(":")[1:])) + 1]
                         for t in sv_terms])

    R = args.restarts
    kw = dict(restarts=R, maxiter=args.maxiter, tol=args.tol)
    if args.auto:
        kw["compact_schedule"] = "auto"
    arms = {
        "lda": lambda: fit_lda_restarts(7, 0.1, 0.1, X_lda, **kw),
        "ilda": lambda: fit_ilda_restarts(7, 0.1, 0.1, feats, X_lda, **kw),
        "immctm": lambda: fit_immctm_restarts(
            [7, 7], [0.1, 0.1], [feats, feats_sv], X_mm, **kw),
        # two-stage MMCTM incl. stage-2 refit + both f64-rescored selections
        "mmctm_two_stage": lambda: fit_mmctm_restarts(
            [7, 7], [0.1, 0.1], X_mm, restarts=R, maxiter=args.maxiter,
            compact_schedule="auto" if args.auto else None),
    }
    out = {"platform": jax.devices()[0].platform, "restarts": R,
           "tol": args.tol, "auto": bool(args.auto)}
    for name, fn in arms.items():
        fn()  # compile + warm
        t0 = time.perf_counter()
        model = fn()
        t = time.perf_counter() - t0
        ll = np.asarray(model.ll, dtype=np.float64).reshape(-1)
        out[name] = {
            "wall_s": round(t, 3),
            "restarts_per_sec": round(R / t, 1),
            "selected_ll": [float(v) for v in ll],
            "finite": bool(np.isfinite(ll).all()),
        }
        info = getattr(model, "compact_info", None)
        if args.auto and info:
            out[name]["derived_schedule"] = [int(s) for s in info["schedule"]]
            out[name]["pilot_restarts"] = int(info["pilot_restarts"])
        print(name, json.dumps(out[name]))

    print(json.dumps(out))


if __name__ == "__main__":
    main()
