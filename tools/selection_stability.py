"""Selection stability under straggler compaction.

Compacted phases are separate executables whose f32 rounding differs from
the single-dispatch fit; hundreds of CAVI iterations amplify that on a few
lanes' final ll. This tool measures whether that drift can FLIP the
restart selection: it runs schedule vs no-schedule at the same seed and
compares (a) the per-modality stage-1 winners (pick_optimal_modality_restarts
— what gets grafted into stage 2, run_mmctm.jl:86-97) and (b) the dense-rank
pick (pick_optimal_model's criterion, run_mmctm.jl:136-147), and quantifies
the near-tie margin: the winner's ll lead over the runner-up vs the maximum
cross-run ll drift. A lead >> drift means selection is robust; a lead within
drift is a genuine near-tie where either pick is defensible. The
compacted arm uses the zero-config schedule (fit_restarts_auto). Prints the
records as JSON.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from multimodalmusig_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax
import jax.numpy as jnp
import numpy as np


def compare(R, X, config, alpha, maxiter, tol):
    from multimodalmusig_tpu.parallel.rescore import (
        pick_optimal_modality_restarts_np,
        pick_optimal_restart_np,
        rescore_mmctm,
    )
    from multimodalmusig_tpu.parallel.restarts import (
        fit_restarts,
        fit_restarts_auto,
        pick_optimal_modality_restarts,
        pick_optimal_restart,
    )

    key = jax.random.key(147959412)
    lls, lls64 = {}, {}
    kw = dict(restarts=R, maxiter=maxiter, tol=tol)
    runs = {"unchunked": lambda: fit_restarts(key, X, config, alpha, **kw),
            "schedule": lambda: fit_restarts_auto(key, X, config, alpha, **kw)[0]}
    for label, run in runs.items():
        t0 = time.perf_counter()
        result = run()
        ll = np.asarray(jax.device_get(result.ll), np.float64)
        lls[label] = ll
        t_fit = time.perf_counter() - t0
        # exact f64 re-scoring of EVERY lane via the PRODUCTION executor
        # dispatch (device-side on an accelerator — what selection reads)
        t0 = time.perf_counter()
        lls64[label] = rescore_mmctm(
            result.state.lam, result.state.gamma, X, config
        )
        print(f"R={R} {label}: fit {t_fit:.2f}s rescore "
              f"{time.perf_counter() - t0:.2f}s "
              f"finite={np.isfinite(ll).all(axis=1).sum()}/{R}")

    a, b = lls["unchunked"], lls["schedule"]
    a64, b64 = lls64["unchunked"], lls64["schedule"]
    finite = np.isfinite(a).all(axis=1) & np.isfinite(b).all(axis=1)
    drift = float(np.max(np.abs(a[finite] - b[finite]))) if finite.any() else float("nan")
    # state-only drift: exact scoring of both arms' states — what remains
    # after the executable-dependent f32 scoring noise is removed
    state_drift = (
        float(np.max(np.abs(a64[finite] - b64[finite]))) if finite.any() else float("nan")
    )
    # scoring-only noise: f32 in-fit metric vs exact f64 score of the SAME state
    score_noise = float(
        max(np.max(np.abs(a[finite] - a64[finite])),
            np.max(np.abs(b[finite] - b64[finite])))
    ) if finite.any() else float("nan")

    win_a = np.asarray(pick_optimal_modality_restarts(jnp.asarray(a)))
    win_b = np.asarray(pick_optimal_modality_restarts(jnp.asarray(b)))
    pick_a = int(pick_optimal_restart(jnp.asarray(a)))
    pick_b = int(pick_optimal_restart(jnp.asarray(b)))
    win_a64 = pick_optimal_modality_restarts_np(a64)
    win_b64 = pick_optimal_modality_restarts_np(b64)
    pick_a64 = pick_optimal_restart_np(a64)
    pick_b64 = pick_optimal_restart_np(b64)

    # near-tie margin: winner's lead over the runner-up, per modality
    def margins_of(ll):
        out = []
        for m in range(ll.shape[1]):
            col = np.where(np.isfinite(ll[:, m]), ll[:, m], -np.inf)
            top2 = np.sort(col)[-2:]
            out.append(float(top2[1] - top2[0]))
        return out

    margins = margins_of(a)
    margins64 = margins_of(a64)

    rec = {
        "R": R,
        "schedule": list(schedule),
        # f32 in-fit metric picks
        "stage1_winners_agree": bool((win_a == win_b).all()),
        "winners_unchunked": win_a.tolist(),
        "winners_schedule": win_b.tolist(),
        "dense_rank_pick_agrees": pick_a == pick_b,
        "pick_unchunked": pick_a,
        "pick_schedule": pick_b,
        # exact f64 host re-scores (what selection reads)
        "stage1_winners_agree_f64": bool((win_a64 == win_b64).all()),
        "winners_unchunked_f64": win_a64.tolist(),
        "winners_schedule_f64": win_b64.tolist(),
        "dense_rank_pick_agrees_f64": pick_a64 == pick_b64,
        "pick_unchunked_f64": pick_a64,
        "pick_schedule_f64": pick_b64,
        "max_crossrun_ll_drift": drift,
        "max_crossrun_state_drift_f64": state_drift,
        "max_f32_scoring_noise": score_noise,
        "winner_margins": margins,
        "winner_margins_f64": margins64,
        "margin_over_drift": [m / drift if drift > 0 else float("inf") for m in margins],
        "margin_over_state_drift_f64": [
            m / state_drift if state_drift > 0 else float("inf") for m in margins64
        ],
    }
    print(json.dumps(rec, indent=2))
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-r1000", action="store_true")
    args = ap.parse_args()

    from bench import load_counts_np
    from multimodalmusig_tpu.models.mmctm import MMCTMConfig

    Xnp = load_counts_np()
    config = MMCTMConfig(
        K=(7, 7), V=(Xnp[0].shape[1], Xnp[1].shape[1]), D=Xnp[0].shape[0],
        dtype=jnp.float32,
    )
    X = tuple(jnp.asarray(x, jnp.float32) for x in Xnp)
    alpha = jnp.asarray([0.1, 0.1], jnp.float32)

    recs = {"platform": jax.devices()[0].platform}
    recs["r100"] = compare(100, X, config, alpha, 1000, 1e-5)
    if not args.skip_r1000:
        recs["r1000"] = compare(1000, X, config, alpha, 1000, 1e-5)
    print(json.dumps(recs))


if __name__ == "__main__":
    main()
