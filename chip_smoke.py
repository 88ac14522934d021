#!/usr/bin/env python3
"""Smoke run of the CAVI fit path on one NVIDIA GPU.

    python chip_smoke.py               # phases 1-5 on one card
    python chip_smoke.py --four-cards  # the four-card phase alone

Phases (each must pass; any failure exits non-zero and prints no result):
  1. device    the default JAX device is a GPU; nothing runs on a CPU.
  2. kernel    the fused λ kernel (Pallas through Triton), compiled at the
               BRCA (R=1000 x D=560 x MK=14) and PCAWG-shaped (R=100 x
               D=2800 x MK=19) widths, against ops.solvers.maximize_lambda
               with exact-f32 matvecs; then the R=1000 BRCA fit with the
               kernel off and on, alternating.
  3. main      `run-mmctm` (cli.main) on the bundled BRCA-EU TSVs at
               --restarts 1000 --auto-compact; every output written and
               finite; the selected model's per-modality log-likelihoods,
               rescored in f64 on the device, match the host numpy rescoring.
  4. trajectory one MMCTM lane on BRCA, 20 CAVI iterations in f32 (kernel on
               and off) from a fixed initialisation, against the float64 path
               with the same solver budgets: no TF32 on the path. A negative
               control, the same program with every contraction at TF32,
               must fail the same limit.
  5. families  LDA, ILDA and IMMCTM best-of-100 through their public fitters;
               transform, fit_heldout and predict_modality_eta on the fitted
               MMCTM; everything finite, device and host f64 scores agree.
  --four-cards: MMCTM restart fan-out at R=1000 (shard_map, kernel inside),
               fit_immctm_restarts(devices=...) and sharded_data_parallel_fit
               on the PCAWG-shaped cohort, each against one card.

Wall times printed as "smoke timing" are set-up-inclusive smoke timings,
not the benchmark. The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import argparse
import contextlib
import csv
import dataclasses
import functools
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

# Tolerances, with the precision each compares at.
# Kernel vs reference, both exact float32: at the full (cold-start) budgets
# both converge to the same optimum, so max |Δλ| is float32 rounding; at the
# warm-start budgets (3 Newton steps x 4 PCG iterations) the truncated solve
# and the discrete line-search choice amplify rounding on a few documents.
TOL_KERNEL_COLD = 5e-5
TOL_KERNEL_WARM = 2e-3
# f64 scores of one state on the device vs on the host: reduction order only.
TOL_RESCORE = 1e-9
# f32 vs f64 CAVI trajectory, relative, per modality, over TRAJ_ITERS
# iterations. Exact float32 drifts ~2e-7; the same program with every
# contraction at TF32 drifts ~2e-5 (both measured on an H100). Phase 4 runs
# that TF32 program as a negative control and fails unless it exceeds the
# limit, so the check is shown to see TF32 on every run.
TOL_TRAJECTORY = 1e-6
TRAJ_ITERS = 20
# One card vs four: same math, f32 rounding of different executables, over
# FOUR_CARD_ITERS CAVI iterations (measured 1.6e-7 to 2.3e-7 on H100s).
TOL_FOUR_CARDS = 1e-6
FOUR_CARD_ITERS = 20
SEED = 147959412


def say(*a):
    print(*a, flush=True)


def timed(name, fn, timings):
    t0 = time.perf_counter()
    out = fn()
    timings[name] = time.perf_counter() - t0
    say(f"smoke timing: {name} {timings[name]:.1f} s")
    return out


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def nvidia_smi_line():
    """The card's name and power limit, read by nvidia-smi (no JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def brca():
    """[(counts (V, D), terms, samples)] for SNV and SV."""
    from multimodalmusig_tpu.utils.data import brca_counts_path
    from multimodalmusig_tpu.utils.fast_tsv import read_counts_tsv

    return [read_counts_tsv(brca_counts_path(f))
            for f in ("brca-eu_snv_counts.tsv", "brca-eu_sv_counts.tsv")]


def brca_features(snv_terms, sv_terms):
    """Feature factorizations (substitution x context for SNV, type x
    size/region for SV) as 1-based (V, 2) integer tables."""
    import numpy as np

    subs = sorted({t.split("[")[1].split("]")[0] for t in snv_terms})
    ctx = sorted({t.split("[")[0] + "_" + t.split("]")[1] for t in snv_terms})
    f_snv = np.array([[subs.index(t.split("[")[1].split("]")[0]) + 1,
                       ctx.index(t.split("[")[0] + "_" + t.split("]")[1]) + 1]
                      for t in snv_terms])
    svt = sorted({t.split(":")[0] for t in sv_terms})
    svr = sorted({":".join(t.split(":")[1:]) for t in sv_terms})
    f_sv = np.array([[svt.index(t.split(":")[0]) + 1,
                      svr.index(":".join(t.split(":")[1:])) + 1]
                     for t in sv_terms])
    return f_snv, f_sv


def pcawg(D=2800):
    import numpy as np
    from pcawg_bench import synthesize_corpus

    return synthesize_corpus(np.random.default_rng(0), D, (96, 48, 24), (7, 7, 5))


def lambda_inputs(Xnp, K, R, iters=3, seed=0):
    """Realistic λ-solve inputs: R lanes after `iters` CAVI iterations, with
    ζ, N/ζ, the ν solve and sumθ computed as solve_eta does."""
    import jax
    import jax.numpy as jnp

    from multimodalmusig_tpu.models import mmctm as mm
    from multimodalmusig_tpu.models.ctm_base import (
        calculate_Ndivzeta, theta_moments, update_zeta)
    from multimodalmusig_tpu.ops.solvers import maximize_nu

    X = tuple(jnp.asarray(x, jnp.float32) for x in Xnp)
    config = mm.MMCTMConfig(K=K, V=tuple(x.shape[1] for x in Xnp),
                            D=Xnp[0].shape[0], dtype=jnp.float32, force_fused=False)
    alpha = jnp.full((len(K),), 0.1, jnp.float32)
    N = mm.counts_per_doc(X)

    @jax.jit
    def build(keys):
        def one(k):
            st = mm.init_with_alpha(k, config, X, alpha)
            st = mm.fit(st, X, config, maxiter=iters, tol=0.0).state
            sumtheta, _ = theta_moments(st.lam, mm.smoothed_logw(st), X, config,
                                        want_scatter=False)
            ndz = calculate_Ndivzeta(N, update_zeta(st.lam, st.nu, config), config)
            nu2 = maximize_nu(st.nu, st.lam, ndz, jnp.diagonal(st.invSigma)[None, :],
                              n_iter=4)
            return st.lam, nu2, ndz, sumtheta, st.mu, st.invSigma
        return jax.vmap(one)(keys)

    return config, build(jax.random.split(jax.random.key(seed), R))


def median_time(fn, args, reps=20):
    import jax
    import numpy as np

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


# ---------------------------------------------------------------------------
# phase 2: kernel
# ---------------------------------------------------------------------------


def kernel_width(label, Xnp, K, R):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from multimodalmusig_tpu.models.ctm_base import resolved_budgets
    from multimodalmusig_tpu.ops.pallas.lambda_kernel import maximize_lambda_fused
    from multimodalmusig_tpu.ops.solvers import lambda_grad, maximize_lambda

    config, args = lambda_inputs(Xnp, K, R)
    b = resolved_budgets(config)
    warm = dict(n_iter=b["lambda_n_iter"], cg_iter=b["lambda_cg_iter"],
                polish_iter=b["lambda_polish_iter"])
    grad = jax.jit(jax.vmap(jax.vmap(lambda_grad, (0, 0, 0, 0, None, None))))
    for budget, kw, tol in (("warm", warm, TOL_KERNEL_WARM), ("cold", {}, TOL_KERNEL_COLD)):
        ref_fn = jax.jit(jax.vmap(functools.partial(maximize_lambda, **kw)))
        fused_fn = jax.jit(functools.partial(maximize_lambda_fused, **kw))
        with jax.default_matmul_precision("highest"):
            ref = ref_fn(*args)
            t_xla = median_time(ref_fn, args)
        got = fused_fn(*args)
        err = float(jnp.max(jnp.abs(got - ref)))
        t_fused = median_time(fused_fn, args)
        say(f"kernel {label} {budget} budgets {kw or 'default'}: max|dlam| {err:.3e} "
            f"(tol {tol:g}); XLA {t_xla * 1e3:.3f} ms, fused {t_fused * 1e3:.3f} ms "
            f"({t_xla / t_fused:.2f}x)")
        check(err <= tol, f"kernel {label} {budget}: max|dlam| {err} > {tol}")
        if budget == "cold":
            lam, nu, ndz, st, mu, invS = args
            with jax.default_matmul_precision("highest"):
                g_ref = float(jnp.max(jnp.abs(grad(ref, nu, ndz, st, mu, invS))))
                g_fused = float(jnp.max(jnp.abs(grad(got, nu, ndz, st, mu, invS))))
            say(f"kernel {label} stationarity max|grad|: fused {g_fused:.3e}, "
                f"XLA {g_ref:.3e}")
            check(g_fused <= 2.0 * g_ref + 1e-3,
                  f"kernel {label}: gradient {g_fused} vs reference {g_ref}")
        else:
            ma = fused_fn.lower(*args).compile().memory_analysis()
            say(f"kernel {label} memory_analysis: {ma}")
    check(np.isfinite(np.asarray(got)).all(), f"kernel {label}: non-finite λ")


def fit_ab(Xnp, R=1000):
    """R=1000 BRCA fit, kernel off/on, alternating (each arm its own
    force_fused executable), unchunked to tol 1e-4."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from multimodalmusig_tpu.models.mmctm import MMCTMConfig
    from multimodalmusig_tpu.parallel.restarts import fit_restarts

    X = tuple(jnp.asarray(x, jnp.float32) for x in Xnp)
    base = MMCTMConfig(K=(7, 7), V=(96, 48), D=X[0].shape[0], dtype=jnp.float32)
    alpha = jnp.asarray([0.1, 0.1], jnp.float32)
    arms = {"xla": dataclasses.replace(base, force_fused=False),
            "fused": dataclasses.replace(base, force_fused=True)}

    def run(cfg):
        r = fit_restarts(jax.random.key(SEED), X, cfg, alpha, restarts=R,
                         maxiter=1000, tol=1e-4)
        return r, np.asarray(r.ll)

    for name, cfg in arms.items():
        t0 = time.perf_counter()
        r, ll = run(cfg)
        it = np.asarray(r.n_iters)
        say(f"fit A/B {name}: first call (compile + fit) {time.perf_counter() - t0:.1f} s; "
            f"finite lanes {int(np.isfinite(ll).all(1).sum())}/{R}, iterations "
            f"median {np.median(it):.0f} max {it.max()}, best ll {np.nanmax(ll, 0)}")
        check(np.isfinite(ll).all(1).mean() > 0.99, f"fit A/B {name}: lanes not finite")
    walls = {k: [] for k in arms}
    for name in ("xla", "fused", "fused", "xla", "xla", "fused"):
        t0 = time.perf_counter()
        run(arms[name])
        walls[name].append(time.perf_counter() - t0)
    say(f"fit A/B R={R} BRCA walls (s): " + json.dumps(walls))
    say(f"fit A/B median: xla {np.median(walls['xla']):.4f} s, fused "
        f"{np.median(walls['fused']):.4f} s")


def phase_kernel(data, brca_R=1000, pcawg_R=100, pcawg_D=2800):
    Xb = [c.T.astype("float32") for c, _, _ in data]
    kernel_width(f"BRCA R={brca_R} D={Xb[0].shape[0]} MK=14", Xb, (7, 7), brca_R)
    kernel_width(f"PCAWG R={pcawg_R} D={pcawg_D} MK=19", pcawg(pcawg_D), (7, 7, 5),
                 pcawg_R)
    fit_ab(Xb, brca_R)


# ---------------------------------------------------------------------------
# phase 3: the CLI
# ---------------------------------------------------------------------------


def rescore_pair_mmctm(model):
    """(device, host) f64 per-modality lls of an MMCTM wrapper's state."""
    import numpy as np

    from multimodalmusig_tpu.parallel.rescore import rescore_mmctm_f64
    from multimodalmusig_tpu.parallel.rescore_device import rescore_mmctm_f64_dev

    lam = np.asarray(model.state.lam)[None]
    gamma = tuple(np.asarray(g)[None] for g in model.state.gamma)
    X = [np.asarray(x) for x in model.Xdense]
    dev = rescore_mmctm_f64_dev(lam, gamma, X, model.config)
    host = rescore_mmctm_f64(lam, gamma, X, model.config)
    return dev[0], host[0]


def agree(label, dev, host):
    import numpy as np

    dev, host = np.asarray(dev, np.float64), np.asarray(host, np.float64)
    rel = float(np.max(np.abs(dev - host) / np.abs(host)))
    say(f"{label}: f64 device {dev} vs host {host}, max rel {rel:.2e} (tol {TOL_RESCORE:g})")
    check(np.isfinite(dev).all() and np.isfinite(host).all(), f"{label}: non-finite")
    check(rel <= TOL_RESCORE, f"{label}: device/host f64 disagree ({rel})")


def phase_cli(out_dir, restarts=1000):
    import numpy as np

    from multimodalmusig_tpu import cli
    from multimodalmusig_tpu.utils.data import brca_counts_path
    from multimodalmusig_tpu.utils.io import load_model

    paths = {k: os.path.join(out_dir, f"{k}.{'npz' if k == 'model' else 'tsv'}")
             for k in ("model", "mean", "cov", "cor", "sigs", "props")}
    argv = [brca_counts_path("brca-eu_snv_counts.tsv"),
            brca_counts_path("brca-eu_sv_counts.tsv"),
            "-k", "7", "7", "-m", "SNV", "SV", "--restarts", str(restarts),
            "--auto-compact", "--verbose"]
    for k, p in paths.items():
        argv += [f"--{k}", p]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    text = buf.getvalue()
    say("\n".join("  cli| " + l for l in text.splitlines()
                  if "finite lanes" in l or "Log-likelihoods" in l or "device" in l))
    check(rc == 0, f"cli.main returned {rc}")
    lanes = [l for l in text.splitlines() if "finite lanes" in l]
    check(lanes, "cli printed no finite-lane share")
    done, total = map(int, lanes[-1].split()[-1].split("/"))
    say(f"main path: stage-1 finite lanes {done}/{total} = {done / total:.4f}")
    check(done / total > 0.99, "main path: under 99% of the lanes finite")
    for k in ("mean", "cov", "cor"):
        check(np.isfinite(np.loadtxt(paths[k], ndmin=1)).all(), f"{k} not finite")
    for k in ("sigs", "props"):
        with open(paths[k]) as f:
            rows = list(csv.reader(f, delimiter="\t"))
        vals = np.asarray([float(v) for r in rows[1:] for v in r[-1 if k == "sigs" else 1:]])
        check(len(rows) > 1 and np.isfinite(vals).all(), f"{k} not finite")
    model = load_model(paths["model"])
    check(all(np.isfinite(np.asarray(x)).all() for x in
              [model.state.lam, model.state.Sigma, *model.state.gamma]), "model not finite")
    agree("main path selected model", *rescore_pair_mmctm(model))
    return model


# ---------------------------------------------------------------------------
# phase 4: trajectory
# ---------------------------------------------------------------------------


def with_dot_precision(jaxpr, precision):
    """`jaxpr` with every dot_general, in every sub-jaxpr, at `precision`."""
    from jax.extend.core import ClosedJaxpr, Jaxpr

    def sub(v):
        if isinstance(v, ClosedJaxpr):
            return v.replace(jaxpr=with_dot_precision(v.jaxpr, precision))
        if isinstance(v, Jaxpr):
            return with_dot_precision(v, precision)
        if isinstance(v, tuple) and any(isinstance(x, (ClosedJaxpr, Jaxpr)) for x in v):
            return tuple(sub(x) for x in v)
        return v

    eqns = []
    for e in jaxpr.eqns:
        params = {k: sub(v) for k, v in e.params.items()}
        if e.primitive.name == "dot_general":
            params["precision"] = precision
        eqns.append(e.replace(params=params))
    return jaxpr.replace(eqns=eqns)


def tf32_history(s32, X32, cfg):
    """ll history of the f32 fit with every contraction at TF32 inputs."""
    import jax
    import numpy as np

    from multimodalmusig_tpu.models import mmctm as mm

    run = functools.partial(mm.fit, config=cfg, maxiter=TRAJ_ITERS, tol=0.0)
    closed, shape = jax.make_jaxpr(run, return_shape=True)(s32, X32)
    loose = with_dot_precision(closed.jaxpr, jax.lax.DotAlgorithmPreset.TF32_TF32_F32)
    flat = jax.jit(lambda *a: jax.core.eval_jaxpr(loose, closed.consts, *a))(
        *jax.tree_util.tree_leaves((s32, X32)))
    out = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(shape), flat)
    return np.asarray(out.ll_history, np.float64)


def phase_trajectory(data):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from multimodalmusig_tpu.models import mmctm as mm
    from multimodalmusig_tpu.models.ctm_base import fused_lambda_enabled, resolved_budgets

    Xnp = [c.T for c, _, _ in data]
    cfg32 = mm.MMCTMConfig(K=(7, 7), V=(96, 48), D=Xnp[0].shape[0], dtype=jnp.float32)
    budgets = resolved_budgets(cfg32)
    X32 = tuple(jnp.asarray(x, jnp.float32) for x in Xnp)
    s32 = mm.init_with_alpha(jax.random.key(7), cfg32, X32, jnp.asarray([0.1, 0.1], jnp.float32))
    fit = jax.jit(mm.fit, static_argnames=("config", "maxiter", "tol"))
    with jax.enable_x64(True):
        cfg64 = dataclasses.replace(cfg32, dtype=jnp.float64, **budgets)
        s64 = jax.tree_util.tree_map(
            lambda x: x.astype(jnp.float64) if jnp.issubdtype(x.dtype, jnp.floating) else x,
            s32)
        X64 = tuple(jnp.asarray(x, jnp.float64) for x in Xnp)
        h64 = np.asarray(fit(s64, X64, cfg64, maxiter=TRAJ_ITERS, tol=0.0).ll_history)
    say(f"trajectory: kernel gate for this fit = "
        f"{fused_lambda_enabled(cfg32.MK, cfg32.dtype, [jax.devices()[0]])}; budgets {budgets}")

    def history(cfg):
        return np.asarray(fit(s32, X32, cfg, maxiter=TRAJ_ITERS, tol=0.0).ll_history,
                          np.float64)

    xla = dataclasses.replace(cfg32, force_fused=False)
    runs = {"fused": lambda: history(dataclasses.replace(cfg32, force_fused=True)),
            "xla": lambda: history(xla),
            "TF32 control (xla)": lambda: tf32_history(s32, X32, xla)}
    for name, run in runs.items():
        rel = np.abs(run() - h64) / np.abs(h64)
        say(f"trajectory {name} f32 vs f64 ({TRAJ_ITERS} iterations): max rel "
            f"{rel.max():.3e} at iteration {int(rel.max(axis=1).argmax()) + 1}, final "
            f"{rel[-1].max():.3e} (tol {TOL_TRAJECTORY:g})")
        if name.startswith("TF32"):
            check(rel.max() > TOL_TRAJECTORY,
                  f"trajectory: the TF32 control passed the limit ({rel.max()})")
        else:
            check(rel.max() <= TOL_TRAJECTORY, f"trajectory {name}: {rel.max()}")


# ---------------------------------------------------------------------------
# phase 5: families and fold-in
# ---------------------------------------------------------------------------


def _lane(tree):
    import jax
    import numpy as np

    return jax.tree_util.tree_map(lambda x: np.asarray(x)[None], tree)


def phase_families(data, mmctm_model, timings, restarts=100):
    import numpy as np

    import multimodalmusig_tpu as mmt
    from multimodalmusig_tpu.parallel import rescore as rs
    from multimodalmusig_tpu.parallel import rescore_device as rd
    from multimodalmusig_tpu.parallel.restarts import (
        fit_ilda_restarts, fit_immctm_restarts, fit_lda_restarts)
    from multimodalmusig_tpu.utils.formatting import make_count_matrix

    (snv, snv_terms, _), (sv, sv_terms, _) = data
    D = snv.shape[1]
    X_lda = [make_count_matrix(snv[:, d]) for d in range(D)]
    X_mm = [[make_count_matrix(snv[:, d]), make_count_matrix(sv[:, d])] for d in range(D)]
    f_snv, f_sv = brca_features(snv_terms, sv_terms)
    kw = dict(restarts=restarts, maxiter=1000)

    lda = timed(f"family LDA R={restarts}", lambda: fit_lda_restarts(7, 0.1, 0.1, X_lda, **kw), timings)
    g, l = _lane(lda.state.gamma), _lane(lda.state.lam)
    X = np.asarray(lda.Xdense)
    agree(f"LDA best-of-{restarts}", rd.rescore_lda_f64_dev(g, l, X), rs.rescore_lda_f64(g, l, X))

    ilda = timed(f"family ILDA R={restarts}",
                 lambda: fit_ilda_restarts(7, 0.1, 0.1, f_snv, X_lda, **kw), timings)
    g, l = _lane(ilda.state.gamma), _lane(tuple(ilda.state.lam))
    X = np.asarray(ilda.Xdense)
    agree(f"ILDA best-of-{restarts}", rd.rescore_ilda_f64_dev(g, l, X, ilda.F),
          rs.rescore_ilda_f64(g, l, X, ilda.F))

    imm = timed(f"family IMMCTM R={restarts}", lambda: fit_immctm_restarts(
        [7, 7], [0.1, 0.1], [f_snv, f_sv], X_mm, **kw), timings)
    lam = _lane(imm.state.lam)
    gam = _lane(tuple(tuple(gm) for gm in imm.state.gamma))
    X = [np.asarray(x) for x in imm.Xdense]
    agree(f"IMMCTM best-of-{restarts}",
          rd.rescore_immctm_f64_dev(lam, gam, X, imm.F, imm.config)[0],
          rs.rescore_immctm_f64(lam, gam, X, imm.F, imm.config)[0])

    new = timed("fold-in transform", lambda: mmt.transform(mmctm_model, X_mm), timings)
    agree("transform", *rescore_pair_mmctm(new))
    held = timed("fold-in fit_heldout", lambda: mmt.fit_heldout(X_mm, mmctm_model), timings)
    agree("fit_heldout", *rescore_pair_mmctm(held))
    Xobs = [[doc[1]] for doc in X_mm]
    eta = timed("fold-in predict_modality_eta",
                lambda: mmt.predict_modality_eta(Xobs, 1, mmctm_model), timings)
    eta = np.asarray(eta)
    say(f"predict_modality_eta: shape {eta.shape}, finite {np.isfinite(eta).all()}")
    check(eta.shape == (D, 7) and np.isfinite(eta).all(), "predict_modality_eta")


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def phase_four_cards(devices, data, restarts=1000, pcawg_docs=2800,
                     family_restarts=100):
    """Each multi-device path against the same computation on one card."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from multimodalmusig_tpu.models import mmctm as mm
    from multimodalmusig_tpu.parallel import sharding as sh
    from multimodalmusig_tpu.parallel.restarts import fit_immctm_restarts, fit_restarts
    from multimodalmusig_tpu.utils.formatting import make_count_matrix

    one = devices[0]
    it = FOUR_CARD_ITERS

    def close(label, many, single):
        many, single = np.asarray(many, np.float64), np.asarray(single, np.float64)
        rel = float(np.max(np.abs(many - single) / np.abs(single)))
        say(f"four cards {label}: max rel vs one card {rel:.3e} (tol {TOL_FOUR_CARDS:g})")
        check(np.isfinite(many).all() and rel <= TOL_FOUR_CARDS, f"four cards {label}: {rel}")

    Xnp = [c.T.astype(np.float32) for c, _, _ in data]
    X = tuple(jnp.asarray(x) for x in Xnp)
    cfg = mm.MMCTMConfig(K=(7, 7), V=(96, 48), D=Xnp[0].shape[0], dtype=jnp.float32)
    alpha = jnp.asarray([0.1, 0.1], jnp.float32)
    key = jax.random.key(SEED)
    t0 = time.perf_counter()
    fan = sh.shmap_fit_restarts(key, X, cfg, alpha, restarts=restarts, maxiter=it,
                                devices=devices)
    t_fan = time.perf_counter() - t0
    with jax.default_device(one):
        ref = fit_restarts(key, tuple(jax.device_put(x, one) for x in X), cfg,
                           jax.device_put(alpha, one), restarts=restarts, maxiter=it)
    say(f"four cards: shard_map fan-out R={restarts} on {len(devices)} devices "
        f"(first call {t_fan:.1f} s)")
    close(f"MMCTM restart fan-out R={restarts}", fan.ll, ref.ll)

    (snv, snv_terms, _), (sv, sv_terms, _) = data
    D = snv.shape[1]
    X_mm = [[make_count_matrix(snv[:, d]), make_count_matrix(sv[:, d])] for d in range(D)]
    f_snv, f_sv = brca_features(snv_terms, sv_terms)
    kw = dict(restarts=family_restarts, maxiter=it)
    many = fit_immctm_restarts([7, 7], [0.1, 0.1], [f_snv, f_sv], X_mm,
                               devices=devices, **kw)
    with jax.default_device(one):
        single = fit_immctm_restarts([7, 7], [0.1, 0.1], [f_snv, f_sv], X_mm, **kw)
    close(f"fit_immctm_restarts(devices={len(devices)}) selected ll", many.ll, single.ll)

    Xp = tuple(jnp.asarray(x) for x in pcawg(pcawg_docs))
    cfg_p = mm.MMCTMConfig(K=(7, 7, 5), V=(96, 48, 24), D=pcawg_docs, dtype=jnp.float32)
    alpha_p = jnp.full((3,), 0.1, jnp.float32)
    with jax.default_device(one):
        state = mm.init_with_alpha(jax.random.key(1), cfg_p, Xp, alpha_p)
        single = jax.jit(mm.fit, static_argnames=("config", "maxiter", "tol"))(
            state, Xp, cfg_p, maxiter=it)
    mesh = sh.make_mesh(1, len(devices), devices)
    many = sh.sharded_data_parallel_fit(mesh, state, Xp, cfg_p, maxiter=it)
    close(f"sharded_data_parallel_fit D={pcawg_docs}", many.ll_history[:it],
          single.ll_history[:it])


# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phase (needs four GPUs)")
    args = ap.parse_args(argv)

    from multimodalmusig_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    import jax
    import jaxlib

    timings = {}
    devs = jax.devices()
    dev = devs[0]
    say(f"device: {dev.platform} {dev.device_kind} (count {len(devs)})")
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}", file=sys.stderr)
        return 1
    say(f"nvidia-smi: {nvidia_smi_line()}")
    say(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}, "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}, compile cache {cache!r}")

    data = brca()
    if args.four_cards:
        if len(devs) < 4:
            print(f"chip_smoke: --four-cards needs 4 GPUs, found {len(devs)}",
                  file=sys.stderr)
            return 1
        timed("four cards", lambda: phase_four_cards(devs[:4], data), timings)
    else:
        timed("kernel", lambda: phase_kernel(data), timings)
        with tempfile.TemporaryDirectory() as out_dir:
            model = timed("main path", lambda: phase_cli(out_dir), timings)
        timed("trajectory", lambda: phase_trajectory(data), timings)
        timed("families and fold-in", lambda: phase_families(data, model, timings),
              timings)
    say("smoke timings (s): " + json.dumps({k: round(v, 1) for k, v in timings.items()}))
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        rc = 1
    sys.exit(rc)
