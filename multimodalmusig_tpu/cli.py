"""run-mmctm CLI: multi-restart MMCTM fitting on mutation count TSVs.

Mirrors the reference's production workflow (scripts/run_mmctm.jl:15-71
argument surface, :163-180 two-stage fitting, :272-290 outputs), with the
restart fan-out running as a single compiled vmap on the accelerator instead
of `julia -p N` worker processes.

Usage:
    python -m multimodalmusig_tpu.cli snv.tsv sv.tsv -k 7 7 \
        -m SNV SV --restarts 100 --sigs sigs.tsv --props props.tsv

Input TSVs: column 1 = `term`, remaining columns = samples (the bundled
BRCA-EU format, data/brca-eu_*_counts.tsv).
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="run-mmctm",
        description="Fit a multi-modal correlated topic model (MMCTM) to "
        "mutation count matrices with multi-restart model selection.",
    )
    # inputs (run_mmctm.jl:19-30)
    p.add_argument("counts", nargs="+", help="mutation counts tsv files (one per modality)")
    p.add_argument(
        "-k", "--num-sigs", dest="k", type=int, nargs="+", required=True,
        help="number of signatures for each mutation type",
    )
    p.add_argument(
        "-m", "--modality-labels", dest="modalities", nargs="+", required=True,
        help="modality labels for output",
    )
    # outputs (run_mmctm.jl:32-44)
    p.add_argument("--model", help="model checkpoint output (.npz)")
    p.add_argument("--mean", help="gaussian mean output tsv file")
    p.add_argument("--cov", help="gaussian covariance matrix output tsv file")
    p.add_argument("--cor", help="correlation output tsv file")
    p.add_argument("--sigs", help="signatures output tsv file")
    p.add_argument("--props", help="signature proportions output tsv file")
    # options (run_mmctm.jl:46-70)
    p.add_argument(
        "--restarts", "-r", type=int, default=1000,
        help="number of restarts for the first fitting stage (default 1000)",
    )
    p.add_argument(
        "--stage2-restarts", type=int, default=1,
        help="stage-2 restarts; the reference's stage-2 restarts are "
        "deterministic duplicates, so 1 reproduces its result (default 1)",
    )
    p.add_argument("--verbose", "-v", action="store_true", help="print output")
    p.add_argument(
        "--progress", "-p", action="store_true",
        help="stream per-chunk restart completion counts (needs "
        "--chunk-iters or --compact-at: an unchunked fit is a single "
        "compiled device dispatch with nothing observable until it returns)",
    )
    p.add_argument("--seed", "-s", type=int, default=147959412, help="random state seed")
    p.add_argument(
        "--alpha", "-a", type=float, default=0.1,
        help="topic dirichlet hyperparameter value",
    )
    p.add_argument("--maxiter", type=int, default=1000, help="max CAVI iterations per fit")
    p.add_argument(
        "--chunk-iters", type=int, default=0,
        help="CAVI iterations per device execution (host-chunked resumable "
        "fitting, observable between chunks; 0 = unchunked, a single "
        "device execution per stage)",
    )
    p.add_argument(
        "--compact-at", type=int, nargs="+", default=None, metavar="ITER",
        help="2-phase straggler compaction for stage 1: run every restart "
        "the given iteration budget(s), compact converged lanes out on "
        "device after each, then finish survivors unbounded. At large "
        "--restarts this avoids paying the slowest lane's iteration count "
        "on every lane. Prefer "
        "--auto-compact, which derives these budgets from a pilot fit; this "
        "flag pins explicit budgets (e.g. from a recorded "
        "suggest_compact_schedule run). Mutually exclusive with "
        "--chunk-iters.",
    )
    p.add_argument(
        "--auto-compact", action="store_true",
        help="derive the stage-1 straggler-compaction schedule automatically: "
        "fit a small pilot (--pilot-restarts lanes), measure this device's "
        "boundary round-trip cost, and let the exact-DP scheduler place the "
        "compaction boundaries — zero-config at --restarts 1000, matching "
        "the reference CLI's ergonomics. Mutually exclusive with "
        "--compact-at and --chunk-iters.",
    )
    p.add_argument(
        "--pilot-restarts", type=int, default=64,
        help="pilot size for --auto-compact (default 64)",
    )
    p.add_argument(
        "--platform", choices=("default", "cpu"), default="default",
        help="'default' runs on JAX's default backend (the GPU where there "
        "is one); 'cpu' requests the CPU backend explicitly",
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.chunk_iters and args.compact_at:
        print(
            "run-mmctm: --chunk-iters and --compact-at are mutually exclusive "
            "(fixed-cadence watchdog chunking vs 2-phase straggler compaction)",
            file=sys.stderr,
        )
        return 1
    if args.auto_compact and (args.chunk_iters or args.compact_at):
        print(
            "run-mmctm: --auto-compact is mutually exclusive with "
            "--compact-at and --chunk-iters",
            file=sys.stderr,
        )
        return 1
    if len(args.counts) != len(args.k):
        print("Number of count files must match the number of K values.", file=sys.stderr)
        return 1
    if len(args.modalities) != len(args.k):
        print("Number of modality labels must match the number of K values.", file=sys.stderr)
        return 1

    import jax

    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.verbose:
        dev = jax.devices()[0]
        print(
            f"run-mmctm: device {dev.platform} {dev.device_kind} "
            f"(count {len(jax.devices())})"
        )

    from .parallel.restarts import fit_mmctm_restarts
    from .utils import io as io_mod
    from .utils.fast_tsv import read_counts_tsv
    from .utils.formatting import make_count_matrix

    loaded = [read_counts_tsv(f) for f in args.counts]  # (counts (V,D), terms, samples)
    samples = loaded[0][2]
    terms = [t for _, t, _ in loaded]
    # Align columns by sample NAME across modality files (the reference picks
    # columns by sample id from file 1's header — run_mmctm.jl:258-260 — so
    # differently-ordered exports must not silently misalign documents).
    col_of = []
    for path, (_, _, s) in zip(args.counts, loaded):
        index = {name: i for i, name in enumerate(s)}
        missing = [name for name in samples if name not in index]
        if missing:
            print(
                f"{path}: missing sample columns {missing[:5]}"
                f"{'...' if len(missing) > 5 else ''}",
                file=sys.stderr,
            )
            return 1
        col_of.append(index)
    # X[doc][modality] in the reference's sparse (index, count) form
    counts = [
        [
            make_count_matrix(loaded[m][0][:, col_of[m][name]])
            for m in range(len(loaded))
        ]
        for name in samples
    ]
    alpha = [args.alpha] * len(args.k)
    V = [mat.shape[0] for mat, _, _ in loaded]

    # Per-chunk progress: the analogue of the reference's restart progress
    # bar (run_mmctm.jl:101-104). Only the chunked driver has observable
    # intermediate state — an unchunked fit is ONE device dispatch, so there
    # is nothing to stream until it returns (say so instead of silence).
    progress = None
    if args.progress:
        if args.chunk_iters or args.compact_at or args.auto_compact:
            def progress(stage, done, total):
                # "completed", not "converged": the chunked driver also counts
                # lanes that hit maxiter without converging as done
                print(
                    f"run-mmctm: stage {stage}: {done}/{total} restarts "
                    "completed",
                    file=sys.stderr,
                )
        else:
            print(
                "run-mmctm: --progress needs --chunk-iters, --compact-at, or "
                "--auto-compact; the unchunked fit runs each stage as a "
                "single compiled dispatch with no observable intermediate "
                "state",
                file=sys.stderr,
            )

    model = fit_mmctm_restarts(
        args.k,
        alpha,
        counts,
        V=V,
        restarts=args.restarts,
        stage2_restarts=args.stage2_restarts,
        maxiter=args.maxiter,
        seed=args.seed,
        verbose=args.verbose,
        chunk_iters=args.chunk_iters or None,
        compact_schedule=(
            "auto"
            if args.auto_compact
            else tuple(args.compact_at) if args.compact_at else None
        ),
        pilot_restarts=args.pilot_restarts,
        progress=progress,
    )
    if args.auto_compact and getattr(model, "compact_info", None) is not None:
        info = model.compact_info
        print(
            f"run-mmctm: auto-compact schedule {info['schedule']} "
            f"(boundary {info['boundary_s'] * 1e3:.0f} ms = "
            f"{info['boundary_cost_lane_iters']:.0f} lane-iters; pilot "
            f"R={info['pilot_restarts']}, median "
            f"{info['pilot_iters_median']:.0f} iters)",
            file=sys.stderr,
        )
    if args.verbose:
        import numpy as np

        finite = np.isfinite(model.stage1_ll).all(axis=1)
        print(f"run-mmctm: stage 1 finite lanes {int(finite.sum())}/{finite.size}")
        print(f"Log-likelihoods: {model.ll}")

    if args.model:
        io_mod.save_model(args.model, model)
    if args.mean:
        io_mod.write_mean(args.mean, model)
    if args.cov:
        io_mod.write_cov(args.cov, model)
    if args.cor:
        io_mod.write_cor(args.cor, model)
    if args.sigs:
        io_mod.write_sigs(args.sigs, model, terms, args.modalities)
    if args.props:
        io_mod.write_props(args.props, model, samples, args.modalities)
    return 0


if __name__ == "__main__":
    sys.exit(main())
