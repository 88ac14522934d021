#!/usr/bin/env python3
"""Sweep the fused λ kernel's launch configuration on one GPU.

    python tools/lambda_sweep.py [--reps 20] [--out sweep.jsonl]

Times `maximize_lambda_fused` at every (documents per program, warps) in
{16, 32, 64} x {4, 8}, at the BRCA (R=1000 x D=560 x MK=14) and PCAWG-shaped
(R=100 x D=2800 x MK=19) widths, at the warm-start budgets the CAVI fits use
and at the cold defaults, beside XLA's plain path (`ops.solvers.
maximize_lambda` with exact-f32 matvecs). `lambda_kernel.launch_config`
holds the fastest configuration per padded topic width. Prints one JSON
line per configuration: median seconds of `--reps` warm calls and max |Δλ|
against the reference. Exits non-zero without a GPU.
"""

import argparse
import functools
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (data and timing helpers)

TILES = (16, 32, 64)
WARPS = (4, 8)


def sweep(label, Xnp, K, R, reps, emit):
    import jax
    import jax.numpy as jnp

    from multimodalmusig_tpu.models.ctm_base import resolved_budgets
    from multimodalmusig_tpu.ops.pallas.lambda_kernel import launch_config, maximize_lambda_fused
    from multimodalmusig_tpu.ops.solvers import maximize_lambda

    config, args = chip_smoke.lambda_inputs(Xnp, K, R)
    b = resolved_budgets(config)
    warm = dict(n_iter=b["lambda_n_iter"], cg_iter=b["lambda_cg_iter"],
                polish_iter=b["lambda_polish_iter"])
    for budget, kw in (("warm", warm), ("cold", {})):
        ref_fn = jax.jit(jax.vmap(functools.partial(maximize_lambda, **kw)))
        with jax.default_matmul_precision("highest"):
            ref = ref_fn(*args)
            t_xla = chip_smoke.median_time(ref_fn, args, reps)
        emit(dict(width=label, budget=budget, arm="xla", seconds=t_xla))
        for tile in TILES:
            for warps in WARPS:
                fn = jax.jit(functools.partial(maximize_lambda_fused, launch=(tile, warps), **kw))
                err = float(jnp.max(jnp.abs(fn(*args) - ref)))
                emit(dict(width=label, budget=budget, arm="fused", tile=tile, warps=warps,
                          chosen=(tile, warps) == launch_config(config.MK),
                          seconds=chip_smoke.median_time(fn, args, reps), max_abs_dlam=err))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", help="also append the JSON lines to this file")
    args = ap.parse_args(argv)

    from multimodalmusig_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"lambda_sweep: needs a GPU, JAX found {dev.platform!r}", file=sys.stderr)
        return 1
    print(f"device: {dev.device_kind}; nvidia-smi: {chip_smoke.nvidia_smi_line()}", flush=True)

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    data = chip_smoke.brca()
    Xb = [c.T.astype("float32") for c, _, _ in data]
    sweep(f"BRCA R=1000 D={Xb[0].shape[0]} MK=14", Xb, (7, 7), 1000, args.reps, emit)
    sweep("PCAWG R=100 D=2800 MK=19", chip_smoke.pcawg(2800), (7, 7, 5), 100, args.reps, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
