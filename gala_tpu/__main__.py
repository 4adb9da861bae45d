"""Compiler driver CLI — the five reference executables as subcommands.

The reference ships five near-identical driver binaries differing only
in pass matrix and output flags (reference: tests/gala_inference.cpp,
gala_inference_long.cpp, gala_inference_sample.cpp, gala_train.cpp,
gala_train_memory.cpp).  Here:

    python -m gala_tpu inference  model.txt [--iters N] [--data-root D]
    python -m gala_tpu inference_long   ...   (int64-scale datasets)
    python -m gala_tpu inference_sample ...   (adds accuracy to the CSV)
    python -m gala_tpu train            ...   (all passes)
    python -m gala_tpu train_memory     ...   (adds device-memory MB)

Each prints the reference's stdout CSV contract
(`inference_time,total_time[,max_acc]` / `memMB,...`,
reference: src/codegen/common.h:1571-1587).
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="gala_tpu")
    ap.add_argument(
        "driver",
        choices=[
            "inference", "inference_long", "inference_sample",
            "train", "train_memory", "export", "run_exported",
        ],
    )
    ap.add_argument("model", help="GALA DSL program (.txt); artifact dir "
                                  "for run_exported")
    ap.add_argument("-o", "--out", default=None,
                    help="export: artifact output directory")
    ap.add_argument("--platforms", nargs="+", default=["cpu", "cuda"],
                    help="export: lowering targets baked into the artifact")
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--data-root", default=None, help="GALA npy dataset root")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="synthetic-dataset scale when no data root")
    ap.add_argument("--strategy", default="auto")
    ap.add_argument("--dtype", default=None, choices=[None, "bf16", "f32"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import os

    import jax.numpy as jnp

    from gala_tpu.api import compile_file

    if args.driver == "run_exported":
        # replay a serialized artifact: no parser / IR / passes involved
        # (the analog of re-running the reference's built ./gala_model)
        from gala_tpu.export import load_exported

        em = load_exported(args.model)
        print(em.run(iters=args.iters))
        return

    t0 = time.perf_counter()
    # export serializes the training step: full train pass matrix
    mode = (
        "train"
        if args.driver.startswith("train") or args.driver == "export"
        else "inference"
    )
    if args.driver == "inference_long":
        # int64 device arrays require x64 mode (JAX canonicalizes them
        # to int32 otherwise); must happen before any jax op
        import jax

        jax.config.update("jax_enable_x64", True)
    dtype = {None: None, "bf16": jnp.bfloat16, "f32": jnp.float32}[args.dtype]

    cm = compile_file(
        args.model,
        mode=mode,
        data_root=args.data_root,
        scale=args.scale,
        strategy=args.strategy,
        seed=args.seed,
        dtype=dtype,
        # int64 edge ids/offsets (t_perm, CSR row_ptr, ELL perms) for
        # >2^31-edge graphs; auto-enabled past that size regardless
        use_long=args.driver == "inference_long",
    )
    # driver-baked flag matrix (reference: the per-executable diffs)
    if args.driver == "inference_sample":
        cm.spec.print_accuracy = True
    if args.driver == "train_memory":
        cm.spec.print_memory = True
    print(
        f"# GALA-TPU compile: {time.perf_counter() - t0:.2f}s "
        f"(reference prints 'Time taken for GALA compilation')",
        file=sys.stderr,
    )
    if args.driver == "export":
        from gala_tpu.export import export_compiled

        out = args.out or (os.path.splitext(args.model)[0] + "_exported")
        export_compiled(cm, out, platforms=tuple(args.platforms))
        print(out)
        return
    print(cm.run(iters=args.iters))


if __name__ == "__main__":
    main()