#!/usr/bin/env python
"""gala_tpu quickstart: every user-facing surface in one script.

On the GPU run it under the normal environment; on the CPU:
    JAX_PLATFORMS=cpu python examples/quickstart.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import gala_tpu

HERE = os.path.dirname(os.path.abspath(__file__))

# ---- 1. compile a GALA DSL program and train -------------------------- #
# (the same .txt programs the reference's compiler consumes)
cm = gala_tpu.compile_file(os.path.join(HERE, "gcn.txt"), mode="train",
                           scale=0.2)
res = cm.train(iters=40)
print("GCN:", res.csv(print_accuracy=True))

# ---- 2. schedule directives ------------------------------------------- #
# coarsen / col_tile / sample / opt_input parse from the DSL; kwargs of
# compile_* override the execution strategy:
cm_bell = gala_tpu.compile_file(os.path.join(HERE, "gcn.txt"), mode="train",
                                scale=0.2, strategy="bell")
print("GCN (binned-ELL):", cm_bell.run(iters=20))

# ---- 3. GAT with fused slot-space attention --------------------------- #
cm_gat = gala_tpu.compile_file(os.path.join(HERE, "gat.txt"), mode="train",
                               scale=0.2)
print("GAT:", cm_gat.run(iters=20))

# ---- 4. AOT export: run later without the compiler -------------------- #
from gala_tpu.export import export_compiled, load_exported

art = os.path.join(HERE, "_gcn_exported")
export_compiled(cm, art, platforms=("cpu", "cuda"))
em = load_exported(art)
print("exported replay:", em.run(iters=20))

# ---- 5. minibatch GraphSAGE (neighbor sampling) ------------------------ #
from gala_tpu.data.datasets import load_dataset
from gala_tpu.train_minibatch import train_sage_minibatch

g, feats, labels, masks = load_dataset("Cora", scale=0.2)
mb = train_sage_minibatch(g, feats, labels, masks, fanouts=(10, 5),
                          batch_size=128, iters=6)
print("minibatch SAGE acc:", round(mb.max_accuracy, 3))

# ---- 6. SPMD over a device mesh ---------------------------------------- #
# (multi-chip: shard the compiled program; works on a virtual CPU mesh
# too — see __graft_entry__.dryrun_multichip for the full tour)
import jax

if len(jax.devices()) > 1:
    from gala_tpu.parallel.compiled import shard_compiled
    from gala_tpu.parallel.mesh import make_mesh

    sm = shard_compiled(cm, mesh=make_mesh(len(jax.devices()), model_axis=1),
                        use_halo=True)
    print("SPMD:", sm.train(iters=10).csv())
