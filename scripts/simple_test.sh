#!/bin/bash
# Smoke e2e, the analog of the reference's scripts/e2e/simple-test.sh:
# compile the example GCN DSL program and train; success = a CSV line of
# finite numbers on stdout.
#
# Usage: bash scripts/simple_test.sh [scale]   (default 0.05)
set -e
cd "$(dirname "$0")/.."
SCALE="${1:-0.05}"
MODEL="examples/gcn.txt"
python -m gala_tpu train "$MODEL" --iters 20 --scale "$SCALE"
