#!/bin/bash
# CPU test runner (JAX_PLATFORMS=cpu, 8 virtual devices via conftest.py).
# The GPU tests run on a card with
#   JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
#
# Tiers:
#   scripts/run_tests.sh            fast tier (-m "not slow"), target <2 min
#   scripts/run_tests.sh --all      everything, including compile-heavy
#   scripts/run_tests.sh --slow     only the slow tier
#   scripts/run_tests.sh <args...>  passed straight to pytest
if [ $# -eq 0 ]; then
    set -- tests/ -q -m "not slow"
elif [ "$1" = "--all" ]; then
    shift; set -- tests/ -q "$@"
elif [ "$1" = "--slow" ]; then
    shift; set -- tests/ -q -m slow "$@"
fi
exec env JAX_PLATFORMS=cpu python -m pytest "$@"
