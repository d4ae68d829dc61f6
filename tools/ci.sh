#!/usr/bin/env bash
# Pre-commit gate on the CPU: the test suite (the band kernel runs through
# the Pallas interpreter, gpu-marked tests skip), the single-device
# compile check, and the 8-device virtual-mesh training dryrun.
# On the GPU, run `python chip_smoke.py` instead.
# Usage: tools/ci.sh [fast]    (fast: suite only)
set -euo pipefail
cd "$(dirname "$0")/.."
export JAX_PLATFORMS=cpu
python -m pytest tests/ -q
if [ "${1:-}" != "fast" ]; then
  XLA_FLAGS=--xla_force_host_platform_device_count=8 python - <<'PY'
import jax
import __graft_entry__ as g
fn, args = g.entry()
jax.jit(fn)(*args)
g.dryrun_multichip(8)
print("CI gate: entry + multichip dryrun OK")
PY
fi
echo "CI gate: PASS"
