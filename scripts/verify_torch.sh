#!/usr/bin/env bash
# One-command gate of the PyTorch/CUDA port (src/repro_torch): the port's
# twin of scripts/verify.sh. Its tests, the verifier, lint and types of
# the verifier when installed, the chaos scenario, the bench smoke and its
# trend gate, the quickstart, and the datapath kernels' parity on the card.
#   bash scripts/verify_torch.sh [--fast] [--device cuda|cpu]
#     --fast        skips the quickstart (it trains a model for 60 steps)
#     --device cpu  runs the CPU half: every step but the kernel parity,
#                   which needs the card and is named as left out
# Every step runs on the card by default, and the gate fails at once
# without one.
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"

FAST=0
DEVICE=cuda
while [[ $# -gt 0 ]]; do
  case "$1" in
    --fast) FAST=1; shift ;;
    --device) DEVICE="${2:?--device takes cuda or cpu}"; shift 2 ;;
    --device=*) DEVICE="${1#--device=}"; shift ;;
    *) echo "usage: $0 [--fast] [--device cuda|cpu]" >&2; exit 2 ;;
  esac
done
case "$DEVICE" in
  cuda)
    python -c 'import sys, torch; sys.exit(0 if torch.cuda.is_available() else 1)' || {
      echo "verify_torch: no CUDA device (run with --device cpu for the CPU half)" >&2
      exit 1
    } ;;
  cpu) export CUDA_VISIBLE_DEVICES="" ;;   # the verifier's audit too
  *) echo "verify_torch: --device is cuda or cpu, not $DEVICE" >&2; exit 2 ;;
esac
echo "== device: $DEVICE =="

echo "== tests: tests/test_torch_*.py (twins against the JAX package, on the CPU) =="
python -m pytest -x -q tests/test_torch_*.py

echo "== static analysis: ownership + kernel audit + lockset + concurrency + imports =="
python scripts/check_static_analysis_torch.py

if command -v ruff >/dev/null 2>&1; then
  echo "== lint: ruff (hard gate: the verifier; advisory: the rest of the port) =="
  ruff check src/repro_torch/analysis
  ruff check src/repro_torch benchmarks_torch examples/*_torch.py scripts/*_torch.py chip_smoke.py \
    || echo "ruff (advisory, outside analysis/): issues above are non-blocking"
else
  echo "== lint: ruff not installed — skipping (pip install -r requirements-dev.txt) =="
fi

if command -v mypy >/dev/null 2>&1; then
  echo "== types: mypy (hard gate: the verifier; advisory: the rest of the port) =="
  mypy src/repro_torch/analysis
  mypy src/repro_torch || echo "mypy (advisory, outside analysis/): issues above are non-blocking"
else
  echo "== types: mypy not installed — skipping (pip install -r requirements-dev.txt) =="
fi

echo "== failover recovery: standard chaos scenario (identity + conservation + zero leaks) =="
python scripts/check_failover_recovery_torch.py --device "$DEVICE"

echo "== smoke: benchmarks_torch.run --smoke =="
python -m benchmarks_torch.run --smoke --device "$DEVICE"

echo "== bench trend gate: fresh artifacts vs committed baselines =="
python scripts/check_bench_trend_torch.py --device "$DEVICE"

if [[ "$FAST" == 0 ]]; then
  echo "== smoke: examples/quickstart_torch.py =="
  python examples/quickstart_torch.py --device "$DEVICE"
fi

if [[ "$DEVICE" == cuda ]]; then
  echo "== kernel parity: the datapath kernels vs their plain versions, on the card =="
  python scripts/check_kernel_parity_torch.py
else
  echo "== kernel parity: LEFT OUT on the CPU (scripts/check_kernel_parity_torch.py needs a CUDA device) =="
fi

echo "verify_torch: OK ($DEVICE)"
