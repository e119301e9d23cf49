#!/usr/bin/env bash
# Build and run the Go inference demo against a saved model — the
# CI-runnable path for the goapi shim (tests/test_torch_goapi.py drives the
# same steps under pytest and compares outputs numerically).
#
# Usage: run_demo.sh [model_dir [device]]
#   With no model_dir (or an empty one), a small MLP is jit.save'd to a
#   temp dir first (the same recipe as tests/test_torch_goapi.py's
#   saved_model fixture). device is "gpu" (the default) or "cpu".
set -euo pipefail

HERE="$(cd "$(dirname "$0")" && pwd)"
CAPI_DIR="$(dirname "$HERE")"
REPO="$(cd "$CAPI_DIR/../.." && pwd)"
PY="${PYTHON:-python}"

command -v go >/dev/null || { echo "go toolchain not found" >&2; exit 2; }

LIB="$($PY -c 'from paddle_tpu_torch.capi import build_capi; print(build_capi())')"
LIBDIR="$(dirname "$LIB")"
LIBNAME="$(basename "$LIB")"

MODEL="${1:-}"
DEVICE="${2:-gpu}"
if [ -z "$MODEL" ]; then
  MODEL="$(mktemp -d)/mlp"
  $PY - "$MODEL" <<'EOF'
import sys
import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn
from paddle_tpu_torch.static import InputSpec
paddle.seed(1234)
model = nn.Sequential(nn.Linear(8, 16, device='cpu'), nn.Tanh(),
                      nn.Linear(16, 4, device='cpu'))
model.eval()
paddle.jit.save(model, sys.argv[1],
                input_spec=[InputSpec([2, 8], name='features')])
EOF
fi

cd "$HERE"
export CGO_ENABLED=1
export CGO_CFLAGS="-I$CAPI_DIR"
export CGO_LDFLAGS="-L$LIBDIR -l:$LIBNAME -Wl,-rpath,$LIBDIR"
go build -o "${GOAPI_DEMO_BIN:-./demo_client}" ./cmd/demo
exec "${GOAPI_DEMO_BIN:-./demo_client}" "$REPO" "$MODEL" "$DEVICE"
