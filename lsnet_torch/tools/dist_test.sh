#!/usr/bin/env bash
# Evaluate a checkpoint with GPUS processes, one card each: every rank
# decodes its share of the val images and rank 0 prints the metrics.
#   bash lsnet_torch/tools/dist_test.sh CONFIG CHECKPOINT GPUS [tools.test args...]
set -euo pipefail
CONFIG=$1
CHECKPOINT=$2
GPUS=$3
shift 3
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
exec python3 -m torch.distributed.run --standalone --nproc_per_node="$GPUS" \
    -m lsnet_torch.tools.test "$CONFIG" "$CHECKPOINT" --launcher pytorch "$@"
