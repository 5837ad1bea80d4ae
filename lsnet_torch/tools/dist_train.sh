#!/usr/bin/env bash
# Data-parallel training on one host: GPUS processes, one card each, with
# the global batch of samples_per_gpu x GPUS images (torchrun's
# standalone rendezvous on localhost).
#   bash lsnet_torch/tools/dist_train.sh CONFIG GPUS [tools.train args...]
set -euo pipefail
CONFIG=$1
GPUS=$2
shift 2
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
exec python3 -m torch.distributed.run --standalone --nproc_per_node="$GPUS" \
    -m lsnet_torch.tools.train "$CONFIG" --launcher pytorch "$@"
