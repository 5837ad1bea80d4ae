#!/usr/bin/env bash
# The port's accuracy runs on one card, in order, each through
# `python3 -m lsnet_torch.tools.accuracy_run` with the flags of the JAX
# records in docs/accuracy/r5/:
#
#   bbox    phase 7 of chip_smoke.py (a short run, kernels checked), then
#           bbox --dcn --epochs 36 at seed 0, and --eval-only on its last
#           checkpoint at bilinear, backbone=nearest and
#           backbone=nearest,refine=nearest;
#   more    bbox --dcn --epochs 36 at seed 1, segm --epochs 48 --train 320,
#           pose_kbox --epochs 36;
#   again   bbox --dcn --epochs 36 at seeds 0 and 1 once more, each with
#           the three --eval-only deploys on its last checkpoint (a run's
#           own evaluation is at the deployed backbone=nearest only; the
#           backward kernels add with atomics, so a run does not repeat
#           bit for bit);
#   cpv     cpv at the tool's defaults (R18, norm towers, 12 epochs on
#           160 images, seed 0; deployed at backbone=nearest), then
#           --eval-only on its last checkpoint at bilinear; the JAX
#           package's run of the same command on the CPU is
#           docs/accuracy_torch/jax_cpu/cpv/;
#   cpvmore cpv at seed 1, and at seed 0 with the train step in f32
#           (trace.py f32), for the spread of the cpv runs;
#   ste     bbox --dcn --epochs 36 at seed 0 with --train-sampling
#           nearest_ste (every site, the JAX run r5/ste36_clean.json made
#           with LSNET_DCN_SAMPLING=nearest_ste; deployed at nearest
#           everywhere), then --eval-only on its last checkpoint at
#           nearest (matched) and bilinear (mismatched);
#   trace   phase 7 of chip_smoke.py, then docs/accuracy_torch/trace.py's
#           first 20 steps of the bbox --dcn config (CPU f32, card f32
#           twice, card bf16 twice), then bbox --dcn --epochs 36 at seed 0
#           three more times and once with the train step in f32, each
#           with the three --eval-only deploys.
#
#   bash docs/accuracy_torch/run.sh bbox|more|again|ste|trace|cpv|cpvmore [OUT]
#
# Work dirs (data, checkpoints) go to $WORK (default work/accuracy_torch);
# OUT (default work/accuracy_torch_results) receives each run's console
# log, *.log.json and result.json, the card's name and power limit, and
# a sha256 of the port's sources (lsnet_torch/, chip_smoke.py and this
# folder's scripts) as the part found them.
# While a run trains, every checkpoint but its newest is deleted.
set -euo pipefail
part=${1:?bbox, more, again, ste, trace, cpv or cpvmore}
OUT=${2:-work/accuracy_torch_results}
WORK=${WORK:-work/accuracy_torch}
mkdir -p "$OUT" "$WORK"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader \
    | tee "$OUT/card_$part.txt"
find lsnet_torch docs/accuracy_torch chip_smoke.py -type f \
    \( -name '*.py' -o -name '*.cu' -o -name '*.cuh' -o -name '*.sh' \) \
    | sort | xargs sha256sum | sha256sum | tee "$OUT/tree_$part.txt"

(while sleep 20; do
    for d in "$WORK"/*/ckpts; do
        [ -d "$d" ] || continue
        ls -1 "$d" | grep -E '^step_[0-9]+\.pt$' | sort -t_ -k2 -n \
            | head -n -1 | sed "s|^|$d/|" | xargs -r rm -f
    done
done) &
pruner=$!
trap 'kill $pruner' EXIT

# the accuracy run's command; trace.py f32 runs it with an f32 train step
TOOL=(python3 -m lsnet_torch.tools.accuracy_run)

run() {
    local name=$1
    shift
    echo "== $name: $* ($(date -u +%T))"
    "${TOOL[@]}" --out "$WORK/$name" "$@" \
        > "$OUT/$name.console.log" 2>&1 \
        || { tail -n 40 "$OUT/$name.console.log"; return 1; }
    mkdir -p "$OUT/$name"
    cp "$WORK/$name/result.json" "$OUT/$name/"
    cp "$WORK/$name"/*.log.json "$OUT/$name/" 2>/dev/null || true
    tail -n 2 "$OUT/$name.console.log"
}

# the three deploy policies on the last checkpoint of run $1, named $2*
deploys() {
    local ckpt
    ckpt=$(ls -1 "$WORK/$1/ckpts" | grep -E '^step_[0-9]+\.pt$' \
        | sort -t_ -k2 -n | tail -n 1)
    for s in bilinear backbone=nearest backbone=nearest,refine=nearest; do
        run "$2${s//[=,]/_}" --task bbox --dcn --eval-only \
            "$WORK/$1/ckpts/$ckpt" --sampling "$s"
    done
}

case $part in
bbox)
    python3 chip_smoke.py --only accuracy > "$OUT/phase7.log" 2>&1 \
        || { tail -n 40 "$OUT/phase7.log"; exit 1; }
    tail -n 3 "$OUT/phase7.log"
    run bbox_dcn36_s0 --task bbox --dcn --epochs 36 --seed 0
    deploys bbox_dcn36_s0 ev_
    ;;
again)
    for seed in 0 1; do
        run "bbox_dcn36_s${seed}b" --task bbox --dcn --epochs 36 \
            --seed "$seed"
        deploys "bbox_dcn36_s${seed}b" "ev_s${seed}b_"
    done
    ;;
ste)
    run ste36_s0 --task bbox --dcn --epochs 36 --seed 0 \
        --train-sampling nearest_ste
    ckpt=$(ls -1 "$WORK/ste36_s0/ckpts" | grep -E '^step_[0-9]+\.pt$' \
        | sort -t_ -k2 -n | tail -n 1)
    for s in nearest bilinear; do
        run "ev_ste_$s" --task bbox --dcn --eval-only \
            "$WORK/ste36_s0/ckpts/$ckpt" --sampling "$s"
    done
    ;;
trace)
    python3 chip_smoke.py --only accuracy > "$OUT/phase7.log" 2>&1 \
        || { tail -n 40 "$OUT/phase7.log"; exit 1; }
    tail -n 3 "$OUT/phase7.log"
    python3 docs/accuracy_torch/trace.py steps --out "$WORK/trace" \
        > "$OUT/trace.console.log" 2>&1 \
        || { tail -n 40 "$OUT/trace.console.log"; exit 1; }
    mkdir -p "$OUT/trace"
    cp "$WORK/trace/trace.json" "$OUT/trace/"
    grep -v '^\[\|^environment\|checkpoint ->' "$OUT/trace.console.log"
    for r in c d e; do
        run "bbox_dcn36_s0$r" --task bbox --dcn --epochs 36 --seed 0
        deploys "bbox_dcn36_s0$r" "ev_s0${r}_"
    done
    TOOL=(python3 docs/accuracy_torch/trace.py f32)
    run bbox_dcn36_s0_f32 --task bbox --dcn --epochs 36 --seed 0
    TOOL=(python3 -m lsnet_torch.tools.accuracy_run)
    deploys bbox_dcn36_s0_f32 ev_s0_f32_
    ;;
cpv)
    run cpv12 --task cpv
    ckpt=$(ls -1 "$WORK/cpv12/ckpts" | grep -E '^step_[0-9]+\.pt$' \
        | sort -t_ -k2 -n | tail -n 1)
    run cpv12_ev_bilinear --task cpv --eval-only "$WORK/cpv12/ckpts/$ckpt" \
        --sampling bilinear
    ;;
cpvmore)
    run cpv12_s1 --task cpv --seed 1
    TOOL=(python3 docs/accuracy_torch/trace.py f32)
    run cpv12_f32 --task cpv
    ;;
more)
    run bbox_dcn36_s1 --task bbox --dcn --epochs 36 --seed 1
    run segm48 --task segm --epochs 48 --train 320
    run kbox36 --task pose_kbox --epochs 36
    ;;
*)
    echo "unknown part $part" >&2
    exit 2
    ;;
esac
