#!/usr/bin/env bash
# The learner's rate under each matmul rule of the networks, on one card:
# bench_torch.py's train half (whole PPO epochs of the task's train yaml at
# 8192 envs) for each task, in the order parent, f32, bf16_operands,
# bf16_operands, f32, parent, one process each, nothing else on the card.
#
#   bash tools/bench_matmul.sh PARENT_DIR [TASK ...]    # default Humanoid ShadowHand
#   PAIRS=N bash tools/bench_matmul.sh PARENT_DIR [TASK ...]
#
# With PAIRS=N it runs N pairs of parent and f32 for each task instead,
# alternating which side runs first.
#
# PARENT_DIR holds a checkout of the commit compared against (its
# bench_torch.py times exact f32 networks). Each run's JSON line, tagged
# with its arm, is appended to chiprun_out/bench_matmul.jsonl; the card's
# name and power limit come first.
set -u
PARENT=${1:?usage: bash tools/bench_matmul.sh PARENT_DIR [TASK ...]}
shift
TASKS=${*:-Humanoid ShadowHand}
OUT=chiprun_out/bench_matmul.jsonl
mkdir -p chiprun_out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
HERE=$(pwd)
bench() {   # bench ARM DIR TASK [RULE]
    local line
    line=$(cd "$2" && BENCH_TASK=$3 BENCH_NUM_ENVS=4096 BENCH_STEPS=16 \
        BENCH_NET_MATMUL=${4:-f32} timeout 600 python3 bench_torch.py | tail -n 1)
    echo "{\"arm\": \"$1\", \"task\": \"$3\", \"row\": ${line:-null}}" | tee -a "$HERE/$OUT"
}
if [ -n "${PAIRS:-}" ]; then
    for task in $TASKS; do
        for i in $(seq 1 "$PAIRS"); do
            if [ $((i % 2)) -eq 1 ]; then
                bench parent "$PARENT" "$task"
                bench f32 . "$task" f32
            else
                bench f32 . "$task" f32
                bench parent "$PARENT" "$task"
            fi
        done
    done
    exit 0
fi
for task in $TASKS; do
    bench parent "$PARENT" "$task"
    bench f32 . "$task" f32
    bench bf16_operands . "$task" bf16_operands
    bench bf16_operands . "$task" bf16_operands
    bench f32 . "$task" f32
    bench parent "$PARENT" "$task"
done
