#!/usr/bin/env bash
# The A/B arms of fault C3 (ROADMAP §C3) on one card, side by side, each
# through scripts/campaign.py with its state carried in chiprun_out/campaign
# (the carry rule: README, "Training campaigns").
#
#   bash tools/c3_arms.sh arms     # R, F, T, B, S, AllegroHand_T, BallBalance_T
#   bash tools/c3_arms.sh resume   # ShadowHand_T on to 10,000
#   bash tools/c3_arms.sh seed0    # ShadowHand_T_seed0
#   bash tools/c3_arms.sh allegro0 # AllegroHand_T_seed0
#
# Each arm names its networks' matmul rule (train.params.config.net_matmul):
# "f32" (exact) or "bf16_operands", the TPU's default precision (the
# learner's default).
#
# arms:
#   R  ShadowHand_R     the JAX package's trained state (written by
#                       tests/torch_jax_checkpoint.py) trained on for 500
#                       epochs, f32
#   F  ShadowHand_F     the same start with lr 0 for 100 epochs: the JAX
#                       policy, stochastic, in the port's env on the card
#   T  ShadowHand_T     from epoch 0, the networks' products at the TPU's
#                       default precision (net_matmul=bf16_operands); runs on
#                       towards 10,000
#   B  ShadowHand_B     from epoch 0 to 2000, bf16 networks under autocast
#   S  ShadowHand_seed0 from epoch 0 to 2000, f32, seed 0
#   AllegroHand_T, BallBalance_T: T's rule on the other hand (towards 10,000)
#   and on BallBalance (1500 epochs)
# seed0: ShadowHand_T_seed0, T's rule at seed 0 to epoch 2000 (it may run
# beside `resume`). allegro0: AllegroHand_T_seed0, T's rule on AllegroHand at
# seed 0 to epoch 1000, against PR 12's f32 seed-0 run (fault C4).
# resume: unpacks build/campaign/*.tar.gz and continues ShadowHand_T to
# 10,000. A finished experiment is not named again: `carry` deleted its
# nn/last, so the runner would start it over from epoch 0.
#
# DUR (seconds, default 3150) stops every runner (SIGTERM: each kills its
# child and keeps its last nn/last); each starts a chunk only while one as
# long as its last ends by UNTIL (default DUR - 400). Then `campaign carry`
# packs the records and the unfinished runs' nn/last for the next machine.
set -u
MODE=${1:-arms}
DUR=${DUR:-3150}
UNTIL=${UNTIL:-$((DUR - 400))}
F32=train.params.config.net_matmul=f32
TPU=train.params.config.net_matmul=bf16_operands
. "$(dirname "$0")/campaign_runs.sh"

run() {   # run NAME ARGS...: one runner for DUR seconds, its chunks by UNTIL
    runner "$DUR" "$@" until_s="$UNTIL"
}

case "$MODE" in
arms)
    # R and F start from the JAX state: epoch 9980, off the yaml's save
    # boundary of 100, so they save every 20 epochs
    mkdir -p runs/ShadowHand_R/nn/last
    cp results_torch/ShadowHand_jax_final/model.pt runs/ShadowHand_R/nn/last/
    python tests/torch_checkpoint_set.py \
        results_torch/ShadowHand_jax_final runs/ShadowHand_F/nn/last lr=0
    run ShadowHand_R ShadowHand seed=42 $F32 max_iterations=10480 \
        train.params.config.save_frequency=20 chunk=500
    run ShadowHand_F ShadowHand seed=42 $F32 max_iterations=10080 \
        train.params.config.save_frequency=20
    run ShadowHand_T ShadowHand seed=42 $TPU chunk=500
    run ShadowHand_B ShadowHand seed=42 train.params.config.mixed_precision=True \
        max_iterations=2000 chunk=500
    run ShadowHand_seed0 ShadowHand seed=0 $F32 max_iterations=2000 chunk=500
    run AllegroHand_T AllegroHand seed=42 $TPU chunk=500
    run BallBalance_T BallBalance seed=42 $TPU max_iterations=1500
    ;;
resume)
    for a in build/campaign/*.tar.gz; do tar xzf "$a" -C "$OUT"; done
    run ShadowHand_T ShadowHand seed=42 $TPU chunk=500
    ;;
seed0)
    run ShadowHand_T_seed0 ShadowHand seed=0 $TPU max_iterations=2000 chunk=500
    ;;
allegro0)
    run AllegroHand_T_seed0 AllegroHand seed=0 $TPU max_iterations=1000
    ;;
*)
    echo "usage: bash tools/c3_arms.sh arms|resume|seed0|allegro0" >&2
    exit 2
    ;;
esac
wait
summary 40 "^===\|trained \|kernel launches\|Error\|error"
$C carry "$OUT"
