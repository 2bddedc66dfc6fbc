#!/usr/bin/env bash
# The arms of fault C6 (ROADMAP §C6) on one card, side by side, each through
# scripts/campaign.py with its records in chiprun_out/campaign: the networks
# in exact f32 against the learner's default rule (net_matmul=bf16_operands),
# read against the JAX package's sigma curve
# (tests/torch_learning_report.py keys=sigma).
#
#   bash tools/c6_arms.sh arms     # f32 on FrankaCabinet and BallBalance, seed 42
#   bash tools/c6_arms.sh seeds    # f32 on FrankaCabinet at seed 0, the rule at seed 1
#   bash tools/c6_arms.sh states   # the trained states of tests/test_torch_c6_value.py
#   bash tools/c6_arms.sh bootstrap  # the default learner with value_bootstrap=True
#
# arms, seed 42:
#   FrankaCabinet_c6_f32    4096 envs, 750 epochs
#   BallBalance_c6_f32      4096 envs, 1500 epochs (LEARNING.json's budget)
#   FrankaCabinet_c6_check  the rule for 50 epochs, to hold the card's run
#                           against results_torch/FrankaCabinet's first
#                           epochs (runs are reproducible bit for bit)
# The control (the rule at seed 42) is results_torch/FrankaCabinet and
# results_torch/BallBalance.
# seeds: FrankaCabinet_c6_f32_seed0 (seed 0, 750 epochs),
# FrankaCabinet_c6_rule_seed1 (the rule at seed 1, 750 epochs) and
# Crazyflie_seed1 (the rule at seed 1, LEARNING.json's 1000 epochs).
# The records results_torch/*_c6_{f32value,fwd,3x}* ran under three more
# rules, since taken out of the tree; PERF.md (Findings, fault C6) says
# what each computed.
#
# states: BallBalance and FrankaCabinet under the default learner, seed 42,
# 150 epochs each through scripts/train.py, side by side; each run's
# model.pt (epoch 150), history.json and the card's line go to
# chiprun_out/c6_state/<task>/, to be committed as
# results_torch/<task>_c6_state/ (no campaign, no carry).
#
# bootstrap: the setting the JAX TPU records of both tasks were trained
# under (`value_bootstrap: True`, removed from both train yamls after the
# records were written): FrankaCabinet_c6_vb (seed 42) and
# FrankaCabinet_c6_vb_seed0, 750 epochs each, and BallBalance_c6_vb (seed
# 42, 1500 epochs), under the default rule.
#
# DUR (seconds, default 2400) stops every runner. The runs' output goes to
# chiprun_out/logs/ (gzipped at the end); the command ends with `campaign
# carry`, which packs each experiment's records.
set -u
MODE=${1:-arms}
DUR=${DUR:-2400}
F32=train.params.config.net_matmul=f32
RULE=train.params.config.net_matmul=bf16_operands
FRANKA="max_iterations=750 train.params.config.save_frequency=50"
. "$(dirname "$0")/campaign_runs.sh"

case "$MODE" in
arms)
    runner "$DUR" FrankaCabinet_c6_f32 FrankaCabinet seed=42 $F32 $FRANKA
    runner "$DUR" BallBalance_c6_f32 BallBalance seed=42 $F32 max_iterations=1500
    runner "$DUR" FrankaCabinet_c6_check FrankaCabinet seed=42 $RULE \
        max_iterations=50 train.params.config.save_frequency=50
    ;;
seeds)
    runner "$DUR" FrankaCabinet_c6_f32_seed0 FrankaCabinet seed=0 $F32 $FRANKA
    runner "$DUR" FrankaCabinet_c6_rule_seed1 FrankaCabinet seed=1 $RULE $FRANKA
    runner "$DUR" Crazyflie_seed1 Crazyflie seed=1 $RULE
    ;;
bootstrap)
    VB=train.params.config.value_bootstrap=True
    runner "$DUR" FrankaCabinet_c6_vb FrankaCabinet seed=42 $VB $FRANKA
    runner "$DUR" FrankaCabinet_c6_vb_seed0 FrankaCabinet seed=0 $VB $FRANKA
    runner "$DUR" BallBalance_c6_vb BallBalance seed=42 $VB max_iterations=1500
    ;;
states)
    for t in BallBalance FrankaCabinet; do
        timeout -s TERM "$DUR" python -m omniisaacgymenvs_torch.scripts.train \
            task=$t seed=42 max_iterations=150 experiment=${t}_c6_state \
            train.params.config.save_frequency=50 > "$LOGS/${t}_c6_state.log" 2>&1 &
    done
    wait
    for t in BallBalance FrankaCabinet; do
        mkdir -p "$BACK/c6_state/$t"
        cp runs/${t}_c6_state/nn/last/model.pt runs/${t}_c6_state/history.json \
            "$BACK/card.txt" "$BACK/c6_state/$t/"
    done
    summary 4 "^trained \|kernel launches\|Error\|error"
    exit 0
    ;;
*)
    echo "usage: bash tools/c6_arms.sh arms|seeds|states|bootstrap" >&2
    exit 2
    ;;
esac
wait
echo "=== runners done at t=${SECONDS}s"
summary 6 "^===\|^trained \|kernel launches\|Error\|error"
gzip -f "$LOGS"/*.log
$C carry "$OUT"
exit 0
