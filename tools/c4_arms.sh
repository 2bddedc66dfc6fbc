#!/usr/bin/env bash
# The card's arms of fault C4 (ROADMAP §C4): AllegroHand's seed panel under
# both networks' matmul rules, and its fall rates through K1 and the plain
# path (tests/torch_fall_rates.py), on one card.
#
#   bash tools/c4_arms.sh panel      # six runners side by side, fall rates beside
#   bash tools/c4_arms.sh policies   # the carried policies' fall rates
#   bash tools/c4_arms.sh row        # AllegroHand seed 42 under the default
#
# panel: AllegroHand_seed{1,2,3} (f32, the default) and AllegroHand_T_seed{1,2,3}
# (net_matmul=bf16_operands, the TPU's default precision) at the yaml's 8192
# envs to epoch 2000, each through scripts/campaign.py with its records in
# $BACK/campaign; beside them, policy=hold:4 at 8192 envs x 150 steps
# through K1 (the form launch_config picks), K1's thread form and the plain
# path. Then the epoch-2000 model.pt of AllegroHand_seed1 and
# AllegroHand_T_seed1 is kept in $BACK/c4/policies/<exp>/ (the
# networks, Adam moments and norms; `campaign carry` deletes a finished
# run's nn/last).
# policies: each carried policy (POLICIES: directories holding a model.pt,
# default those two as committed under results_torch/), mode=sample and
# mode=mean, at 8192 envs x 601 steps through K1 and the plain path.
# row: AllegroHand at seed 42 under the learner's default networks (the
# TPU's matmul rule) towards 10,000 epochs, as experiment AllegroHand,
# resumed from build/campaign/AllegroHand.tar.gz where a call before left it.
#
# DUR (seconds, default 2950) stops every runner (SIGTERM); each starts a
# chunk only while one as long as its last ends by UNTIL (default DUR - 250).
set -u
MODE=${1:-panel}
DUR=${DUR:-2950}
UNTIL=${UNTIL:-$((DUR - 250))}
F32=train.params.config.net_matmul=f32
TPU=train.params.config.net_matmul=bf16_operands
POLICIES=${POLICIES:-"results_torch/AllegroHand_seed1 results_torch/AllegroHand_T_seed1"}
. "$(dirname "$0")/campaign_runs.sh"
C4=$BACK/c4
mkdir -p "$C4"

run() {   # run NAME ARGS...: one runner for DUR seconds, its chunks by UNTIL
    runner "$DUR" "$@" until_s="$UNTIL"
}

case "$MODE" in
panel)
    for s in 1 2 3; do
        run "AllegroHand_seed$s" AllegroHand seed=$s $F32 max_iterations=2000 chunk=500
        run "AllegroHand_T_seed$s" AllegroHand seed=$s $TPU max_iterations=2000 chunk=500
    done
    python tests/torch_fall_rates.py policy=hold:4 runs=k1,thread,plain \
        num_envs=8192 steps=150 seed=0 out="$C4/hold4_card.json" \
        > "$LOGS/fall_rates_hold4.log" 2>&1
    wait
    for e in AllegroHand_seed1 AllegroHand_T_seed1; do
        mkdir -p "$C4/policies/$e"
        cp "runs/$e/nn/last/model.pt" "$C4/policies/$e/" \
            && python -c 'import sys, torch; print(sys.argv[1], torch.load(sys.argv[1],
                weights_only=True, map_location="cpu")["epoch"])' "$C4/policies/$e/model.pt"
    done
    ;;
policies)
    for p in $POLICIES; do
        for m in sample mean; do
            python tests/torch_fall_rates.py checkpoint="$p" mode=$m runs=k1,plain \
                num_envs=8192 steps=601 seed=0 out="$C4/$(basename "$p")_$m.json" \
                > "$LOGS/fall_rates_$(basename "$p")_$m.log" 2>&1
            tail -n 3 "$LOGS/fall_rates_$(basename "$p")_$m.log" | cut -c1-400
        done
    done
    ;;
row)
    [ -f build/campaign/AllegroHand.tar.gz ] && tar xzf build/campaign/AllegroHand.tar.gz -C "$OUT"
    run AllegroHand AllegroHand seed=42 chunk=500
    wait
    ;;
*)
    echo "usage: bash tools/c4_arms.sh panel|policies|row" >&2
    exit 2
    ;;
esac
summary 20 "^===\|trained \|kernel launches\|Error\|error\|^k1\|^thread\|^plain\|^group"
[ "$MODE" = policies ] || $C carry "$OUT"
exit 0
