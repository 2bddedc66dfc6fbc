#!/usr/bin/env bash
# The port's learning record under its default learner, on one card
# (ROADMAP §D): the nine short reference tasks at LEARNING.json's budgets
# and ShadowHand_DR at 16384 envs over 10,000 epochs, seed 42, no
# net_matmul override, each through scripts/campaign.py with its records in
# chiprun_out/campaign.
#
#   bash tools/learning_record.sh first   # the rule's cost alone, then DR beside the nine
#   bash tools/learning_record.sh dr      # DR on from build/campaign/ShadowHand_DR.tar.gz
#
# first: scripts/profile_epoch.py on FrankaCabinet at 4096 envs and on
# ShadowHand at 8192, each under net_matmul=f32 and under the default (the
# TPU's matmul rule), one after the other, alone on the card (logs in
# chiprun_out/profile/); then ShadowHand_DR (chunk=200) and the nine short
# tasks side by side. BallBalance and Ingenuity take LEARNING.json's budgets
# (max_iterations=1500 and 1000; their yamls say 250 and 400).
# dr: ShadowHand_DR resumed in chunks of CHUNK (default 500) epochs and,
# beside it, each task named in SEED0 (default none) as <task>_seed0 at
# seed 0, at the same budget as its seed-42 row.
#
# END (seconds from the script's start, default 3400) stops every runner
# (SIGTERM); DR starts a chunk only while one as long as its last ends by
# END less MARGIN (default 120) and the start-up before it. The runs'
# output goes to chiprun_out/logs/ (gzipped at the end); the command ends
# with `campaign carry`, which packs each unfinished experiment.
set -u
MODE=${1:-first}
END=${END:-3400}
MARGIN=${MARGIN:-120}
CHUNK=${CHUNK:-500}
SEED0=${SEED0:-}
C="python -m omniisaacgymenvs_torch.scripts.campaign"
BACK=chiprun_out   # what the call brings back
OUT=$BACK/campaign
LOGS=$BACK/logs
DR="task.env.numEnvs=16384 task.domain_randomization.randomize=True"
mkdir -p "$OUT" "$LOGS" "$BACK/profile"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$BACK/card.txt"
python -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)'

budget() {   # the overrides that set a short task's LEARNING.json budget
    case $1 in
    BallBalance) echo max_iterations=1500 ;;
    Ingenuity) echo max_iterations=1000 ;;
    esac
}

run() {   # run NAME UNTIL ARGS...: one runner in the background, its log kept
    local name=$1 until=$2
    shift 2
    timeout -s TERM $((END - SECONDS)) $C "$name" "$@" out="$OUT" until_s="$until" \
        > "$LOGS/$name.log" 2>&1 &
}

dr_until() {   # until_s for a DR runner started now
    echo $((END - SECONDS - MARGIN))
}

case "$MODE" in
first)
    for spec in FrankaCabinet:4096 ShadowHand:8192; do
        task=${spec%:*}
        n=${spec#*:}
        for rule in f32 default; do
            over=""
            [ $rule = f32 ] && over=train.params.config.net_matmul=f32
            echo "=== profile_epoch $task $n $rule (t=${SECONDS}s)"
            python -m omniisaacgymenvs_torch.scripts.profile_epoch task=$task \
                num_envs=$n seed=42 $over > "$BACK/profile/${task}_$rule.log" 2>&1
            echo "rc=$?"
            tail -n 14 "$BACK/profile/${task}_$rule.log" | cut -c1-300
        done
    done
    echo "=== campaigns start at t=${SECONDS}s"
    run ShadowHand_DR "$(dr_until)" ShadowHand $DR seed=42 chunk=200
    for t in Cartpole Ant Humanoid Anymal BallBalance Crazyflie Quadcopter Ingenuity \
            FrankaCabinet; do
        run "$t" 0 "$t" seed=42 $(budget "$t")
    done
    wait
    ;;
dr)
    [ -f build/campaign/ShadowHand_DR.tar.gz ] \
        && tar xzf build/campaign/ShadowHand_DR.tar.gz -C "$OUT"
    run ShadowHand_DR "$(dr_until)" ShadowHand $DR seed=42 chunk="$CHUNK"
    for t in $SEED0; do
        run "${t}_seed0" 0 "$t" seed=0 $(budget "$t")
    done
    wait
    ;;
*)
    echo "usage: bash tools/learning_record.sh first|dr" >&2
    exit 2
    ;;
esac
echo "=== runners done at t=${SECONDS}s"
for f in "$LOGS"/*.log; do
    echo "== $f"
    grep -a "^===\|^trained \|kernel launches\|Error\|error" "$f" | tail -n 8 | cut -c1-300
done
gzip -f "$LOGS"/*.log
$C carry "$OUT"
exit 0
