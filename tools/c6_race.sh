#!/usr/bin/env bash
# Fault C6's race on the CPU (ROADMAP §C6): TASK (default BallBalance) at
# 4096 envs for EPOCHS epochs (default 120), runs side by side, each pinned
# to cores of its own. Every run saves its state at its last epoch
# (save_frequency=EPOCHS), under OUT/<run>/runs/<TASK>/nn/last.
# A run is KIND:SEED:
#   jax:S   the JAX package's trainer (scripts/train.py, unchanged,
#           pipeline=cpu) at seed S, run from a directory of its own under
#           OUT, so that its runs/ lands there
#   port:S  the port's trainer (device=cpu, the default learner) at seed S
# The race is the default, RUNS="jax:42 jax:0 port:42"; two more seeds are
# RUNS="jax:1 port:0" CORES="0-1 2-3". Each run's history.json and the
# CPU's model name (cpu.txt, in place of a card's card.txt) go to
# results_torch/<TASK>_c6_race_<kind><seed>/; logs to OUT/logs. A JAX run's
# last state is carried into a port model.pt by
#   python tests/torch_jax_checkpoint.py task=<TASK> \
#       checkpoint=<OUT>/jax42/runs/<TASK>/nn/last out=results_torch/<TASK>_c6_jaxstate
# Read the runs with
#   python tests/torch_learning_report.py results_torch/BallBalance_c6_race_port42/history.json \
#       jax=results/BallBalance/history.json start=40 every=40 window=80 keys=critic_loss
#   python tests/torch_learning_report.py results_torch/FrankaCabinet_c6_race_port42/history.json \
#       jax=results/FrankaCabinet/history.json keys=wave
#
#   bash tools/c6_race.sh [TASK=BallBalance] [EPOCHS=120] [OUT=build/c6_race] \
#       [RUNS=...] [CORES="0-1 2-3 4-5"] [EXTRA="key=value ..."] [TAG=_suffix]
#
# EXTRA goes to every run's command line (e.g.
# EXTRA=train.params.config.value_bootstrap=True, the setting the JAX TPU
# records of BallBalance and FrankaCabinet were trained under); TAG ends
# the records' directory names.
#
# BallBalance's 120 epochs take some 22 minutes on two cores of an Intel
# Xeon a run; FrankaCabinet's 63 some 70 (JAX) and 95 (the port). The
# records of the runs are overwritten.
set -u
for a in "$@"; do export "$a"; done
OUT=${OUT:-$(cd "$(dirname "$0")/.." && pwd)/build/c6_race}
read -r -a RUN_LIST <<< "${RUNS:-jax:42 jax:0 port:42}"
read -r -a CORE_LIST <<< "${CORES:-0-1 2-3 4-5}"
ROOT=$(cd "$(dirname "$0")/.." && pwd)
mkdir -p "$OUT/logs"
OUT=$(cd "$OUT" && pwd)
CPU=$(grep -m1 "model name" /proc/cpuinfo | sed 's/.*: //')
TASK=${TASK:-BallBalance}
EPOCHS=${EPOCHS:-120}
ARGS="task=$TASK num_envs=4096 max_iterations=$EPOCHS train.params.config.save_frequency=$EPOCHS ${EXTRA:-}"

t0=$SECONDS
names=()
for i in "${!RUN_LIST[@]}"; do
    kind=${RUN_LIST[$i]%%:*}
    seed=${RUN_LIST[$i]##*:}
    name=$kind$seed
    case $kind in
    jax) mod=omniisaacgymenvs_tpu.scripts.train; where=pipeline=cpu ;;
    port) mod=omniisaacgymenvs_torch.scripts.train; where=device=cpu ;;
    *) echo "unknown run ${RUN_LIST[$i]}" >&2; exit 2 ;;
    esac
    mkdir -p "$OUT/$name"
    (cd "$OUT/$name" && OMP_NUM_THREADS=2 PYTHONPATH="$ROOT" taskset -c "${CORE_LIST[$i]}" \
        python -m $mod $ARGS seed=$seed $where > "$OUT/logs/$name.log" 2>&1
     echo "rc $?" >> "$OUT/logs/$name.log") &
    names+=("$name")
done
wait
echo "race done in $((SECONDS - t0)) s"
for r in "${names[@]}"; do
    dst="$ROOT/results_torch/${TASK}_c6_race_$r${TAG:-}"
    mkdir -p "$dst"
    cp "$OUT/$r/runs/$TASK/history.json" "$dst/"
    echo "$CPU" > "$dst/cpu.txt"
    echo "== $r"; tail -n 3 "$OUT/logs/$r.log" | cut -c1-200
done
