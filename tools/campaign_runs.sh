# Sourced by the arms scripts (tools/c3_arms.sh, c4_arms.sh, c6_arms.sh,
# learning_record.sh): the campaign runner (scripts/campaign.py), where a
# call's records and logs go, the card's name and power limit, one runner
# in the background, and each log's summary.
C="python -m omniisaacgymenvs_torch.scripts.campaign"
BACK=chiprun_out   # what the call brings back
OUT=$BACK/campaign
LOGS=$BACK/logs
mkdir -p "$OUT" "$LOGS"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$BACK/card.txt"
python -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)'

# runner SECONDS NAME ARGS...: experiment NAME in the background, stopped
# after SECONDS (SIGTERM: it kills its child and keeps its last nn/last),
# its records in $OUT and its output in $LOGS/NAME.log
runner() {
    local secs=$1 name=$2
    shift 2
    timeout -s TERM "$secs" $C "$name" "$@" out="$OUT" > "$LOGS/$name.log" 2>&1 &
}

# summary LINES PATTERN: the last LINES lines of each log that match PATTERN
summary() {
    local f
    for f in "$LOGS"/*.log; do
        echo "== $f"
        grep -a "$2" "$f" | tail -n "$1" | cut -c1-300
    done
}
