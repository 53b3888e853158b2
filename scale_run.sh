#!/bin/bash
# The port at one corpus size on one card, the steps PERF.md's scale
# readings come from:
#
#     bash scale_run.sh DOCS OUT_DIR [DEVICE_MEM_BUDGET [PARENT_TREE]]
#
# 1. python3 -m fugu_tpu_torch.bench at BENCH_DOCS=DOCS (builds and
#    caches the corpus first);
# 2. mix_timing.py on the cached corpus with --profile and --kernels,
#    the phrase router in turns auto, stream, host, host, stream, auto
#    and --overlap 0;
# 3. with PARENT_TREE (a tree unpacked with git archive), mix_timing.py
#    --tree PARENT_TREE on the same corpus, the router as it has it;
# 4. tools/live_load.py at 64 connections;
# 5. python3 -m fugu_tpu_torch.tools.residency_live (its defaults: 16M
#    and 1M docs, 200 MB of headroom), while time is left.
#
# Steps 1 to 4 run with FUGU_DEVICE_MEM_BUDGET=DEVICE_MEM_BUDGET when it
# is given (an empty argument: the card's auto budget).  Each step's output goes to OUT_DIR/<step>.{out,err}, one
# line a step to OUT_DIR/summary.txt; every 15 s OUT_DIR/monitor.txt
# gets the host memory in use (MiB, `free -m`) and the card's memory in
# use and power draw.  The steps share a deadline of 3,420 s.
cd "$(dirname "$0")"
DOCS=$1
O=$2
BUDGET=${3:+FUGU_DEVICE_MEM_BUDGET=$3}
mkdir -p "$O"
END=$(( $(date +%s) + 3420 ))
{ nvidia-smi --query-gpu=name,power.limit --format=csv,noheader; free -g; df -h .; nproc; } > "$O/machine.txt" 2>&1
( while true; do
    echo "$(date +%s) $(free -m | awk '/Mem:/{print $3}') MB host, $(nvidia-smi --query-gpu=memory.used,power.draw --format=csv,noheader)"
    sleep 15
  done ) > "$O/monitor.txt" 2>&1 &
MON=$!
t() {
  local name=$1 cap=$2; shift 2
  local left=$(( END - $(date +%s) ))
  [ "$left" -lt "$cap" ] && cap=$left
  if [ "$cap" -lt 60 ]; then echo "$name skipped (no time)" | tee -a "$O/summary.txt"; return; fi
  local t0=$(date +%s)
  timeout "$cap" "$@" > "$O/$name.out" 2> "$O/$name.err"
  echo "$name rc=$? secs=$(( $(date +%s) - t0 )) end=$(date +%s)" | tee -a "$O/summary.txt"
}
PARENT=$4
t bench 2000 env BENCH_DOCS="$DOCS" $BUDGET python3 -m fugu_tpu_torch.bench
t mix 1000 env $BUDGET python3 mix_timing.py --namespace ".bench_cache/ns$DOCS" --docs "$DOCS" --bench-cache --passes 5 --profile "$O/prof" --kernels --phrase-route auto,stream,host,host,stream,auto --overlap 0
[ -n "$PARENT" ] && t mix_parent 600 env $BUDGET python3 mix_timing.py --tree "$PARENT" --namespace ".bench_cache/ns$DOCS" --docs "$DOCS" --bench-cache --passes 5
t load 700 env $BUDGET python3 -m fugu_tpu_torch.tools.live_load --docs "$DOCS" --concurrency 64 --requests 1024 --profiled 256
t drill 900 python3 -m fugu_tpu_torch.tools.residency_live
kill $MON
free -g >> "$O/machine.txt"
cat "$O/summary.txt"
