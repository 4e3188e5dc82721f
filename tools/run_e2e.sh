#!/usr/bin/env bash
# End-to-end acceptance protocol on the analytic torus case: a compressed
# full schedule (30k iters, 20k warm-up — the reference's 2:1 ratio,
# /root/reference/confs/wmask_rnb.conf:23-24) that crosses the
# warm-up->main phase boundary, survives a mid-run kill + resume, extracts
# a 512^3 mesh, and must pass the Chamfer gate (tools/acceptance.py).
#
# Usage: tools/run_e2e.sh [KILL_AFTER_SECONDS]  (default 240; 0 = no kill)
#
# One JAX process at a time: each stage (the killed run included) ends before
# the next starts, so a card is never shared between two of them.
set -euo pipefail
cd "$(dirname "$0")/.."

CASE=torus_e2e
KILL_AFTER="${1:-240}"
ITERS="${E2E_ITERS:-30000}"
WARMUP="${E2E_WARMUP:-20000}"
OVR=(--set train.end_iter=${ITERS} --set train.warm_up_iter=${WARMUP}
     --set train.warm_up_end=500 --set train.save_freq=2000
     --set train.val_freq=10000 --set train.val_mesh_freq=10000
     --set train.report_freq=500)

echo "== [1/4] synthetic torus case"
python tools/make_synthetic_case.py --out data/${CASE} --shape torus \
    --n_views 8 --size 256

EXP=exp/${CASE}/wmask_rnb
rm -rf "${EXP}"

if [ "${KILL_AFTER}" != "0" ]; then
  echo "== [2/4] train, killing after ${KILL_AFTER}s to exercise resume"
  python exp_runner.py --mode train_rnb --conf confs/wmask_rnb.conf \
      --case ${CASE} "${OVR[@]}" &
  PID=$!
  sleep "${KILL_AFTER}"
  kill ${PID} 2>/dev/null || true
  wait ${PID} 2>/dev/null || true
  echo "   killed pid ${PID}; checkpoints so far:"
  ls "${EXP}/checkpoints" || true
  echo "== [3/4] resume with --is_continue to completion + 512^3 extraction"
else
  echo "== [2-3/4] train to completion + 512^3 extraction"
fi
python exp_runner.py --mode train_rnb --conf confs/wmask_rnb.conf \
    --case ${CASE} --is_continue "${OVR[@]}" --mesh_resolution 512

echo "== [4/4] acceptance gate"
python tools/acceptance.py "${EXP}" --shape torus \
    --warm_up_iter ${WARMUP} --threshold "${E2E_THRESHOLD:-0.005}"
