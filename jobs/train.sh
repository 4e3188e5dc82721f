#!/usr/bin/env bash
# Single-host GPU training launch (equivalent of the reference's per-scene
# SLURM jobs, /root/reference/jobs/run_job_bearPNG_001.job — 1 GPU, 24h).
# One process drives every GPU of the host: the runner's default --shard auto
# splits each ray batch over all visible cards (pick them with
# CUDA_VISIBLE_DEVICES; --shard off trains on the first card only).
#
# Usage: jobs/train.sh CASE [CONF] [EXTRA_ARGS...]
#
# Per-case hyperparameter templating (the reference jobs regenerate the conf
# via heredoc with CASE/N_ITERATIONS/BATCH_SIZE/LEARNING_RATE,
# run_job_bearPNG_001.job:20-111) is done with env vars mapped to conf
# overrides instead — one command reproduces any of the 12 reference job
# variants:
#
#   N_ITERATIONS=1000 BATCH_SIZE=512 LEARNING_RATE=5e-4 WARM_UP_ITER=700 \
#     jobs/train.sh bearPNG ./confs/wmask_rnb.conf
#
# Arbitrary extra overrides pass through as EXTRA_ARGS, e.g.
#   jobs/train.sh bearPNG ./confs/wmask_rnb.conf --set train.remat=true
set -euo pipefail

CASE="${1:?usage: train.sh CASE [CONF] [extra args]}"
CONF="${2:-./confs/wmask_rnb.conf}"
shift || true; shift || true

REPO="$(cd "$(dirname "$0")/.." && pwd)"
export PYTHONPATH="${REPO}:${PYTHONPATH:-}"

OVERRIDES=()
[ -n "${N_ITERATIONS:-}" ]  && OVERRIDES+=(--set "train.end_iter=${N_ITERATIONS}")
[ -n "${WARM_UP_ITER:-}" ]  && OVERRIDES+=(--set "train.warm_up_iter=${WARM_UP_ITER}")
[ -n "${BATCH_SIZE:-}" ]    && OVERRIDES+=(--set "train.batch_size=${BATCH_SIZE}")
[ -n "${LEARNING_RATE:-}" ] && OVERRIDES+=(--set "train.learning_rate=${LEARNING_RATE}")

LOG_DIR="${REPO}/exp/${CASE}/logs_launch"
mkdir -p "${LOG_DIR}"
STAMP="$(date +%Y%m%d_%H%M%S)"

python "${REPO}/exp_runner.py" \
    --mode train_rnb \
    --conf "${CONF}" \
    --case "${CASE}" \
    ${OVERRIDES[@]+"${OVERRIDES[@]}"} \
    "$@" 2>&1 | tee "${LOG_DIR}/train_${STAMP}.log"
