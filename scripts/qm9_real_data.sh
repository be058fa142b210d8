#!/usr/bin/env bash
# Real-QM9 end-to-end, single command (standing VERDICT item — run the
# moment network egress exists):
#   1. remove the synthetic stand-ins (load_qm9 refuses them by default),
#   2. download + process GDB9 via the torch-free pipeline
#      (`ecnf_jax/targets/qm9.py`; identical seed-0 splits to the
#      reference's `qm9_download_data/prepare/qm9.py`),
#   3. train the full flagship config (16k iterations, EMA, bf16,
#      grouped dispatch),
#   4. the run's final eval (EMA weights, Hutchinson K=4 log-prob on the
#      real test split) is the REAL QM9 test NLL — record it in
#      BASELINE.md "Trained-model quality (QM9)".
set -euo pipefail
cd "$(dirname "$0")/.."

echo "== 1/3 clearing synthetic stand-ins =="
for f in data/qm9pos_train.npy data/qm9pos_valid.npy data/qm9pos_test.npy \
         data/QM9_SYNTHETIC_NOTE.txt; do
  [ -f "$f" ] && rm -v "$f"
done

echo "== 2/3 download + process GDB9 (figshare; needs egress) =="
python - << 'EOF'
from ecnf_jax.targets.qm9 import qm9pos_download_and_save_data
qm9pos_download_and_save_data(base_path="data")
EOF

echo "== 3/3 full flagship training run =="
exec python examples/qm9.py \
  training.save_dir=runs/qm9_real \
  "logger={csv_logger: {save_period: 2000}}"
