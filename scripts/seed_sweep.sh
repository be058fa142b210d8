#!/usr/bin/env bash
# Train-seed variance sweep (VERDICT r4 next-steps 3 & 8): retrain DW4 and
# LJ13 at the full shipped configs across 3 seeds each, then evaluate every
# final checkpoint with the bootstrap harness
# (`scripts/quality_error_bars.py`).  Separating the axes:
#   - bootstrap CI over test points / model samples  = MC (estimator) error
#   - per-seed reverse-ESS spread                    = eval-seed variance
#   - across-retrain spread (this sweep)             = train-seed variance
#
# LJ13 uses the rk4 fixed-step eval recipe during TRAINING for speed
# (quality-validated equal in BASELINE.md: -38.32 vs -38.38, rv 0.068);
# the error-bar EVALUATION afterwards uses the reference adaptive dopri5.
# One process per card at a time.
set -euo pipefail
cd "$(dirname "$0")/.."
mkdir -p measurements/r5

for seed in 0 1 2; do
  echo "=== DW4 seed $seed ==="
  python examples/dw4.py \
    training.seed=$seed \
    training.save_dir="'runs/sweep_dw4_s$seed'" \
    logger='{csv_logger: {save_period: 100}}' \
    2>&1 | tail -3
  python scripts/quality_error_bars.py dw4 \
    runs/sweep_dw4_s$seed/model_checkpoints \
    --json measurements/r5/dw4_errbars_s$seed.json | tail -5
done

for seed in 0 1 2; do
  echo "=== LJ13 seed $seed ==="
  python examples/lj13.py \
    training.seed=$seed \
    training.use_fixed_step_size=true \
    training.ode_method=rk4 \
    training.save_dir="'runs/sweep_lj13_s$seed'" \
    logger='{csv_logger: {save_period: 100}}' \
    2>&1 | tail -3
  python scripts/quality_error_bars.py lj13 \
    runs/sweep_lj13_s$seed/model_checkpoints \
    --rv-samples 10000 --rv-chunk 1000 \
    --json measurements/r5/lj13_errbars_s$seed.json | tail -5
done
