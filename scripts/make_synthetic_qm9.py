"""Generate the SYNTHETIC QM9-positional stand-in dataset, reproducibly.

Real QM9 requires network egress (`ecnf_jax/targets/qm9.py` downloads GDB9
from figshare, parity with the reference's
`qm9_download_data/data/prepare/qm9.py:28-35`); this container has none.
This script writes seeded Gaussian stand-ins with the real pipeline's
shapes (19 heavy atoms after hydrogen removal + padding,
`qm9_download_data/dataset.py:43-61`) so the *full flagship config* —
16k iterations, batch 256, EMA, bf16 — can be exercised end-to-end on
hardware.  The quality numbers from such a run are NOT QM9 quality
numbers; `data/QM9_SYNTHETIC_NOTE.txt` marks the outputs.

Sizes: train 6,400 (= 25 batches of 256, the scale used for the round-1/2
hardware soaks), valid/test 1,000 each.
"""
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

N_ATOMS, DIM = 19, 3
SIZES = {"train": 6400, "valid": 1000, "test": 1000}
SEED = 20260819
NOTE = (
    "SYNTHETIC stand-in data (rng gaussians, not real QM9) used for hardware\n"
    "validation of the full 16k-iteration QM9 config; see BASELINE.md.\n"
    "Regenerate with scripts/make_synthetic_qm9.py (seed %d).\n"
    "Replace with qm9pos_download_and_save_data output where egress exists.\n"
    % SEED
)


def main(out_dir: str) -> None:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(SEED)
    for split, n in SIZES.items():
        pos = rng.normal(size=(n, N_ATOMS, DIM)).astype(np.float32) * 1.5
        pos -= pos.mean(axis=1, keepdims=True)
        np.save(out / f"qm9pos_{split}.npy", pos)
        print(f"wrote {out / f'qm9pos_{split}.npy'} {pos.shape}")
    (out / "QM9_SYNTHETIC_NOTE.txt").write_text(NOTE)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else str(Path(__file__).resolve().parent.parent / "data"))
