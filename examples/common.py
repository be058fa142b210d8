"""Shared CLI plumbing for the example entry points.

Replaces the reference's hydra decorators (`examples/dw4.py:22` etc.) with
argparse + the typed YAML config system; supports the same dotted
``key=value`` overrides and the reference's in-code ``--local`` debug-scale
block (`dw4.py:24-38`).
"""
import argparse
import sys
from pathlib import Path
from typing import Optional, Sequence

# Allow running the examples directly from a checkout without installation.
_REPO_ROOT = Path(__file__).resolve().parent.parent
if str(_REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(_REPO_ROOT))

# Multi-host wiring must precede ANY jax backend touch; a no-op unless a
# launcher provided a coordinator (COORDINATOR_ADDRESS or explicit args) —
# see `ecnf_jax/parallel/distributed.py`.
from ecnf_jax.parallel.distributed import maybe_initialize_distributed

maybe_initialize_distributed()

from ecnf_jax.training.config import ExperimentConfig, load_config

CONFIG_DIR = Path(__file__).resolve().parent / "configs"


def parse_args(default_config: str) -> tuple:
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--config", type=str, default=str(CONFIG_DIR / default_config)
    )
    parser.add_argument(
        "--local",
        action="store_true",
        help="debug-scale override block (reference examples' `local` flag)",
    )
    parser.add_argument(
        "overrides", nargs="*", help="dotted config overrides, e.g. training.batch_size=8"
    )
    args = parser.parse_args()
    return args.config, args.local, args.overrides


# Debug-scale settings, matching the reference examples' `local` blocks
# (`dw4.py:24-38`, `lj13.py:24-37`, `qm9.py:23-36`).  Applied before CLI
# overrides so explicit `key=value` arguments always win.
LOCAL_OVERRIDES = (
    "logger={list_logger: null}",
    "training.save=false",
    "training.batch_size=8",
    "training.eval_batch_size=9",
    "training.n_training_iter=10",
    "training.train_set_size=80",
    "training.test_set_size=80",
    "training.plot_batch_size=16",
    "flow.network.mlp_units=[16]",
    "flow.network.n_blocks_egnn=2",
    "flow.network.n_invariant_feat_hidden=8",
    "flow.network.time_embedding_dim=6",
)


def load_experiment_config(
    config_path: str,
    local: bool,
    overrides: Sequence[str],
    local_extra: Sequence[str] = (),
) -> ExperimentConfig:
    """Load a config with optional debug-scale (`--local`) overrides.

    `local_extra` carries the per-target deltas of the reference's in-code
    blocks (DW4 additionally sets `flow.base_scale=2.`, `dw4.py:27`; ALDP
    shrinks further, `aldp.py:27-40`); it is layered on top of
    LOCAL_OVERRIDES but below explicit CLI overrides.
    """
    all_overrides = (
        (list(LOCAL_OVERRIDES) + list(local_extra)) if local else []
    ) + list(overrides)
    return load_config(config_path, overrides=all_overrides)
