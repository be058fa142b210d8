"""Alanine-dipeptide experiment (reference `examples/aldp.py`)."""
from functools import partial
from typing import Tuple

from common import parse_args, load_experiment_config  # noqa: E402  (sys.path bootstrap)
from ecnf_jax.targets.data import load_aldp, FullGraphSample
from ecnf_jax.training.loop import run_training
from ecnf_jax.training.setup import setup_training



def load_dataset(
    train_set_size,
    valid_set_size,
    final_run: bool,
    train_path: str,
    test_path: str,
    valid_path: str,
    valid_skip: int = 0,
    test_skip: int = 0,
) -> Tuple[FullGraphSample, FullGraphSample]:
    train_data, valid_data, test_data = load_aldp(
        train_path=train_path,
        test_path=test_path,
        val_path=valid_path,
        train_n_points=train_set_size,
        val_skip_n=valid_skip,
        test_skip_n=test_skip,
    )
    if not final_run:
        return train_data, valid_data[:valid_set_size]
    return train_data, test_data[:valid_set_size]


def run(cfg):
    train_config = setup_training(
        cfg,
        load_dataset=partial(
            load_dataset,
            train_path=cfg.target.train_path,
            test_path=cfg.target.test_path,
            valid_path=cfg.target.valid_path,
            final_run=cfg.training.final_run,
            # Optional frame offsets: carve disjoint eval splits out of a
            # single trajectory file (the only-mini-h5 container case).
            valid_skip=cfg.target.valid_skip,
            test_skip=cfg.target.test_skip,
        ),
    )
    run_training(train_config)


if __name__ == "__main__":
    config_path, local, overrides = parse_args("aldp.yaml")
    # Reference aldp.py:27-40: the ALDP local block shrinks further than
    # the shared one (22 atoms; tiny batches and a 1-block net).  Routed
    # through the validated-override layer so CLI overrides still win.
    run(load_experiment_config(
        config_path, local, overrides,
        local_extra=(
            "training.batch_size=2",
            "training.eval_batch_size=2",
            "training.train_set_size=8",
            "training.test_set_size=8",
            "flow.network.mlp_units=[4]",
            "flow.network.n_blocks_egnn=1",
        ),
    ))
