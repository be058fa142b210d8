"""LJ13 experiment: 13-particle Lennard-Jones (reference `examples/lj13.py`)."""
from functools import partial
from typing import Tuple

from common import parse_args, load_experiment_config  # noqa: E402  (sys.path bootstrap)
from ecnf_jax.targets.data import load_lj13, FullGraphSample
from ecnf_jax.targets.energies import lennard_jones_log_prob
from ecnf_jax.training.loop import run_training
from ecnf_jax.training.setup import setup_training



def load_dataset(
    train_set_size: int, valid_set_size: int, final_run: bool
) -> Tuple[FullGraphSample, FullGraphSample]:
    train, valid, test = load_lj13(train_set_size)
    if not final_run:
        return train, valid[:valid_set_size]
    return train, test[:valid_set_size]


def run(cfg):
    train_config = setup_training(
        cfg,
        load_dataset=partial(load_dataset, final_run=cfg.training.final_run),
        target_log_prob_fn=lennard_jones_log_prob,
    )
    run_training(train_config)


if __name__ == "__main__":
    config_path, local, overrides = parse_args("lj13.yaml")
    run(load_experiment_config(config_path, local, overrides))
