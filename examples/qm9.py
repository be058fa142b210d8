"""QM9 positional experiment (reference `examples/qm9.py`)."""
from functools import partial
from typing import Tuple

from common import parse_args, load_experiment_config  # noqa: E402  (sys.path bootstrap)
from ecnf_jax.targets.data import load_qm9, FullGraphSample
from ecnf_jax.training.loop import run_training
from ecnf_jax.training.setup import setup_training



def load_dataset(
    train_set_size, valid_set_size, final_run: bool
) -> Tuple[FullGraphSample, FullGraphSample]:
    train_data, valid_data, test_data = load_qm9(train_set_size=train_set_size)
    if not final_run:
        return train_data, valid_data[:valid_set_size]
    return train_data, test_data[:valid_set_size]


def run(cfg):
    train_config = setup_training(
        cfg,
        load_dataset=partial(load_dataset, final_run=cfg.training.final_run),
    )
    run_training(train_config)


if __name__ == "__main__":
    config_path, local, overrides = parse_args("qm9.yaml")
    run(load_experiment_config(config_path, local, overrides))
