"""DW4 experiment: 4-particle double-well (reference `examples/dw4.py`)."""
from functools import partial
from typing import Optional, Tuple

from common import parse_args, load_experiment_config  # noqa: E402  (sys.path bootstrap)
from ecnf_jax.targets.data import load_dw4, FullGraphSample
from ecnf_jax.targets.energies import double_well_log_prob
from ecnf_jax.training.loop import run_training
from ecnf_jax.training.setup import setup_training



def load_dataset(
    train_set_size: int, valid_set_size: Optional[int], final_run: bool
) -> Tuple[FullGraphSample, FullGraphSample]:
    train, valid, test = load_dw4(train_set_size)
    if not final_run:
        return train, valid[:valid_set_size]
    return train, test[:valid_set_size]


def run(cfg):
    train_config = setup_training(
        cfg,
        load_dataset=partial(load_dataset, final_run=cfg.training.final_run),
        target_log_prob_fn=double_well_log_prob,
    )
    run_training(train_config)


if __name__ == "__main__":
    config_path, local, overrides = parse_args("dw4.yaml")
    # Reference dw4.py:27: the DW4 local block additionally widens the base.
    run(load_experiment_config(
        config_path, local, overrides, local_extra=("flow.base_scale=2.0",)
    ))
