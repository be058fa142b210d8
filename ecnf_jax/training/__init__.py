from ecnf_jax.training.state import TrainingState, init_training_state, make_update_fn
from ecnf_jax.training.optim import build_optimizer
from ecnf_jax.training.loop import TrainConfig, run_training
from ecnf_jax.training.config import (
    ExperimentConfig,
    FlowConfig,
    TrainingConfig,
    NetworkConfig,
    OptimizerConfig,
    load_config,
)
from ecnf_jax.training.loggers import Logger, ListLogger, CSVLogger, WandbLogger, setup_logger
from ecnf_jax.training.evaluation import (
    eval_fn,
    calculate_forward_ess,
    calculate_reverse_ess,
    setup_padded_reshaped_data,
)
from ecnf_jax.training.setup import setup_training, setup_default_plotter
