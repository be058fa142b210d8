"""2-D mixture-of-Gaussians CNF — the minimum end-to-end example.

Parity with the reference's self-contained `examples/MoG_target.py` (own
train/eval loop, KL + approx-NLL metrics, sample scatter + vector-field
quiver plots at t=0.5 / t=0.01), built on the framework's batched
components.  CPU-runnable.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import itertools
import os
from typing import Tuple

import jax
import jax.numpy as jnp

from ecnf_jax.cnf.build import build_mlp_cnf
from ecnf_jax.cnf.sampling import SolveConfig, sample_cnf, get_log_prob
from ecnf_jax.targets.mog import MoGTarget
from ecnf_jax.training.loggers import ListLogger
from ecnf_jax.training.loop import TrainConfig, run_training
from ecnf_jax.training.optim import build_optimizer
from ecnf_jax.training.state import TrainingState, init_training_state, make_update_fn


def setup_mog_training(
    n_train: int = int(1e4),
    n_test: int = 256,
    n_iteration: int = 100,
    batch_size: int = 64,
    lr: float = 1e-4,
) -> TrainConfig:
    target = MoGTarget()
    key = jax.random.PRNGKey(0)
    key1, key2 = jax.random.split(key)
    train_data = target.sample(key1, (n_train,))
    test_data = target.sample(key2, (n_test,))

    cnf = build_mlp_cnf(dim=2, sigma_min=1e-4, base_scale=5.0)
    optimizer = build_optimizer(lr, use_schedule=False, optimizer_name="adamw")
    update_fn = make_update_fn(cnf, optimizer)
    solve_cfg = SolveConfig()

    def init_state(key):
        return init_training_state(cnf, optimizer, key, example_x=train_data[:2])

    ds_size = train_data.shape[0]
    n_batches = ds_size // batch_size

    def run_epoch(state: TrainingState):
        key, subkey = jax.random.split(state.key)
        perm = jax.random.permutation(subkey, ds_size)[: n_batches * batch_size]
        state = state._replace(key=key)
        batches = train_data[perm].reshape(n_batches, batch_size, 2)

        def scan_body(st, xb):
            st, info = update_fn(st, xb, None)
            return st, info

        state, infos = jax.lax.scan(scan_body, state, batches)
        return state, jax.device_get(infos)

    def eval_and_plot(state, key, iteration_n, save, plots_dir):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        log_prob, _, _ = get_log_prob(
            cnf, state.params, test_data, key, cfg=solve_cfg
        )
        target_log_prob = target.log_prob(test_data)
        info = {
            "test_log_lik": float(jnp.mean(log_prob)),
            "test_kl": float(jnp.mean(target_log_prob - log_prob)),
        }
        log_prob_approx, _, _ = get_log_prob(
            cnf, state.params, test_data, key, approx=True, cfg=solve_cfg
        )
        info["test_approx_log_lik"] = float(jnp.mean(log_prob_approx))

        # Plots: samples + vector-field quivers (reference MoG_target.py:164-196).
        n_plot = 512
        flow_samples = sample_cnf(cnf, state.params, key, n_plot, cfg=solve_cfg)
        fig1, axs = plt.subplots(1)
        axs.plot(flow_samples[:, 0], flow_samples[:, 1], "o", label="flow samples", alpha=0.4)
        axs.plot(
            train_data[:n_plot, 0], train_data[:n_plot, 1], "o",
            label="target samples", alpha=0.4,
        )
        axs.legend()

        fig2, axs = plt.subplots(1, 2, figsize=(10, 5))
        bound, n_points = 8, 10
        pts = jnp.array(
            list(
                itertools.product(
                    jnp.linspace(-bound, bound, n_points),
                    jnp.linspace(-bound, bound, n_points),
                )
            )
        )
        for ax, t_val in zip(axs, (0.5, 0.01)):
            vec = cnf.apply(state.params, pts, jnp.full(n_points**2, t_val), None)
            ax.quiver(pts[:, 0], pts[:, 1], vec[:, 0], vec[:, 1])
            ax.set_title(f"model score at t={t_val}")
            ax.plot(
                train_data[:n_plot, 0], train_data[:n_plot, 1], "o", alpha=0.2
            )

        for j, fig in enumerate([fig1, fig2]):
            if save and plots_dir is not None:
                fig.savefig(
                    os.path.join(plots_dir, "plot_%03i_iter_%08i.png" % (j, iteration_n))
                )
            plt.close(fig)
        return info

    return TrainConfig(
        n_iteration=n_iteration,
        logger=ListLogger(),
        seed=0,
        n_checkpoints=0,
        n_eval=5,
        init_state=init_state,
        update_state=run_epoch,
        eval_and_plot_fn=eval_and_plot,
        save=False,
        save_dir="/tmp",
    )


if __name__ == "__main__":
    config = setup_mog_training()
    run_training(config)
