"""Hutch++ vs plain Hutchinson on a trained model: RMSE at matched JVP budget.

Hutch++ (`ops/divergence.py: value_and_hutchpp_divergence`,
`SolveConfig(hutchpp_sketch=m1)`) sketches the Jacobian's dominant
subspace (2*m1 JVPs) and runs plain probes only on the residual (m2
JVPs).  Whether that beats plain Hutchinson at the same total JVP count
depends on the *trained* EGNN Jacobian's spectrum — this measures it on
real test data, integrated through the full log-density solve (the
estimator runs at every ODE stage, so per-stage variance compounds into
the integrated delta-log-lik).

Usage: python scripts/hutchpp_study.py [ckpt_dir]
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

from ecnf_jax.cnf.build import build_cnf
from ecnf_jax.cnf.sampling import SolveConfig, get_log_prob
from ecnf_jax.targets.data import load_lj13
from ecnf_jax.training.checkpoints import get_latest_checkpoint, restore_checkpoint
from ecnf_jax.training.optim import build_optimizer
from ecnf_jax.training.state import init_training_state

CKPT_DIR = sys.argv[1] if len(sys.argv) > 1 else "/tmp/lj13_rk4/model_checkpoints"
N_TEST = 64
N_KEYS = 8  # repetitions per stochastic estimator
FIXED = dict(use_fixed_step_size=True, step_size=0.05, method="rk4")


def main():
    train, valid, test = load_lj13(1000)
    pos = test.positions[:N_TEST]
    pos = pos - pos.mean(axis=1, keepdims=True)
    x = jnp.asarray(pos.reshape(N_TEST, -1), jnp.float32)
    feats = jnp.asarray(test.features[:N_TEST].reshape(N_TEST, -1))

    cnf = build_cnf(
        n_frames=13, dim=3, sigma_min=0.01, base_scale=1.0,
        n_blocks_egnn=3, mlp_units=(128, 128, 128),
        n_invariant_feat_hidden=64, time_embedding_dim=8, n_features=1,
    )
    optimizer = build_optimizer(
        1e-4, use_schedule=True, peak_lr=1e-4, end_lr=0.0,
        n_iter_warmup=10, n_iter_total=400 * 15,
    )
    state0 = init_training_state(cnf, optimizer, jax.random.PRNGKey(0), x[:2], feats[:2])
    latest = get_latest_checkpoint(CKPT_DIR)
    assert latest, f"no checkpoint in {CKPT_DIR}"
    print("restoring", latest)
    params = restore_checkpoint(latest, state0).params

    # Ground truth: exact trace under the SAME fixed-step solver, so the
    # comparison isolates estimator error from solver error.
    exact = jax.jit(
        lambda xb: get_log_prob(
            cnf, params, xb, jax.random.PRNGKey(0), feats,
            cfg=SolveConfig(**FIXED),
        )[0]
    )(x)
    exact = np.asarray(jax.block_until_ready(exact))
    print(f"exact (39 JVP cols): mean log_p {exact.mean():.4f}")

    # (label, cfg, JVPs/stage)
    cases = [
        ("hutchinson K=4", SolveConfig(hutchinson_probes=4, **FIXED), 4),
        ("hutchinson K=8", SolveConfig(hutchinson_probes=8, **FIXED), 8),
        ("hutchinson K=12", SolveConfig(hutchinson_probes=12, **FIXED), 12),
        ("hutch++ m1=2 m2=4", SolveConfig(hutchpp_sketch=2, hutchinson_probes=4, **FIXED), 8),
        ("hutch++ m1=4 m2=4", SolveConfig(hutchpp_sketch=4, hutchinson_probes=4, **FIXED), 12),
        ("hutch++ m1=8 m2=4", SolveConfig(hutchpp_sketch=8, hutchinson_probes=4, **FIXED), 20),
    ]
    for label, cfg, jvps in cases:
        fn = jax.jit(
            lambda xb, k, cfg=cfg: get_log_prob(
                cnf, params, xb, k, feats, approx=True, cfg=cfg
            )[0]
        )
        t0 = time.perf_counter()
        lps = np.stack([
            np.asarray(jax.block_until_ready(fn(x, jax.random.PRNGKey(7 + i))))
            for i in range(N_KEYS)
        ])
        dt = (time.perf_counter() - t0) / N_KEYS
        err = lps - exact[None]
        rmse = float(np.sqrt(np.mean(err**2)))
        bias = float(np.mean(err))
        print(
            f"{label} ({jvps} JVPs/stage): RMSE {rmse:.3f} nats, "
            f"bias {bias:+.3f}, {dt*1e3:.0f} ms/solve"
        )


if __name__ == "__main__":
    main()
