"""Fixed-step method accuracy: rk4 vs dopri5 at step 0.05 on a trained DW4.

The rk4 fixed-step option (`SolveConfig(method="rk4")`) costs 4 field
evaluations per step vs Dopri5's 6 — 1.47x end-to-end on the headline
task (docs/PERF.md).  This measures what that buys/costs in accuracy:
per-point log-density deviation of each fixed-step method from the
adaptive exact-trace solve (rtol=atol=1e-5, the reference's tolerance,
treated as ground truth) on real test data under a trained model.

Usage: python scripts/method_accuracy_study.py [ckpt_dir]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

from ecnf_jax.cnf.build import build_cnf
from ecnf_jax.cnf.sampling import SolveConfig, get_log_prob
from ecnf_jax.targets.data import load_dw4
from ecnf_jax.training.checkpoints import get_latest_checkpoint, restore_checkpoint
from ecnf_jax.training.optim import build_optimizer
from ecnf_jax.training.state import init_training_state

CKPT_DIR = sys.argv[1] if len(sys.argv) > 1 else "/tmp/dw4_rk4_study/model_checkpoints"
N_TEST = 256


def main():
    train, valid, test = load_dw4(1000)
    test_pos = test.positions[:N_TEST]
    test_pos = test_pos - test_pos.mean(axis=1, keepdims=True)
    x = test_pos.reshape(N_TEST, -1)
    feats = test.features[:N_TEST].reshape(N_TEST, -1)

    cnf = build_cnf(
        n_frames=4, dim=2, sigma_min=0.01, base_scale=1.0,
        n_blocks_egnn=3, mlp_units=(128, 128, 128),
        n_invariant_feat_hidden=64, time_embedding_dim=8, n_features=1,
    )
    optimizer = build_optimizer(
        1e-4, use_schedule=True, peak_lr=1e-4, end_lr=0.0,
        n_iter_warmup=10, n_iter_total=200 * 15,
    )
    state0 = init_training_state(cnf, optimizer, jax.random.PRNGKey(0), x[:2], feats[:2])
    latest = get_latest_checkpoint(CKPT_DIR)
    assert latest, f"no checkpoint in {CKPT_DIR}"
    print("restoring", latest)
    params = restore_checkpoint(latest, state0).params

    # Ground truth: the adaptive solve at the reference tolerances; its own
    # convergence is pinned by the 1e-6 row (agrees to ~7e-4 nats).  Tighter
    # f32 tolerances are unattainable — the controller rejects down to dtmin
    # until max_steps and the (now NaN-frozen) solve never converges.
    configs = {
        "adaptive (ground truth, tol 1e-5)": SolveConfig(),
        "adaptive tol 1e-6 (convergence check)": SolveConfig(rtol=1e-6, atol=1e-6),
        "dopri5 @ 0.05": SolveConfig(use_fixed_step_size=True, step_size=0.05),
        "rk4 @ 0.2": SolveConfig(use_fixed_step_size=True, step_size=0.2, method="rk4"),
        "rk4 @ 0.1": SolveConfig(use_fixed_step_size=True, step_size=0.1, method="rk4"),
        "rk4 @ 0.05": SolveConfig(
            use_fixed_step_size=True, step_size=0.05, method="rk4"
        ),
        "rk4 @ 0.025": SolveConfig(
            use_fixed_step_size=True, step_size=0.025, method="rk4"
        ),
    }
    out = {}
    for name, cfg in configs.items():
        lp = jax.jit(
            lambda xb, cfg=cfg: get_log_prob(
                cnf, params, xb, jax.random.PRNGKey(1), feats, cfg=cfg
            )[0]
        )(x)
        out[name] = np.asarray(jax.block_until_ready(lp))
        print(f"{name}: mean log_p {out[name].mean():.6f}")

    ref = out["adaptive (ground truth, tol 1e-5)"]
    for name in list(configs)[1:]:
        d = out[name] - ref
        print(
            f"{name} vs adaptive: mean |Δ| {np.abs(d).mean():.2e}, "
            f"max |Δ| {np.abs(d).max():.2e}, mean Δ {d.mean():+.2e} nats"
        )


if __name__ == "__main__":
    main()
