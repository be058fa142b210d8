"""Evaluate a trained DW4 checkpoint: NLL, ESS, and f32-vs-bf16 deltas.

Validates scientific quality end-to-end on real hardware and quantifies
the bf16 compute path's effect on the quality metrics.
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

from ecnf_jax.cnf.build import build_cnf
from ecnf_jax.cnf.sampling import SolveConfig, get_log_prob, sample_and_log_prob_cnf
from ecnf_jax.targets.data import load_dw4
from ecnf_jax.targets.energies import double_well_log_prob
from ecnf_jax.training.checkpoints import get_latest_checkpoint, restore_checkpoint
from ecnf_jax.training.evaluation import calculate_forward_ess, calculate_reverse_ess

CKPT_DIR = sys.argv[1] if len(sys.argv) > 1 else "/root/repo/runs/dw4_full/model_checkpoints"
N_TEST = 256
N_MODEL_SAMPLES = 512


def build(compute_dtype):
    return build_cnf(
        n_frames=4, dim=2, sigma_min=0.01, base_scale=1.0,
        n_blocks_egnn=3, mlp_units=(128, 128, 128),
        n_invariant_feat_hidden=64, time_embedding_dim=8, n_features=1,
        compute_dtype=compute_dtype,
    )


def main():
    train, valid, test = load_dw4(1000)
    test_pos = test.positions[:N_TEST]
    test_pos = test_pos - test_pos.mean(axis=1, keepdims=True)
    test_flat = test_pos.reshape(N_TEST, -1)
    feats = test.features[:N_TEST].reshape(N_TEST, -1)

    from ecnf_jax.training.optim import build_optimizer
    from ecnf_jax.training.state import init_training_state

    cnf = build(None)
    # Must match the training optimizer's state structure (schedule on).
    optimizer = build_optimizer(
        1e-4, use_schedule=True, peak_lr=1e-4, end_lr=0.0,
        n_iter_warmup=10, n_iter_total=200 * 15,
    )
    state0 = init_training_state(
        cnf, optimizer, jax.random.PRNGKey(0), test_flat[:2], feats[:2]
    )
    latest = get_latest_checkpoint(CKPT_DIR)
    assert latest, f"no checkpoint in {CKPT_DIR}"
    print("restoring", latest)
    state = restore_checkpoint(latest, state0)
    params = state.params

    cfg = SolveConfig()
    for name, dtype in (("f32", None), ("bf16", "bfloat16")):
        cnf_d = build(dtype)
        t0 = time.perf_counter()
        log_q, log_pb, delta = jax.jit(
            lambda x, k: get_log_prob(cnf_d, params, x, k, feats, cfg=cfg)
        )(test_flat, jax.random.PRNGKey(1))
        jax.block_until_ready(log_q)
        t_nll = time.perf_counter() - t0

        log_p = double_well_log_prob(test_flat.reshape(-1, 4, 2))
        fwd_ess = calculate_forward_ess(
            log_p - log_q, jnp.ones(N_TEST, dtype=jnp.int32)
        )["forward_ess"]

        samples, log_q_model = jax.jit(
            lambda k: sample_and_log_prob_cnf(
                cnf_d, params, k, N_MODEL_SAMPLES, feats[:1].repeat(N_MODEL_SAMPLES, 0), cfg=cfg
            )
        )(jax.random.PRNGKey(2))
        jax.block_until_ready(samples)
        log_w_rev = double_well_log_prob(samples.reshape(-1, 4, 2)) - log_q_model
        rv_ess = calculate_reverse_ess(log_w_rev)

        print(
            f"[{name}] test_log_lik={float(jnp.mean(log_q)):.4f}  "
            f"forward_ess={float(fwd_ess):.4f}  rv_ess={float(rv_ess):.4f}  "
            f"(nll eval incl. compile: {t_nll:.1f}s)"
        )


if __name__ == "__main__":
    main()
