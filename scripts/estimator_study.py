"""Exact-trace vs K-probe Hutchinson log-density: accuracy/cost.

Scores the same configurations under a trained checkpoint with the exact
trace and with K ∈ {1, 4, 16} Hutchinson probes (the reference is fixed at
one probe, `ecnf/cnf/sample_and_log_prob.py:55`), reporting per-point RMSE
vs exact and wall-clock — the measured basis for choosing
`SolveConfig(hutchinson_probes=...)` on large-D eval.

Usage (after a QM9 run):
    python scripts/estimator_study.py --checkpoint-dir runs/qm9_synth/model_checkpoints \
        --data data/qm9pos_test.npy --n 64
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

from ecnf_jax.cnf.build import build_cnf
from ecnf_jax.cnf.sampling import SolveConfig, get_log_prob
from ecnf_jax.training.checkpoints import get_latest_checkpoint, restore_checkpoint


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint-dir", default="runs/qm9_synth/model_checkpoints")
    p.add_argument("--data", default="data/qm9pos_test.npy")
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--probes", type=int, nargs="*", default=[1, 4, 16])
    args = p.parse_args()

    pos = np.load(args.data)[: args.n].astype(np.float32)
    n_nodes, dim = pos.shape[1], pos.shape[2]
    pos = pos - pos.mean(axis=1, keepdims=True)
    x = jnp.asarray(pos.reshape(args.n, n_nodes * dim))
    feats = jnp.zeros((args.n, n_nodes), dtype=jnp.int32)

    # QM9 reference net (examples/configs/qm9.yaml).
    cnf = build_cnf(
        n_frames=n_nodes, dim=dim, sigma_min=1e-6, base_scale=2.0,
        n_blocks_egnn=5, mlp_units=(256,) * 4, n_invariant_feat_hidden=32,
        time_embedding_dim=8, n_features=1, compute_dtype="bfloat16",
    )
    params = cnf.init(jax.random.PRNGKey(0), x[:2], jnp.zeros(2), feats[:2])
    latest = get_latest_checkpoint(args.checkpoint_dir)
    assert latest, f"no checkpoint under {args.checkpoint_dir}"
    print(f"restoring {latest}", file=sys.stderr)
    params = restore_checkpoint(latest, {"params": params}, partial=True)["params"]

    key = jax.random.PRNGKey(7)

    def run(approx, probes):
        cfg = SolveConfig(hutchinson_probes=probes)
        fn = jax.jit(
            lambda xb, k: get_log_prob(cnf, params, xb, k, feats, approx=approx, cfg=cfg)[0]
        )
        t0 = time.perf_counter()
        lp = jax.block_until_ready(fn(x, key))
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        lp = jax.block_until_ready(fn(x, key))
        run_s = time.perf_counter() - t0
        return np.asarray(lp), compile_s, run_s

    lp_exact, c, t = run(False, 1)
    print(f"exact (D={n_nodes*dim}, plan): {t:.1f}s/run (compile {c:.0f}s), "
          f"mean {lp_exact.mean():.4f}")
    for k in args.probes:
        lp, c, t = run(True, k)
        rmse = float(np.sqrt(np.mean((lp - lp_exact) ** 2)))
        bias = float(np.mean(lp - lp_exact))
        print(f"hutchinson K={k:>2}: {t:.1f}s/run (compile {c:.0f}s), "
              f"mean {lp.mean():.4f}, RMSE vs exact {rmse:.4f}, bias {bias:+.4f}")


if __name__ == "__main__":
    main()
