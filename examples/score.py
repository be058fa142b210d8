"""Score configurations under a trained CNF: batched log-density serving.

A serving surface with no reference analogue (the reference can only score
inside its eval loop, `ecnf/setup_training.py:190-218`): load a checkpoint,
read a ``.npy`` of configurations, and emit per-point log-densities —
exact trace or Hutchinson — batched and sharded over every visible device.

Usage:
    python score.py --config configs/lj13.yaml \
        --checkpoint-dir runs/lj13/model_checkpoints \
        --data my_configs.npy --output logp.npy [--approx] [key=value ...]

The model is rebuilt from the same YAML (+ dotted overrides) the training
CLI used; data may be ``[n, N, D]`` or flat ``[n, N*D]`` and is zero-CoM'd
exactly as training data is (`ecnf_jax/training/setup.py`).
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import argparse
import time

import numpy as np
import jax
import jax.numpy as jnp

from common import CONFIG_DIR
from ecnf_jax.cnf.build import build_cnf
from ecnf_jax.cnf.sampling import SolveConfig, get_log_prob
from ecnf_jax.parallel.mesh import get_mesh, data_sharded, replicated, pad_to_multiple
from ecnf_jax.training.checkpoints import get_latest_checkpoint, restore_serving_params
from ecnf_jax.training.config import load_config


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default=str(CONFIG_DIR / "lj13.yaml"))
    parser.add_argument("--checkpoint-dir", type=str, required=True)
    parser.add_argument("--data", type=str, required=True, help=".npy of positions")
    parser.add_argument("--output", type=str, default=None, help="write log-probs here")
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--approx", action="store_true", help="Hutchinson estimate")
    parser.add_argument("--features", choices=["zeros", "arange"], default="zeros",
                        help="node features: zeros (DW4/LJ13/QM9) or per-atom index (ALDP)")
    parser.add_argument("--ema", action="store_true",
                        help="serve the EMA parameters (reference final-eval semantics\n for use_ema configs, `setup_training.py:229-230`)")
    parser.add_argument("--freeze-params", action="store_true",
                        help="bake the checkpoint weights into the compiled "
                        "program as XLA constants, letting XLA fold "
                        "weight-only work; the compile is slower, above all "
                        "for exact-trace solves")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("overrides", nargs="*", help="dotted config overrides")
    args = parser.parse_args()

    cfg = load_config(args.config, overrides=args.overrides)

    raw = np.load(args.data)
    if raw.ndim == 3:
        n_nodes, dim = raw.shape[1], raw.shape[2]
    elif raw.ndim == 2:
        # Flat [n, N*D]: take N, D from the config's target family via a
        # best-effort 3-D assumption unless divisible by 2 only.
        raise SystemExit("pass data as [n, n_nodes, dim]; flat layout is ambiguous")
    else:
        raise SystemExit(f"expected rank-3 data, got shape {raw.shape}")
    pos = jnp.asarray(raw, dtype=jnp.float32)
    pos = pos - jnp.mean(pos, axis=1, keepdims=True)  # zero-CoM, as in training
    x = pos.reshape(pos.shape[0], n_nodes * dim)

    if args.features == "arange":
        feats_row = jnp.arange(n_nodes, dtype=jnp.int32)
        n_features = n_nodes
    else:
        feats_row = jnp.zeros((n_nodes,), dtype=jnp.int32)
        n_features = 1

    net_cfg = cfg.flow.network
    cnf = build_cnf(
        n_frames=n_nodes,
        dim=dim,
        sigma_min=cfg.flow.sigma_min,
        base_scale=cfg.flow.base_scale,
        n_blocks_egnn=net_cfg.n_blocks_egnn,
        mlp_units=tuple(net_cfg.mlp_units),
        n_invariant_feat_hidden=net_cfg.n_invariant_feat_hidden,
        time_embedding_dim=net_cfg.time_embedding_dim,
        n_features=n_features,
        stable_mlp=net_cfg.stable_mlp,
        compute_dtype=net_cfg.compute_dtype,
    )
    params = cnf.init(
        jax.random.PRNGKey(0), x[:2], jnp.zeros(2), jnp.tile(feats_row, (2, 1))
    )
    latest = get_latest_checkpoint(args.checkpoint_dir)
    if latest is None:
        raise SystemExit(f"no checkpoint under {args.checkpoint_dir}")
    print(f"restoring {latest}")
    try:
        params = restore_serving_params(latest, params, ema=args.ema)
    except ValueError as e:
        raise SystemExit(str(e))

    mesh = get_mesh()
    n_dev = len(mesh.devices.reshape(-1))
    B = pad_to_multiple(min(args.batch_size, x.shape[0]), n_dev)
    if cfg.training.compile_cache:
        from ecnf_jax.utils.compile_cache import enable_persistent_compilation_cache

        enable_persistent_compilation_cache()

    solve_cfg = SolveConfig(
        use_fixed_step_size=cfg.training.use_fixed_step_size,
        method=cfg.training.ode_method,
        hutchinson_probes=cfg.training.hutchinson_probes,
    )

    # Params as a runtime argument by default; --freeze-params bakes them
    # in as XLA constants (fold-heavy compile once per process).
    def _score(p, xb, key, fb):
        return get_log_prob(
            cnf, p, xb, key, fb, approx=args.approx, cfg=solve_cfg
        )[0]

    fb = jnp.tile(feats_row, (B, 1))
    x0b = jnp.zeros((B, x.shape[1]), x.dtype)
    t0 = time.perf_counter()
    if args.freeze_params:
        score = jax.jit(
            lambda xb, key, fb: _score(params, xb, key, fb),
            in_shardings=(data_sharded(mesh), replicated(mesh),
                          data_sharded(mesh)),
            out_shardings=data_sharded(mesh),
        )
        _score_c = score.lower(x0b, jax.random.PRNGKey(0), fb).compile()
        score_c = lambda p, xb, key, fb: _score_c(xb, key, fb)
    else:
        score = jax.jit(
            _score,
            in_shardings=(replicated(mesh), data_sharded(mesh),
                          replicated(mesh), data_sharded(mesh)),
            out_shardings=data_sharded(mesh),
        )
        score_c = score.lower(
            params, x0b, jax.random.PRNGKey(0), fb
        ).compile()
        params = jax.device_put(params, replicated(mesh))
    print(f"trace+compile {time.perf_counter() - t0:.1f}s")

    n = x.shape[0]
    out = np.empty((n,), np.float32)
    starts = list(range(0, n, B))
    # One eager split for all keys + double-buffered consumption: eager
    # ops or blocking reads between dispatches serialize the async
    # dispatch pipeline.
    keys = jax.random.split(jax.random.PRNGKey(args.seed), len(starts))
    from collections import deque

    pending = deque()

    def consume(start, pad, lp_dev):
        out[start : start + B - pad] = np.asarray(lp_dev)[: B - pad]

    t0 = time.perf_counter()
    for i, start in enumerate(starts):
        chunk = x[start : start + B]
        pad = B - chunk.shape[0]
        if pad:
            chunk = jnp.concatenate([chunk, jnp.zeros((pad, chunk.shape[1]))], 0)
        pending.append((start, pad, score_c(params, chunk, keys[i], fb)))
        if len(pending) > 1:
            consume(*pending.popleft())
    while pending:
        consume(*pending.popleft())
    dt = time.perf_counter() - t0

    print(
        f"scored {n} configurations in {dt:.2f}s ({n / dt:.1f}/s, "
        f"{n_dev} device(s), {'Hutchinson' if args.approx else 'exact'} trace): "
        f"mean log-prob {out.mean():.4f}"
    )
    if args.output:
        np.save(args.output, out)
        print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
