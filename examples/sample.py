"""Generate configurations from a trained CNF: batched sampling serving.

Completes the serving pair with `score.py` (no reference analogue — the
reference only samples inside its plotter/eval closures,
`ecnf/setup_training.py:40-65,166-185`): load a checkpoint, draw samples by
integrating the flow, optionally attach exact/Hutchinson log-densities, and
write an ``[n, n_nodes, dim]`` ``.npy`` — batched and sharded over every
visible device.

Usage:
    python sample.py --config configs/lj13.yaml \
        --checkpoint-dir runs/lj13/model_checkpoints \
        --n-samples 4096 --output samples.npy \
        [--with-log-prob [--approx]] [key=value ...]
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
from ecnf_jax.cnf.sampling import SolveConfig, sample_cnf, sample_and_log_prob_cnf
from ecnf_jax.parallel.mesh import get_mesh, data_sharded, replicated, pad_to_multiple
from ecnf_jax.training.checkpoints import get_latest_checkpoint, restore_serving_params
from ecnf_jax.training.config import load_config


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default=str(CONFIG_DIR / "lj13.yaml"))
    parser.add_argument("--checkpoint-dir", type=str, required=True)
    parser.add_argument("--n-nodes", type=int, required=True)
    parser.add_argument("--dim", type=int, default=3)
    def positive_int(text: str) -> int:
        v = int(text)
        if v < 1:
            raise argparse.ArgumentTypeError("must be >= 1")
        return v

    parser.add_argument("--n-samples", type=positive_int, default=1024)
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--output", type=str, default=None, help="write samples here")
    parser.add_argument("--log-prob-output", type=str, default=None)
    parser.add_argument("--with-log-prob", action="store_true",
                        help="also compute log q(x) along the forward solve")
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
    n_nodes, dim = args.n_nodes, args.dim

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
    x0 = jnp.zeros((2, n_nodes * dim))
    params = cnf.init(
        jax.random.PRNGKey(0), x0, jnp.zeros(2), jnp.tile(feats_row, (2, 1))
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
    B = pad_to_multiple(min(args.batch_size, args.n_samples), n_dev)
    if cfg.training.compile_cache:
        from ecnf_jax.utils.compile_cache import enable_persistent_compilation_cache

        enable_persistent_compilation_cache()

    solve_cfg = SolveConfig(
        use_fixed_step_size=cfg.training.use_fixed_step_size,
        method=cfg.training.ode_method,
        hutchinson_probes=cfg.training.hutchinson_probes,
    )
    fb = jnp.tile(feats_row, (B, 1))

    # Params default to a runtime argument (a closure capture embeds them
    # as XLA constants, which XLA then constant-folds at compile time).
    # --freeze-params opts into the constant form.
    def _solve(p, key):
        if args.with_log_prob:
            return sample_and_log_prob_cnf(
                cnf, p, key, B, features=fb, approx=args.approx, cfg=solve_cfg
            )
        return sample_cnf(cnf, p, key, B, features=fb, cfg=solve_cfg)

    out_shard = ((data_sharded(mesh), data_sharded(mesh))
                 if args.with_log_prob else data_sharded(mesh))
    t_start = time.perf_counter()
    if args.freeze_params:
        fn = jax.jit(
            lambda key: _solve(params, key),
            in_shardings=(replicated(mesh),),
            out_shardings=out_shard,
        )
        _compiled = fn.lower(jax.random.PRNGKey(0)).compile()
        compiled = lambda p, key: _compiled(key)
    else:
        fn = jax.jit(
            _solve,
            in_shardings=(replicated(mesh), replicated(mesh)),
            out_shardings=out_shard,
        )
        compiled = fn.lower(params, jax.random.PRNGKey(0)).compile()
        params = jax.device_put(params, replicated(mesh))
    startup_s = time.perf_counter() - t_start

    n = args.n_samples
    samples = np.empty((n, n_nodes * dim), np.float32)
    log_q = np.empty((n,), np.float32) if args.with_log_prob else None
    starts = list(range(0, n, B))
    # All keys from ONE eager split: a per-batch `jax.random.split` between
    # dispatches is an eager op that blocks the async dispatch pipeline.
    # Consumption is double-buffered for the same reason:
    # reading batch i's result only after batch i+1 is enqueued overlaps
    # the D2H copy + host writes with device compute.
    keys = jax.random.split(jax.random.PRNGKey(args.seed), len(starts))
    # The first compiled call carries per-device warmup and the initial
    # input transfer; fold it into the reported rate and throughput is
    # understated (ADVICE r3).  Time it separately; the steady-state rate
    # covers batches 2..end (matching the reference's
    # measure_sampling_time convention of excluding the first call).
    t0 = time.perf_counter()
    t_first = dt_steady = 0.0
    n_first = 0

    def consume(start, take, out):
        if args.with_log_prob:
            samples[start : start + take] = np.asarray(out[0])[:take]
            log_q[start : start + take] = np.asarray(out[1])[:take]
        else:
            samples[start : start + take] = np.asarray(out)[:take]

    from collections import deque

    pending = deque()
    for i, start in enumerate(starts):
        out = compiled(params, keys[i])  # async dispatch
        take = min(B, n - start)
        if i == 0:
            jax.block_until_ready(out)
            t_first = time.perf_counter() - t0
            n_first = take
        pending.append((start, take, out))
        if len(pending) > 1:
            consume(*pending.popleft())
    while pending:
        consume(*pending.popleft())
    dt_steady = time.perf_counter() - t0 - t_first

    # Diverged / budget-exhausted adaptive solves come back as NaN rows
    # (ops/ode.py NaN-freeze); surface them before anything consumes the
    # saved array.
    bad = ~np.isfinite(samples).all(axis=1)
    if log_q is not None:
        bad |= ~np.isfinite(log_q)
    n_bad = int(bad.sum())
    if n_bad:
        print(
            f"WARNING: {n_bad}/{n} samples are non-finite (diverged or "
            "budget-exhausted ODE solves); they are kept in the output as "
            "NaN rows."
        )

    extra = ""
    if log_q is not None:
        extra = (
            f", mean log q {log_q.mean():.4f} "
            f"({'Hutchinson' if args.approx else 'exact'} trace)"
        )
    if n > n_first and dt_steady > 0:
        rate = f", steady {(n - n_first) / dt_steady:.1f}/s"
    elif t_first > 0:  # single batch: only the warmup-inclusive rate exists
        rate = f", {n / t_first:.1f}/s (single batch, incl. warmup)"
    else:
        rate = ""
    print(
        f"sampled {n} configurations: trace+compile {startup_s:.1f}s, "
        f"first batch {t_first:.2f}s{rate}, {n_dev} device(s){extra}"
    )
    if args.output:
        np.save(args.output, samples.reshape(n, n_nodes, dim))
        print(f"wrote {args.output}")
    if log_q is not None and args.log_prob_output:
        np.save(args.log_prob_output, log_q)
        print(f"wrote {args.log_prob_output}")


if __name__ == "__main__":
    main()
