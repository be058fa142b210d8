"""Time jitted QM9 sampling from a saved checkpoint.

Parity with the reference's
`examples/load_checkpoint_measure_sampling_time.py:101-119` (10 timed reps
of jitted sampling, compile time printed separately), loading from a local
checkpoint directory instead of a wandb artifact (wandb-optional
here: pass --wandb-run to fetch from wandb when the package is available).
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import argparse
import time

import jax
import jax.numpy as jnp

from ecnf_jax.cnf.build import build_cnf
from ecnf_jax.cnf.sampling import SolveConfig, sample_cnf
from ecnf_jax.training.checkpoints import get_latest_checkpoint, restore_checkpoint
from ecnf_jax.utils.compile_cache import enable_persistent_compilation_cache

enable_persistent_compilation_cache()


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint-dir", type=str, default="runs/qm9/model_checkpoints")
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument(
        "--wandb-project",
        type=str,
        default=None,
        help="fetch the newest qm9/flow_matching run's checkpoints from "
        "wandb (reference load_checkpoint_measure_sampling_time.py:22-70); "
        "requires the wandb package",
    )
    args = parser.parse_args()

    if args.wandb_project is not None:
        # Parity with the reference's wandb re-download helper: filter runs
        # by tags, download the run dir's model_checkpoints.
        import wandb

        api = wandb.Api()
        runs = [
            r
            for r in api.runs(args.wandb_project)
            if {"qm9", "flow_matching"} <= set(r.tags)
        ]
        assert runs, "no matching wandb runs (tags qm9 + flow_matching)"
        run = sorted(runs, key=lambda r: r.created_at)[-1]
        dest = f"wandb_ckpt_{run.id}"
        for f in run.files():
            if "model_checkpoints" in f.name:
                f.download(root=dest, exist_ok=True)
        args.checkpoint_dir = f"{dest}/model_checkpoints"
        print(f"downloaded checkpoints from wandb run {run.id} -> {args.checkpoint_dir}")

    n_nodes, dim = 19, 3
    cnf = build_cnf(
        n_frames=n_nodes,
        dim=dim,
        sigma_min=1e-6,
        base_scale=2.0,
        n_blocks_egnn=5,
        mlp_units=(256, 256, 256, 256),
        n_invariant_feat_hidden=32,
        time_embedding_dim=8,
        n_features=1,
    )
    feats = jnp.zeros((args.batch_size, n_nodes), dtype=jnp.int32)
    params = cnf.init(
        jax.random.PRNGKey(0),
        jnp.zeros((2, n_nodes * dim)),
        jnp.zeros(2),
        feats[:2],
    )

    latest = get_latest_checkpoint(args.checkpoint_dir)
    if latest is not None:
        print(f"restoring {latest}")
        state_like = {"params": params}
        params = restore_checkpoint(latest, state_like, partial=True)["params"]
    else:
        print("no checkpoint found; timing a randomly initialized model")

    cfg = SolveConfig()
    # Params as a runtime argument, not XLA constants.
    fn = jax.jit(
        lambda p, key: sample_cnf(cnf, p, key, args.batch_size, feats, cfg)
    )

    # Commit params to the accelerator BEFORE lowering: this jit has no
    # explicit shardings, so placement follows the (committed) args.
    params = jax.device_put(params, jax.devices()[0])
    t0 = time.perf_counter()
    compiled = fn.lower(params, jax.random.PRNGKey(1)).compile()
    t1 = time.perf_counter()
    jax.block_until_ready(compiled(params, jax.random.PRNGKey(1)))
    print(f"trace+compile: {t1 - t0:.2f}s, first run: "
          f"{time.perf_counter() - t1:.2f}s")

    # Keys precomputed: no eager PRNGKey op inside the timed region.
    keys = [jax.random.PRNGKey(2 + i) for i in range(args.reps)]
    times = []
    for i in range(args.reps):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(params, keys[i]))
        times.append(time.perf_counter() - t0)
    best = min(times)
    print(
        f"best of {args.reps}: {best*1e3:.1f} ms for {args.batch_size} samples "
        f"-> {args.batch_size / best:.1f} samples/s"
    )


if __name__ == "__main__":
    main()
