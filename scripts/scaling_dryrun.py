"""Data-parallel scaling mechanics check on a virtual CPU mesh.

Runs the sharded train step at 1/2/4/8 devices (weak scaling: fixed
per-device batch) and reports step times.  On the virtual CPU mesh all
"devices" share the same host cores, so the numbers validate *mechanics*
(sharding, collectives, global batch growth at fixed step cost shape), not
hardware scaling; on a real pod slice the same code paths carry the scaling
claim.
"""
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp

from ecnf_jax.cnf.build import build_cnf
from ecnf_jax.parallel.mesh import get_mesh, replicated, data_sharded
from ecnf_jax.training.optim import build_optimizer
from ecnf_jax.training.state import init_training_state, make_update_fn

PER_DEVICE_BATCH = 32
N, DIM = 13, 3


def main():
    cnf = build_cnf(
        n_frames=N, dim=DIM, sigma_min=0.01, base_scale=1.0,
        n_blocks_egnn=3, mlp_units=(64, 64), n_invariant_feat_hidden=32,
        time_embedding_dim=8, n_features=1,
    )
    optimizer = build_optimizer(1e-4, use_schedule=False)

    results = {}
    for n_dev in (1, 2, 4, 8):
        devices = jax.devices()[:n_dev]
        mesh = get_mesh(devices)
        B = PER_DEVICE_BATCH * n_dev
        x = jax.random.normal(jax.random.PRNGKey(0), (B, N * DIM))
        feats = jnp.zeros((B, N), dtype=jnp.int32)
        state = init_training_state(
            cnf, optimizer, jax.random.PRNGKey(1), x[:2], feats[:2]
        )
        update = make_update_fn(cnf, optimizer, mesh=mesh)
        state = jax.device_put(state, replicated(mesh))
        xs = jax.device_put(x, data_sharded(mesh))
        fs = jax.device_put(feats, data_sharded(mesh))

        state, info = update(state, xs, fs)  # compile
        jax.block_until_ready(info["loss"])
        ts = []
        for _ in range(10):
            t0 = time.perf_counter()
            state, info = update(state, xs, fs)
            jax.block_until_ready(info["loss"])
            ts.append(time.perf_counter() - t0)
        best = min(ts)
        results[n_dev] = best
        print(
            f"devices={n_dev}  global_batch={B:4d}  step={best*1e3:7.2f} ms  "
            f"samples/s={B/best:9.0f}  loss={float(info['loss']):.4f}"
        )

    t1 = results[1]
    for n_dev, t in results.items():
        # Weak-scaling efficiency: ideal keeps step time flat as batch grows.
        print(f"weak-scaling efficiency @{n_dev}: {t1 / t * 100:.0f}%"
              " (CPU mesh: mechanics only)" if n_dev > 1 else "")


if __name__ == "__main__":
    main()
