"""Real multi-process (multi-"host") smoke test on CPU.

Launches itself as 2 JAX processes connected through
`jax.distributed.initialize` (localhost coordinator), each exposing 4
virtual CPU devices -> an 8-device global mesh across 2 processes.  Runs
the sharded train step with per-process data loading
(`jax.make_array_from_process_local_data`) and checks both processes agree
on the loss — the actual multi-host code path the reference never had
(SURVEY §2c).
"""
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
COORD = "127.0.0.1:9911"
N_PROC = 2
LOCAL_DEVICES = 4


def worker(process_id: int) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    # Through the production helper (VERDICT r3 item 4): the one entry
    # point a real launcher would use must be the one this smoke covers.
    from ecnf_jax.parallel.distributed import maybe_initialize_distributed

    did_init = maybe_initialize_distributed(
        coordinator_address=COORD,
        num_processes=N_PROC,
        process_id=process_id,
        local_device_ids=list(range(LOCAL_DEVICES)),
    )
    assert did_init, "helper skipped initialize in a fresh worker process"
    import jax.numpy as jnp

    from ecnf_jax.cnf.build import build_cnf
    from ecnf_jax.parallel.mesh import get_mesh, replicated, data_sharded
    from ecnf_jax.parallel.distributed import process_batch_slice
    from ecnf_jax.training.optim import build_optimizer
    from ecnf_jax.training.state import init_training_state, make_update_fn

    assert jax.process_count() == N_PROC
    assert len(jax.devices()) == N_PROC * LOCAL_DEVICES

    N, DIM = 4, 2
    GLOBAL_BATCH = 32
    cnf = build_cnf(
        n_frames=N, dim=DIM, sigma_min=0.01, base_scale=1.0,
        n_blocks_egnn=1, mlp_units=(8,), n_invariant_feat_hidden=4,
        time_embedding_dim=4, n_features=1,
    )
    opt = build_optimizer(1e-4, use_schedule=False)

    # Per-process ("per-host") data loading: each process materializes only
    # its slice of the global batch; the global array is assembled from the
    # local shards.
    import numpy as np

    rng = np.random.RandomState(0)  # same global dataset on each process
    full_x = rng.randn(GLOBAL_BATCH, N * DIM).astype(np.float32)
    full_f = np.zeros((GLOBAL_BATCH, N), dtype=np.int32)
    sl = process_batch_slice(GLOBAL_BATCH)

    mesh = get_mesh()
    x = jax.make_array_from_process_local_data(data_sharded(mesh), full_x[sl])
    feats = jax.make_array_from_process_local_data(data_sharded(mesh), full_f[sl])

    state = init_training_state(
        cnf, opt, jax.random.PRNGKey(1), jnp.zeros((2, N * DIM)), jnp.zeros((2, N), jnp.int32)
    )
    state = jax.device_put(state, replicated(mesh))
    update = make_update_fn(cnf, opt, mesh=mesh)

    for _ in range(3):
        state, info = update(state, x, feats)
    loss = float(info["loss"])
    print(f"[process {process_id}] devices={len(jax.devices())} "
          f"local={len(jax.local_devices())} loss={loss:.6f}", flush=True)
    assert np.isfinite(loss)


def main() -> None:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "") + f" --xla_force_host_platform_device_count={LOCAL_DEVICES}"
    ).strip()
    env["PYTHONPATH"] = f"{REPO}:{env.get('PYTHONPATH', '')}"

    procs = [
        subprocess.Popen(
            [sys.executable, __file__, "--worker", str(i)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for i in range(N_PROC)
    ]
    outs = [p.communicate(timeout=420)[0].decode() for p in procs]
    for i, (p, out) in enumerate(zip(procs, outs)):
        print(f"--- process {i} (rc={p.returncode}) ---")
        print("\n".join(out.splitlines()[-3:]))
    assert all(p.returncode == 0 for p in procs), "a worker failed"
    losses = [l for o in outs for l in o.splitlines() if "loss=" in l]
    vals = {l.split("loss=")[1] for l in losses}
    assert len(vals) == 1, f"processes disagree on the loss: {losses}"
    print(f"multihost smoke OK: {N_PROC} processes agree, loss={vals.pop()}")


if __name__ == "__main__":
    if "--worker" in sys.argv:
        worker(int(sys.argv[sys.argv.index("--worker") + 1]))
    else:
        main()
