"""Multi-chip checkpoint save -> restore -> continue (VERDICT r2 item 4).

The reference's checkpointing is a host pickle with a broken pmap
re-replication hook on resume (`ecnf/utils/loop.py:97-108,144-153` — the
re-replication drops ema_params).  Here checkpoints are sharding-aware
``.npz`` files; these tests prove, on the 8-device CPU mesh, the claims a
data-parallel framework must actually hold:

1. save sharded state -> restore onto the SAME mesh -> one more training
   step is bit-identical to an uncheckpointed run;
2. restore onto a CHANGED topology (8 -> 4 devices) -> the continued step
   matches numerically;
3. restore in a FRESH PROCESS -> the continued step matches;
4. no sharding warnings on restore (the restore carries the target's
   explicit shardings).
"""
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ecnf_jax.cnf.build import build_cnf
from ecnf_jax.parallel.mesh import data_sharded, get_mesh, replicated
from ecnf_jax.training.checkpoints import restore_checkpoint, save_checkpoint
from ecnf_jax.training.optim import build_optimizer
from ecnf_jax.training.state import init_training_state, make_update_fn

REPO = Path(__file__).resolve().parent.parent

N_NODES, DIM = 4, 2  # DW4 scale — fast on the CPU mesh


def _build():
    cnf = build_cnf(
        n_frames=N_NODES, dim=DIM, sigma_min=0.01, base_scale=1.0,
        n_blocks_egnn=2, mlp_units=(16,), n_invariant_feat_hidden=8,
        time_embedding_dim=8, n_features=1,
    )
    opt = build_optimizer(1e-3, use_schedule=False)
    return cnf, opt


def _sharded_state_and_batches(cnf, opt, mesh, use_ema=True):
    batch = 16
    x = jax.random.normal(jax.random.PRNGKey(0), (batch, N_NODES * DIM))
    feats = jnp.zeros((batch, N_NODES), dtype=jnp.int32)
    state = init_training_state(
        cnf, opt, jax.random.PRNGKey(1), x[:2], feats[:2], use_ema=use_ema
    )
    state = jax.device_put(state, replicated(mesh))
    xs = jax.device_put(x, data_sharded(mesh))
    fs = jax.device_put(feats, data_sharded(mesh))
    return state, xs, fs


class TestMultichipCheckpoint:
    def test_same_mesh_resume_bit_identical(self, tmp_path):
        cnf, opt = _build()
        mesh = get_mesh()
        state, xs, fs = _sharded_state_and_batches(cnf, opt, mesh)
        update = make_update_fn(cnf, opt, use_ema=True, mesh=mesh)

        state, _ = update(state, xs, fs)  # step A
        path = save_checkpoint(str(tmp_path), 1, state)

        golden_state, golden_info = update(state, xs, fs)  # step B, no ckpt

        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            restored = restore_checkpoint(path, state)
            sharding_warns = [
                str(ww.message) for ww in w
                if "sharding" in str(ww.message).lower()
            ]
        assert not sharding_warns, sharding_warns

        resumed_state, resumed_info = update(restored, xs, fs)  # step B'
        assert float(resumed_info["loss"]) == float(golden_info["loss"])
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
            golden_state.params, resumed_state.params,
        )
        # EMA must survive the round-trip (the reference's resume hook
        # silently dropped it, `loop.py:104-106`).
        assert resumed_state.ema_params is not None
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
            golden_state.ema_params, resumed_state.ema_params,
        )

    def test_changed_topology_8_to_4(self, tmp_path):
        cnf, opt = _build()
        mesh8 = get_mesh()
        state, xs, fs = _sharded_state_and_batches(cnf, opt, mesh8)
        update8 = make_update_fn(cnf, opt, use_ema=True, mesh=mesh8)
        state, _ = update8(state, xs, fs)
        path = save_checkpoint(str(tmp_path), 1, state)
        golden_state, golden_info = update8(state, xs, fs)

        mesh4 = get_mesh(jax.devices()[:4])
        # Fresh target laid out on the NEW mesh; restore must land there.
        # (built from golden_state's structure — `state` was donated away
        # by the update step.)
        target = jax.device_put(
            jax.tree_util.tree_map(jnp.zeros_like, jax.device_get(golden_state)),
            replicated(mesh4),
        )
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            restored = restore_checkpoint(path, target)
            sharding_warns = [
                str(ww.message) for ww in w
                if "sharding" in str(ww.message).lower()
            ]
        assert not sharding_warns, sharding_warns
        leaf = jax.tree_util.tree_leaves(restored.params)[0]
        assert leaf.sharding.mesh.devices.size == 4

        update4 = make_update_fn(cnf, opt, use_ema=True, mesh=mesh4)
        xs4 = jax.device_put(jax.device_get(xs), data_sharded(mesh4))
        fs4 = jax.device_put(jax.device_get(fs), data_sharded(mesh4))
        resumed_state, resumed_info = update4(restored, xs4, fs4)
        # Different mesh -> different reduction grouping; numeric, not
        # bitwise, equality is the correctness claim.
        np.testing.assert_allclose(
            float(resumed_info["loss"]), float(golden_info["loss"]),
            rtol=1e-5,
        )
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-7
            ),
            golden_state.params, resumed_state.params,
        )

    def test_fresh_process_resume(self, tmp_path):
        """Restore in a separate process (new runtime, new mesh objects) and
        check the continued step reproduces this process's loss."""
        cnf, opt = _build()
        mesh = get_mesh()
        state, xs, fs = _sharded_state_and_batches(cnf, opt, mesh)
        update = make_update_fn(cnf, opt, use_ema=True, mesh=mesh)
        state, _ = update(state, xs, fs)
        path = save_checkpoint(str(tmp_path), 1, state)
        _, golden_info = update(state, xs, fs)
        golden_loss = float(golden_info["loss"])

        child = subprocess.run(
            [sys.executable, __file__, "--child", path],
            capture_output=True, text=True, timeout=600,
            env={**os.environ,
                 "JAX_PLATFORMS": "cpu",
                 "ECNF_COMPILE_CACHE": "0",
                 "PYTHONPATH": str(REPO),
                 "XLA_FLAGS": "--xla_force_host_platform_device_count=8"},
            cwd=str(REPO),
        )
        assert child.returncode == 0, child.stderr[-2000:]
        out = json.loads(child.stdout.strip().splitlines()[-1])
        np.testing.assert_allclose(out["loss"], golden_loss, rtol=1e-6)
        assert out["n_devices"] == 8
        assert not out["sharding_warnings"], out["sharding_warnings"]


def _child_main(path: str) -> None:
    """Fresh-process resume: restore the checkpoint onto this process's own
    mesh and run the same continuation step as the parent."""
    jax.config.update("jax_platforms", "cpu")
    cnf, opt = _build()
    mesh = get_mesh()
    state, xs, fs = _sharded_state_and_batches(cnf, opt, mesh)
    update = make_update_fn(cnf, opt, use_ema=True, mesh=mesh)
    state, _ = update(state, xs, fs)  # compile + reach the same RNG point? no:
    # the restore overwrites the whole state (incl. its RNG key), so the
    # warm-up step only serves to match the parent's compiled program.
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        restored = restore_checkpoint(path, state)
        sharding_warns = [
            str(ww.message) for ww in w if "sharding" in str(ww.message).lower()
        ]
    _, info = update(restored, xs, fs)
    print(json.dumps({
        "loss": float(info["loss"]),
        "n_devices": jax.device_count(),
        "sharding_warnings": sharding_warns,
    }))


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        _child_main(sys.argv[2])
    else:
        sys.exit(pytest.main([__file__, "-q"]))
