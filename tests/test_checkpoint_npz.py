"""The ``.npz`` checkpoint format: round trip, restore onto a smaller mesh,
partial restore, the missing-EMA error, and the main path with every
optional or replaced package blocked."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ecnf_jax.parallel.mesh import get_mesh, replicated
from ecnf_jax.training.checkpoints import (
    get_latest_checkpoint,
    restore_checkpoint,
    restore_serving_params,
    save_checkpoint,
)
from ecnf_jax.training.state import TrainingState

REPO = Path(__file__).resolve().parents[1]


def _state(ema=True):
    params = {"EGNN_0": {"kernel": jnp.arange(12.0).reshape(3, 4),
                         "final_scaling": jnp.asarray(1.5)}}
    return TrainingState(
        params=params,
        opt_state=({"count": jnp.asarray(3, jnp.int32)},),
        key=jax.random.PRNGKey(7),
        ema_params=jax.tree_util.tree_map(lambda x: x + 1, params) if ema else None,
    )


def _zeros_like(state):
    return jax.tree_util.tree_map(jnp.zeros_like, state)


def test_round_trip_exact(tmp_path):
    state = _state()
    path = save_checkpoint(str(tmp_path), 5, state)
    assert os.path.basename(path) == "state_00000005"
    assert get_latest_checkpoint(str(tmp_path)) == path
    restored = restore_checkpoint(path, _zeros_like(state))
    assert jax.tree_util.tree_structure(restored) == jax.tree_util.tree_structure(state)
    for a, b in zip(jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(state)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # No temporary file is left beside the checkpoint.
    assert sorted(os.listdir(tmp_path)) == ["state_00000005"]


def test_restore_onto_halved_mesh(tmp_path):
    mesh8 = get_mesh(jax.devices()[:8])
    mesh4 = get_mesh(jax.devices()[:4])
    state = jax.device_put(_state(), replicated(mesh8))
    path = save_checkpoint(str(tmp_path), 1, state)
    target = jax.device_put(_zeros_like(_state()), replicated(mesh4))
    restored = restore_checkpoint(path, target)
    for r, t, s in zip(jax.tree_util.tree_leaves(restored),
                       jax.tree_util.tree_leaves(target),
                       jax.tree_util.tree_leaves(state)):
        assert r.sharding == t.sharding
        assert len(r.sharding.device_set) == 4
        np.testing.assert_array_equal(np.asarray(r), np.asarray(s))


def test_partial_restore_params_only(tmp_path):
    state = _state()
    path = save_checkpoint(str(tmp_path), 2, state)
    params = restore_serving_params(path, _zeros_like(state.params))
    np.testing.assert_array_equal(params["EGNN_0"]["kernel"], state.params["EGNN_0"]["kernel"])
    ema = restore_serving_params(path, _zeros_like(state.params), ema=True)
    np.testing.assert_array_equal(ema["EGNN_0"]["kernel"], state.ema_params["EGNN_0"]["kernel"])
    # A subtree target without partial=True is a mismatch, not a silent drop.
    with pytest.raises(KeyError):
        restore_checkpoint(path, {"params": _zeros_like(state.params)})


def test_missing_ema_raises_clear_error(tmp_path):
    state = _state(ema=False)
    path = save_checkpoint(str(tmp_path), 3, state)
    with pytest.raises(ValueError, match="no EMA parameters"):
        restore_serving_params(path, _zeros_like(state.params), ema=True)


BLOCKED = ("flax", "yaml", "orbax", "matplotlib", "pandas", "h5py", "tqdm")

_CHILD = f"""
import sys
for name in {BLOCKED!r}:
    sys.modules[name] = None  # any import of these now raises ImportError

import jax, jax.numpy as jnp, numpy as np
from ecnf_jax.targets.data import FullGraphSample
from ecnf_jax.training.checkpoints import restore_checkpoint
from ecnf_jax.training.config import load_config
from ecnf_jax.training.loop import run_training
from ecnf_jax.training.setup import setup_training

cfg = load_config(sys.argv[1], overrides=[
    "flow.network.mlp_units=[16,16]", "flow.network.n_blocks_egnn=1",
    "training.batch_size=8", "training.n_training_iter=2",
    "training.n_eval=1", "training.n_checkpoints=1",
    "training.eval_plots=false", "training.use_fixed_step_size=true",
    "training.save_dir=" + sys.argv[2],
])
rng = np.random.default_rng(0)
pos = jnp.asarray(rng.normal(size=(16, 19, 3)).astype(np.float32))
data = FullGraphSample(positions=pos, features=jnp.zeros((16, 19), jnp.int32))
tc = setup_training(cfg, lambda a, b: (data, data[:8]))
logger, state = run_training(tc)
assert all(np.isfinite(logger.history["loss"])), logger.history["loss"]
ckpt = sys.argv[2] + "/model_checkpoints/state_00000001"
restored = restore_checkpoint(ckpt, jax.tree_util.tree_map(jnp.zeros_like, state))
for a, b in zip(jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(state)):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
leaked = sorted(n for n in {BLOCKED!r} if sys.modules.get(n) is not None)
assert not leaked, leaked
print("BLOCKED_IMPORTS_OK")
"""


def test_main_path_without_optional_packages(tmp_path):
    """qm9.yaml -> setup_training/run_training (an update, an eval, a
    checkpoint) -> restore, with flax, PyYAML, orbax and the optional
    packages blocked: the main path needs jax, numpy and optax only."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "ECNF_COMPILE_CACHE": "0",
           "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD,
         str(REPO / "examples/configs/qm9.yaml"), str(tmp_path / "run")],
        capture_output=True, text=True, timeout=600, env=env, cwd=str(REPO),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BLOCKED_IMPORTS_OK" in proc.stdout


def test_optional_package_error_names_the_package(monkeypatch):
    from ecnf_jax.utils.optional import require

    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(ImportError, match="'pandas'"):
        require("pandas", "the CSV logger")
