"""Sharding-aware checkpoints as ``.npz`` files (replacing the reference's
pickle).

The reference pickles the whole `TrainingState` to
``model_checkpoints/state_%08i.pkl`` and recovers the iteration by parsing
the filename (`ecnf/utils/loop.py:97-153`, `ecnf/utils/checkpoints.py:3-20`).
Here a checkpoint is one NumPy ``.npz`` archive named ``state_%08i`` whose
entries are the state's array leaves, keyed by their pytree path
(``params/EGNN_0/final_scaling``, ...; attribute and dict keys alike).
Restoring walks a *target* pytree and places each leaf on the target's
sharding, so a state saved on one mesh restores onto another, and a target
that is a subtree of the saved state (e.g. ``{"params": ...}``) restores
just that subtree.

The archive is written to a temporary file and renamed into place, so a
crash mid-save never leaves a truncated ``state_*`` behind.  In a
multi-process run only process 0 writes; leaves must be fully addressable
or replicated (the training state is replicated).
"""
import os
import re
import tempfile
from typing import Any, Optional

import jax
import numpy as np


def get_latest_checkpoint(dir_path: str, key: str = "state_") -> Optional[str]:
    """Path of the lexicographically-latest checkpoint containing ``key``.

    Parity: reference `ecnf/utils/checkpoints.py:3-20`.
    """
    if not os.path.exists(dir_path):
        return None
    entries = [
        os.path.join(dir_path, f) for f in os.listdir(dir_path) if key in f
    ]
    if not entries:
        return None
    entries.sort()
    return entries[-1]


def parse_checkpoint_iteration(path: str) -> int:
    """Recover the training iteration from a ``state_%08i`` name."""
    m = re.search(r"state_(\d{8})", os.path.basename(path.rstrip("/")))
    if m is None:
        raise ValueError(f"cannot parse iteration from checkpoint path {path!r}")
    return int(m.group(1))


def checkpoint_path(checkpoints_dir: str, iteration: int) -> str:
    return os.path.join(checkpoints_dir, "state_%08i" % iteration)


def _path_key(path) -> str:
    """``params/EGNN_0/kernel`` for NamedTuple fields and dict keys alike."""
    parts = []
    for entry in path:
        for attr in ("key", "name", "idx"):
            if hasattr(entry, attr):
                parts.append(str(getattr(entry, attr)))
                break
    return "/".join(parts)


def _host_array(x) -> np.ndarray:
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        if not x.is_fully_replicated:
            raise ValueError("cannot checkpoint an array sharded across processes")
        x = x.addressable_data(0)
    return np.asarray(x)


def save_checkpoint(checkpoints_dir: str, iteration: int, state: Any) -> str:
    """Save a (possibly sharded) pytree state; returns the checkpoint path."""
    path = os.path.abspath(checkpoint_path(checkpoints_dir, iteration))
    leaves = jax.tree_util.tree_leaves_with_path(state)
    arrays = {_path_key(p): _host_array(x) for p, x in leaves}
    if jax.process_index() != 0:
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), prefix=".partial-")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise
    return path


def restore_checkpoint(path: str, target: Any, partial: bool = False) -> Any:
    """Restore a checkpoint onto the structure (and shardings) of ``target``.

    ``target`` supplies the pytree structure, dtypes and the intended
    shardings (same or changed mesh), replacing the reference's pmap
    re-replication hack (`loop.py:104-106` — which silently dropped
    ema_params; restoring onto an explicit target avoids that bug class).

    ``partial=True`` allows ``target`` to be a subtree of the saved state
    (e.g. only ``{"params": ...}`` out of a full `TrainingState`
    checkpoint) — the serving path, which doesn't need optimizer state.
    Without it the saved state must have exactly the target's leaves.
    A missing leaf raises ``KeyError``.
    """
    with np.load(path) as archive:
        leaves, treedef = jax.tree_util.tree_flatten_with_path(target)
        keys = [_path_key(p) for p, _ in leaves]
        if not partial and set(keys) != set(archive.files):
            extra = sorted(set(archive.files) - set(keys))
            missing = sorted(set(keys) - set(archive.files))
            raise KeyError(
                f"checkpoint {path} does not match the target: "
                f"missing {missing[:5]}, unexpected {extra[:5]}"
            )
        restored = []
        for key, (_, t) in zip(keys, leaves):
            if key not in archive.files:
                raise KeyError(f"checkpoint {path} has no entry {key}")
            value = archive[key]
            if hasattr(t, "dtype"):
                value = value.astype(t.dtype)
            if isinstance(t, jax.Array):
                value = jax.device_put(value, t.sharding)
            restored.append(value)
    return jax.tree_util.tree_unflatten(treedef, restored)


def restore_serving_params(path: str, params_template: Any, ema: bool = False) -> Any:
    """Restore just the parameters (raw or EMA) for serving/scoring.

    ``ema=True`` restores ``ema_params`` — the weights the training loop
    evaluates with for ``use_ema`` configs (reference
    `setup_training.py:229-230`).  Raises ``ValueError`` with a clear
    message when the checkpoint was trained without EMA.
    """
    key_name = "ema_params" if ema else "params"
    try:
        return restore_checkpoint(path, {key_name: params_template}, partial=True)[
            key_name
        ]
    except KeyError as e:
        if ema:
            raise ValueError(
                "checkpoint has no EMA parameters (trained with use_ema=false)"
            ) from e
        raise
