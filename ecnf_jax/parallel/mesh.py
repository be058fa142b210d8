"""Device mesh and sharding helpers.

The reference has no real parallelism (SURVEY §2b: one vestigial pmap hook).
Here data parallelism is first-class: a 1-D ``Mesh`` over all chips with a
``"data"`` axis; train/eval/sample steps are jit-compiled against
``NamedSharding`` annotations so gradient and metric reductions lower to XLA
all-reduces.  The same code runs on 1 device, a host of devices, or
several hosts (after `jax.distributed.initialize`).
"""
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def get_mesh(devices: Optional[Sequence[jax.Device]] = None, axis_name: str = DATA_AXIS) -> Mesh:
    """Build a 1-D data-parallel mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


TRACE_AXIS = "trace"


def get_mesh_2d(
    n_data: int,
    n_trace: Optional[int] = None,
    devices: Optional[Sequence[jax.Device]] = None,
    axis_names: "tuple[str, str]" = (DATA_AXIS, TRACE_AXIS),
) -> Mesh:
    """Build a 2-D ``(data, trace)`` mesh for batch x Jacobian-column sharding.

    Exact-trace eval has two independent parallel axes: the batch and the D
    tangent columns (SURVEY §5 — this workload's sequence-parallel
    analogue).  A ``(n_data, n_trace)`` mesh shards both at once; see
    `ecnf_jax.ops.divergence.sharded_value_and_exact_divergence`.
    """
    if devices is None:
        devices = jax.devices()
    if n_trace is None:
        n_trace = len(devices) // n_data
    assert n_data * n_trace == len(devices), (n_data, n_trace, len(devices))
    return Mesh(np.asarray(devices).reshape(n_data, n_trace), axis_names)


def replicated(mesh: Mesh) -> NamedSharding:
    """Sharding that replicates a value on every device of the mesh."""
    return NamedSharding(mesh, P())


def data_sharded(mesh: Mesh, axis_name: str = DATA_AXIS) -> NamedSharding:
    """Sharding that splits axis 0 (the batch) across the mesh."""
    return NamedSharding(mesh, P(axis_name))


def shard_batch(tree, mesh: Mesh, axis_name: str = DATA_AXIS):
    """Device-put a host batch with axis 0 split across the mesh."""
    sharding = data_sharded(mesh, axis_name)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sharding), tree)


def replicate(tree, mesh: Mesh):
    """Device-put a pytree replicated on every device of the mesh."""
    sharding = replicated(mesh)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sharding), tree)


def pad_to_multiple(batch_size: int, n_shards: int) -> int:
    """Smallest multiple of ``n_shards`` >= ``batch_size``."""
    return ((batch_size + n_shards - 1) // n_shards) * n_shards
