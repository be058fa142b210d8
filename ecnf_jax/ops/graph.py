"""Dense-graph edge utilities.

The reference materializes explicit fully-connected sender/receiver index
lists and scatter-sums over them (`ecnf/utils/graph.py:6-14`,
`ecnf/nets/egnn.py:92-104`).  For the node counts in this workload
(N in {4, 13, 19, 22}), a dense masked ``[N, N]`` edge formulation needs no
gathers or scatters: everything lowers to batched matmuls and masked
sums.  This module provides the dense mask plus (for parity/testing) the
explicit edge list.
"""
from functools import lru_cache
from typing import Tuple

import jax.numpy as jnp
import numpy as np


def get_senders_and_receivers_fully_connected(n_nodes: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Explicit fully-connected edge list, identical ordering to the reference.

    For receiver ``i`` the senders are ``(i + 1 + j) % n`` for
    ``j in range(n - 1)``.  Parity: reference `ecnf/utils/graph.py:6-14`.
    """
    idx = np.arange(n_nodes)
    offs = np.arange(1, n_nodes)
    receivers = np.repeat(idx, n_nodes - 1)
    senders = ((idx[:, None] + offs[None, :]) % n_nodes).reshape(-1)
    return jnp.asarray(senders, dtype=jnp.int32), jnp.asarray(receivers, dtype=jnp.int32)


@lru_cache(maxsize=None)
def _edge_mask_np(n_nodes: int) -> np.ndarray:
    return (1.0 - np.eye(n_nodes)).astype(np.float32)


def dense_edge_mask(n_nodes: int, dtype=jnp.float32) -> jnp.ndarray:
    """``[N, N]`` mask with 0 on the diagonal, 1 elsewhere.

    ``mask[i, j] == 1`` means there is an edge with receiver ``i`` and
    sender ``j`` — the dense equivalent of the reference's fully-connected
    edge list.
    """
    return jnp.asarray(_edge_mask_np(n_nodes), dtype=dtype)


def pairwise_difference(positions: jnp.ndarray) -> jnp.ndarray:
    """Dense pairwise difference vectors.

    ``out[..., i, j, :] = positions[..., i, :] - positions[..., j, :]``
    i.e. receiver minus sender, matching the reference's
    ``positions[receivers] - positions[senders]`` (`ecnf/nets/egnn.py:73`).

    Args:
        positions: ``[..., N, D]``.

    Returns:
        ``[..., N, N, D]``.
    """
    return positions[..., :, None, :] - positions[..., None, :, :]
