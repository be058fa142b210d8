"""Numerical utilities (batched-first).

Behavioral parity with the reference's `ecnf/utils/numerical.py` and
`ecnf/cnf/build_cnf.py:18-32` (timestep embedding), re-written
batched-first.
"""
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


def safe_norm(x: jax.Array, axis: Optional[int] = None, keepdims: bool = False) -> jax.Array:
    """NaN-safe (at zero) L2 norm.

    Where ``sum(x**2) == 0`` the norm is reported as 1 so that downstream
    divisions / gradients stay finite (the gradient of ``sqrt`` at 0 is inf;
    this `where` trick keeps autodiff well-defined).  Parity:
    reference `ecnf/utils/numerical.py:7-10`.
    """
    x2 = jnp.sum(x**2, axis=axis, keepdims=keepdims)
    return jnp.where(x2 == 0, 1, x2) ** 0.5


def vector_rejection(a: jax.Array, b: jax.Array) -> jax.Array:
    """Component of ``a`` orthogonal to ``b`` (reference `numerical.py:12-16`)."""
    vector_proj = b * jnp.sum(a * b, axis=-1, keepdims=True) / jnp.sum(
        b * b, axis=-1, keepdims=True
    )
    return a - vector_proj


def rotate_3d(x: jax.Array, theta: jax.Array, phi: jax.Array) -> jax.Array:
    """Rotate a 3-vector about z by theta then about x by phi.

    Parity: reference `ecnf/utils/numerical.py:18-33`.
    """
    rot1 = jnp.array(
        [
            [jnp.cos(theta), -jnp.sin(theta), 0.0],
            [jnp.sin(theta), jnp.cos(theta), 0.0],
            [0.0, 0.0, 1.0],
        ]
    )
    rot2 = jnp.array(
        [
            [1.0, 0.0, 0.0],
            [0.0, jnp.cos(phi), -jnp.sin(phi)],
            [0.0, jnp.sin(phi), jnp.cos(phi)],
        ]
    )
    return rot2 @ (rot1 @ x)


def maybe_masked_mean(array: jax.Array, mask: Optional[jax.Array]) -> jax.Array:
    """Mean of a rank-1 array, optionally restricted by a 0/1 mask.

    Division-by-zero safe when the mask is empty.  Parity: reference
    `ecnf/utils/numerical.py:43-52`.
    """
    if mask is None:
        return jnp.mean(array)
    array = jnp.where(mask, array, jnp.zeros_like(array))
    divisor = jnp.sum(mask)
    multiplier = jnp.where(divisor == 0, jnp.array(0.0), 1.0 / divisor)
    return jnp.sum(array) * multiplier


def get_leading_axis_tree(tree, n_dims: int = 1):
    """Leading shape of the first leaf of a pytree (reference `numerical.py:35-39`).

    Python scalars are treated as rank-0 leaves.
    """
    flat_tree = jax.tree_util.tree_leaves(tree)
    return np.shape(flat_tree[0])[:n_dims]


def timestep_embedding(timesteps: jax.Array, embedding_dim: int) -> jax.Array:
    """Sinusoidal (Fairseq-style) timestep embedding.

    ``t`` in [0, 1] is scaled by 1000; half the dim is sin, half cos with
    log-spaced frequencies.  Parity: reference `ecnf/cnf/build_cnf.py:18-32`.

    Args:
        timesteps: ``[B]`` float array of times.
        embedding_dim: total embedding size (must be even).

    Returns:
        ``[B, embedding_dim]`` embedding.
    """
    assert timesteps.ndim == 1
    t = timesteps * 1000.0
    half_dim = embedding_dim // 2
    emb_scale = np.log(10_000) / (half_dim - 1)
    freqs = jnp.exp(jnp.arange(half_dim) * -emb_scale)
    args = t[:, None] * freqs[None, :]
    emb = jnp.concatenate([jnp.sin(args), jnp.cos(args)], axis=1)
    assert emb.shape == (timesteps.shape[0], embedding_dim)
    return emb
