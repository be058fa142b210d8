"""Boltzmann target energies (batched, dense-pairwise).

Parity with the reference's `ecnf/targets/target_energy/double_well.py:9-28`
and `leonard_jones.py:10-36`, vectorized over the batch with dense masked
pairwise distances (the reference loops an explicit ordered edge list; the
dense sum over ordered pairs i != j is identical because its edge list
contains both directions of every pair).
"""
from typing import Union

import jax
import jax.numpy as jnp

from ecnf_jax.ops.graph import dense_edge_mask, pairwise_difference
from ecnf_jax.ops.numerics import safe_norm


def double_well_energy(
    x: jax.Array,
    a: float = 0.0,
    b: float = -4.0,
    c: float = 0.9,
    d0: float = 4.0,
    tau: float = 1.0,
) -> jax.Array:
    """Batched DW energy: sum over ordered pairs of
    ``a d + b d^2 + c d^4`` with ``d = |x_i - x_j| - d0``, halved.

    Parity: reference `double_well.py:9-19` (hyper-parameters from
    arXiv 2006.02425).

    Args:
        x: ``[..., N, D]``.

    Returns:
        ``[...]`` energies.
    """
    n_nodes = x.shape[-2]
    diff = pairwise_difference(x)  # [..., N, N, D]
    d = safe_norm(diff, axis=-1)  # diagonal reports 1 but is masked below
    mask = dense_edge_mask(n_nodes, dtype=x.dtype)
    dm = d - d0
    per_edge = a * dm + b * dm**2 + c * dm**4
    return jnp.sum(per_edge * mask, axis=(-1, -2)) / tau / 2.0


def double_well_log_prob(x: jax.Array, temperature: float = 1.0) -> jax.Array:
    """Unnormalized log-density (rank 2 or 3 input, reference
    `double_well.py:22-28`)."""
    assert x.ndim in (2, 3)
    return -double_well_energy(x, tau=temperature)


def lennard_jones_energy(
    x: jax.Array,
    epsilon: float = 1.0,
    tau: float = 1.0,
    r: Union[float, jax.Array] = 1.0,
    harmonic_potential_coef: float = 0.5,
) -> jax.Array:
    """Batched LJ 12-6 energy with harmonic centre-of-mass restraint.

    ``E = eps/(2 tau) * sum_{i != j} (r/d)^12 - 2 (r/d)^6
        + coef * sum_i |x_i - com|^2``

    Parity: reference `leonard_jones.py:10-27` (per-receiver radii
    ``r[receivers]``; oscillator from Kohler et al.).

    Args:
        x: ``[..., N, D]``.
    """
    n_nodes = x.shape[-2]
    if isinstance(r, float) or (hasattr(r, "ndim") and r.ndim == 0):
        r = jnp.ones(n_nodes, dtype=x.dtype) * r
    diff = pairwise_difference(x)  # receiver i minus sender j
    d = safe_norm(diff, axis=-1)  # [..., N, N]; diagonal -> 1 (masked)
    mask = dense_edge_mask(n_nodes, dtype=x.dtype)
    rr = r[:, None]  # receiver radius along axis i
    term = (rr / d) ** 12 - 2.0 * (rr / d) ** 6
    energy = epsilon / (2.0 * tau) * jnp.sum(term * mask, axis=(-1, -2))

    com = jnp.mean(x, axis=-2, keepdims=True)
    harmonic = harmonic_potential_coef * jnp.sum((x - com) ** 2, axis=(-1, -2))
    return energy + harmonic


def lennard_jones_log_prob(x: jax.Array) -> jax.Array:
    """Unnormalized log-density (rank 2 or 3, reference `leonard_jones.py:30-36`)."""
    assert x.ndim in (2, 3)
    return -lennard_jones_energy(x)
