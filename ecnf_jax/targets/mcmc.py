"""Batched HMC sampler for regenerating Boltzmann datasets.

The reference ships DW4/LJ13 datasets as opaque ``.npy`` blobs originating
from https://github.com/vgsatorras/en_flows (`ecnf/targets/data.py:37-38,
61-62`); those blobs are not distributable here, so the framework can
regenerate statistically equivalent datasets by sampling the *same* target
energies (`ecnf_jax/targets/energies.py`) with Hamiltonian Monte Carlo.

Batched design: all chains advance together as one ``[C, N, D]`` batch
(leapfrog = a `lax.scan`, the outer steps another `lax.scan`), so the whole
sampler is a single jit-compiled program.  Deterministic given the seed.
"""
from functools import partial
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _leapfrog(grad_fn, x, p, step_size, n_steps):
    """Vectorized leapfrog integrator over all chains."""

    def body(carry, _):
        x, p = carry
        p = p + 0.5 * step_size * grad_fn(x)
        x = x + step_size * p
        p = p + 0.5 * step_size * grad_fn(x)
        return (x, p), None

    (x, p), _ = jax.lax.scan(body, (x, p), None, length=n_steps)
    return x, p


def icosahedron_with_center(n_chains: int, key: jax.Array, noise: float = 0.05) -> jax.Array:
    """Noisy 13-particle icosahedral configurations (LJ13 ground-state
    geometry: 12 vertices at unit circumradius + central atom) — a
    low-energy HMC initialization for the steep LJ potential."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    base = []
    for s1 in (1.0, -1.0):
        for s2 in (1.0, -1.0):
            base.append([0.0, s1 * 1.0, s2 * phi])
            base.append([s1 * 1.0, s2 * phi, 0.0])
            base.append([s2 * phi, 0.0, s1 * 1.0])
    verts = np.unique(np.round(np.array(base), 8), axis=0)
    assert verts.shape == (12, 3), verts.shape
    verts = verts / np.linalg.norm(verts[0])  # unit circumradius
    x0 = np.concatenate([np.zeros((1, 3)), verts], axis=0)  # [13, 3]
    x0 = jnp.asarray(x0)[None].repeat(n_chains, axis=0)
    return x0 + noise * jax.random.normal(key, x0.shape)


@partial(
    jax.jit,
    static_argnames=(
        "log_prob_fn",
        "n_samples_per_chain",
        "n_chains",
        "n_nodes",
        "dim",
        "n_leapfrog",
        "burn_in",
        "thin",
    ),
)
def run_hmc(
    log_prob_fn: Callable[[jax.Array], jax.Array],
    key: jax.Array,
    n_samples_per_chain: int,
    n_chains: int,
    n_nodes: int,
    dim: int,
    step_size: float = 0.05,
    n_leapfrog: int = 10,
    burn_in: int = 500,
    thin: int = 5,
    init_scale: float = 1.0,
    init_positions: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Sample ``[n_chains * n_samples_per_chain, N, D]`` from exp(log_prob).

    ``init_positions`` (``[n_chains, N, D]``) overrides the random Gaussian
    initialization — essential for steep potentials (LJ) where random
    overlapping particles make every proposal diverge.

    Returns ``(samples, acceptance_rate)``.
    """
    grad_fn = jax.grad(lambda xs: jnp.sum(log_prob_fn(xs)))

    def hmc_step(carry, step_key):
        x, lp = carry
        k_mom, k_acc = jax.random.split(step_key)
        p = jax.random.normal(k_mom, x.shape)
        ke0 = 0.5 * jnp.sum(p**2, axis=(-1, -2))
        x_new, p_new = _leapfrog(grad_fn, x, p, step_size, n_leapfrog)
        lp_new = log_prob_fn(x_new)
        ke1 = 0.5 * jnp.sum(p_new**2, axis=(-1, -2))
        log_accept = (lp_new - ke1) - (lp - ke0)
        u = jnp.log(jax.random.uniform(k_acc, (x.shape[0],)))
        accept = (u < log_accept) & jnp.isfinite(lp_new)
        x = jnp.where(accept[:, None, None], x_new, x)
        lp = jnp.where(accept, lp_new, lp)
        return (x, lp), (x, accept)

    key_init, key_run = jax.random.split(key)
    if init_positions is not None:
        x0 = init_positions
    else:
        x0 = init_scale * jax.random.normal(key_init, (n_chains, n_nodes, dim))
    lp0 = log_prob_fn(x0)

    n_total = burn_in + n_samples_per_chain * thin
    keys = jax.random.split(key_run, n_total)
    (_, _), (xs, accepts) = jax.lax.scan(hmc_step, (x0, lp0), keys)

    kept = xs[burn_in::thin][: n_samples_per_chain]  # [S, C, N, D]
    samples = jnp.reshape(
        jnp.swapaxes(kept, 0, 1), (n_chains * n_samples_per_chain, n_nodes, dim)
    )
    return samples, jnp.mean(accepts.astype(jnp.float32))
