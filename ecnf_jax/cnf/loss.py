"""Conditional flow-matching loss (batched).

Parity with the reference's `ecnf/cnf/loss.py:10-32`: sample ``x0`` from the
base, ``t ~ U[0, 1]`` per sample, build the OT conditional path, regress the
network output onto the conditional vector field with an MSE.
"""
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ecnf_jax.cnf.core import FlowMatchingCNF


def flow_matching_loss_fn(
    cnf: FlowMatchingCNF,
    params,
    x_data: jax.Array,
    key: jax.Array,
    features: Optional[jax.Array] = None,
) -> Tuple[jax.Array, dict]:
    """MSE flow-matching loss on a ``[B, D]`` batch of flat coordinates."""
    assert x_data.ndim == 2
    key1, key2 = jax.random.split(key)
    batch_size = x_data.shape[0]
    x0 = cnf.sample_base(key1, (batch_size,))
    t = jax.random.uniform(key2, shape=(batch_size,))
    x_t, u_t_conditional = cnf.get_x_t_and_conditional_u_t(x0, x_data, t)
    v_t = cnf.apply(params, x_t, t, features)
    loss = jnp.mean((v_t - u_t_conditional) ** 2)
    return loss, {"loss": loss}
