"""Minimal parameter-module layer: pure ``init`` / ``apply`` over dict trees.

A module is a frozen dataclass whose ``__call__(scope, *inputs)`` runs the
forward pass.  The same code serves both phases: under `Module.init` the
`Scope` creates each parameter the first time it is asked for (from the
input shapes it sees), and under `Module.apply` it only reads them.  The
parameter tree is a nested ``dict`` of arrays keyed by explicit names
(``EGCL_0/MLP_1/Dense_0/kernel``, ...), wrapped as ``{"params": tree}``.

Parameter keys are derived from the root key by folding in each name on
the path, so a parameter's initial value depends only on its path and
the root key.
"""
import zlib
from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp

Params = Dict[str, Any]

lecun_normal = jax.nn.initializers.lecun_normal()
zeros = jax.nn.initializers.zeros
ones = jax.nn.initializers.ones
variance_scaling = jax.nn.initializers.variance_scaling


def _fold(key: jax.Array, name: str) -> jax.Array:
    return jax.random.fold_in(key, zlib.crc32(name.encode()) & 0x7FFFFFFF)


class Scope:
    """One node of the parameter tree: creates params on init, reads on apply."""

    def __init__(self, params: Params, key: Optional[jax.Array] = None):
        self.params = params
        self.key = key  # None = apply (read-only)

    @property
    def initializing(self) -> bool:
        return self.key is not None

    def child(self, name: str) -> "Scope":
        if self.key is None:
            return Scope(self.params[name])
        return Scope(self.params.setdefault(name, {}), _fold(self.key, name))

    def param(self, name: str, init_fn: Callable, shape, dtype=jnp.float32):
        if self.key is not None and name not in self.params:
            self.params[name] = init_fn(_fold(self.key, name), shape, dtype)
        return self.params[name]


class Module:
    """Base of the model dataclasses: ``init`` and ``apply`` entry points."""

    def init(self, key: jax.Array, *inputs) -> Params:
        params: Params = {}
        self(Scope(params, key), *inputs)
        return {"params": params}

    def apply(self, variables: Params, *inputs):
        return self(Scope(variables["params"]), *inputs)


def layer_norm(scope: Scope, x: jax.Array, epsilon: float = 1e-6) -> jax.Array:
    """Layer norm over the last axis; statistics in (at least) float32."""
    features = x.shape[-1]
    scale = scope.param("scale", ones, (features,))
    bias = scope.param("bias", zeros, (features,))
    x32 = x.astype(jnp.promote_types(x.dtype, jnp.float32))
    mean = jnp.mean(x32, axis=-1, keepdims=True)
    var = jnp.maximum(
        0.0, jnp.mean(x32 * x32, axis=-1, keepdims=True) - mean * mean
    )
    y = (x32 - mean) * (jax.lax.rsqrt(var + epsilon) * scale) + bias
    return y.astype(jnp.result_type(x, scale))


def embed(scope: Scope, ids: jax.Array, num_embeddings: int, features: int):
    """Lookup table ``[num_embeddings, features]`` indexed by integer ids."""
    table = scope.param(
        "embedding",
        variance_scaling(1.0, "fan_in", "normal", out_axis=0),
        (num_embeddings, features),
    )
    return jnp.take(table, ids, axis=0)
