"""Plain MLP vector field for non-graph (e.g. 2-D MoG) targets.

Parity with the reference's `examples/MoG_target.py:65-83` ``VectorNet``:
each hidden layer sees ``concat([x, t_embed])`` (fused here), GELU
activations, linear output back to the event dim.
"""
from dataclasses import dataclass
from typing import Optional, Sequence

import jax

from ecnf_jax.ops.numerics import timestep_embedding
from ecnf_jax.models.mlp import ConcatDense
from ecnf_jax.models.module import Module, Scope


@dataclass(frozen=True)
class VectorNet(Module):
    features: Sequence[int] = (512, 512, 512)
    embedding_dim: int = 32

    def __call__(
        self,
        scope: Scope,
        x: jax.Array,
        t: jax.Array,
        features: Optional[jax.Array] = None,
    ) -> jax.Array:
        assert x.ndim == 2 and t.ndim == 1
        event_dim = x.shape[-1]
        t_embed = timestep_embedding(t, self.embedding_dim)
        for i, feat in enumerate(self.features):
            x = jax.nn.gelu(
                ConcatDense(feat)(scope.child(f"ConcatDense_{i}"), x, t_embed)
            )
        return ConcatDense(event_dim)(scope.child("Dense_0"), x)
