"""MLP / StableMLP with concat-free fused first layers.

Math parity with the reference's `ecnf/nets/mlp.py:7-72`, plus one
transform: every first layer that the reference feeds with
``concat([a, b, ...], -1)`` is computed here as a sum of split matmuls
(``a @ W_a + b @ W_b + ...``) via :class:`ConcatDense`.  This is
algebraically identical (and the single fused kernel parameter keeps the
exact same init distribution as a dense layer on the concatenation), but
avoids materializing ``[B, N, N, 2H+1]`` concatenated edge tensors in
device memory — each operand is matmul'd in its compact shape and only the
(cheap, fused-by-XLA) broadcast add produces the edge-shaped result.

Compute dtype: modules take an optional ``dtype`` (e.g. ``jnp.bfloat16``).
Parameters are always stored in float32; activations and matmuls run in
``dtype``.  With ``dtype=None`` operands are promoted (bf16 input and f32
kernel compute in f32).
"""
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ecnf_jax.models.module import (
    Module, Scope, layer_norm, lecun_normal, variance_scaling, zeros,
)


@dataclass(frozen=True)
class ConcatDense(Module):
    """``Dense(features)(concat(inputs, -1))`` as split matmuls.

    A single ``[sum(widths), features]`` kernel is created (so initialization
    matches a dense layer over the concatenation exactly) and sliced per
    input.  Inputs must be pre-shaped to broadcast against each other
    *after* their matmuls; broadcasting size-1 axes cost nothing.  With one
    input this is a plain dense layer.
    """

    features: int
    use_bias: bool = True
    kernel_init: Callable = lecun_normal
    dtype: Optional[jnp.dtype] = None  # compute dtype (e.g. bf16); params stay f32

    def __call__(self, scope: Scope, *inputs: jax.Array) -> jax.Array:
        widths = tuple(int(x.shape[-1]) for x in inputs)
        kernel = scope.param("kernel", self.kernel_init, (sum(widths), self.features))
        bias = scope.param("bias", zeros, (self.features,)) if self.use_bias else None
        if self.dtype is not None:
            kernel = kernel.astype(self.dtype)
            inputs = tuple(x.astype(self.dtype) for x in inputs)
            if bias is not None:
                bias = bias.astype(self.dtype)
        splits = np.cumsum(widths)[:-1].tolist()
        kparts = jnp.split(kernel, splits, axis=0) if splits else [kernel]
        out = None
        for x, k in zip(inputs, kparts):
            part = jnp.matmul(x, k)
            out = part if out is None else out + part
        if bias is not None:
            out = out + bias
        return out


@dataclass(frozen=True)
class MLP(Module):
    """Plain MLP; variadic inputs are fused into the first layer.

    Parity: reference `ecnf/nets/mlp.py:7-19` (Dense per feature,
    activation between layers, optional final activation).
    """

    features: Sequence[int]
    activation: Callable = jax.nn.silu
    activate_final: bool = False
    dtype: Optional[jnp.dtype] = None

    def __call__(self, scope: Scope, *inputs: jax.Array) -> jax.Array:
        feats = tuple(self.features)
        x = ConcatDense(feats[0], dtype=self.dtype)(scope.child("ConcatDense_0"), *inputs)
        if len(feats) > 1 or self.activate_final:
            x = self.activation(x)
        for i, f in enumerate(feats[1:]):
            is_last = i == len(feats) - 2
            x = ConcatDense(f, dtype=self.dtype)(scope.child(f"Dense_{i}"), x)
            if not is_last or self.activate_final:
                x = self.activation(x)
        return x


def _residual_layer_norm_layer(scope: Scope, x, width: int, activation):
    """LayerNorm -> Dense -> activation, with residual.

    Parity: reference `ecnf/nets/mlp.py:22-29`.
    """
    y = layer_norm(scope.child("LayerNorm_0"), x)
    return activation(ConcatDense(width)(scope.child("Dense_0"), y)) + x


@dataclass(frozen=True)
class StableMLP(Module):
    """MLP with layer norm + residual blocks; optional zero-init or
    variance-scaled output layer.

    Parity: reference `ecnf/nets/mlp.py:32-72` (constant-width assertion,
    stable-layer structure, output-layer init options).  The first dense
    layer is fused over variadic inputs like :class:`MLP`.
    """

    mlp_units: Sequence[int]
    activate_final: bool = False
    zero_init_output: bool = False
    output_variance_scaling: Optional[float] = None
    stable_layer: bool = True
    activation: Callable = jax.nn.silu
    dtype: Optional[jnp.dtype] = None

    def __call__(self, scope: Scope, *inputs: jax.Array) -> jax.Array:
        units = tuple(self.mlp_units)
        if not self.activate_final:
            assert len(units) > 1, "MLP is single linear layer with no non-linearity"
        activated_units = units if self.activate_final else units[:-1]
        for i in range(len(activated_units) - 1):
            assert activated_units[i] == activated_units[i + 1], "constant width required"
        if self.zero_init_output or self.output_variance_scaling:
            assert self.activate_final is False

        if self.stable_layer:
            x = self.activation(
                ConcatDense(activated_units[0], dtype=self.dtype)(
                    scope.child("ConcatDense_0"), *inputs
                )
            )
            for i, width in enumerate(activated_units[1:]):
                x = _residual_layer_norm_layer(
                    scope.child(f"NonLinearLayerWithResidualAndLayerNorm_{i}"),
                    x, width, self.activation,
                )
        else:
            x = MLP(
                activated_units,
                activate_final=True,
                activation=self.activation,
                dtype=self.dtype,
            )(scope.child("MLP_0"), *inputs)

        if not self.activate_final:
            if self.zero_init_output:
                kernel_init = zeros
            elif self.output_variance_scaling:
                kernel_init = variance_scaling(
                    self.output_variance_scaling, "fan_avg", "uniform"
                )
            else:
                kernel_init = lecun_normal
            x = ConcatDense(units[-1], kernel_init=kernel_init, dtype=self.dtype)(
                scope.child("Dense_0"), x
            )
        return x
