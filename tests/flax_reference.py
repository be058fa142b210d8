"""Flax reference for the model layer's parity tests.

These are the flax (linen) modules that `ecnf_jax/models/` reproduces
without flax: same parameter tree paths, initializers and forward math.
`tests/test_module_parity.py` compares the two; it needs flax installed.
"""
from typing import Callable, Optional, Sequence, Tuple
import jax
import jax.numpy as jnp
import numpy as np
from flax import linen as nn
from ecnf_jax.ops.graph import dense_edge_mask
from ecnf_jax.ops.numerics import timestep_embedding

class ConcatDense(nn.Module):
    features: int
    use_bias: bool = True
    kernel_init: Callable = nn.linear.default_kernel_init
    param_dtype: jnp.dtype = jnp.float32
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, *inputs: jax.Array) -> jax.Array:
        widths = tuple((int(x.shape[-1]) for x in inputs))
        total = int(sum(widths))
        kernel = self.param('kernel', self.kernel_init, (total, self.features), self.param_dtype)
        bias = self.param('bias', nn.initializers.zeros_init(), (self.features,), self.param_dtype) if self.use_bias else None
        if self.dtype is not None:
            kernel = kernel.astype(self.dtype)
            inputs = tuple((x.astype(self.dtype) for x in inputs))
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

class MLP(nn.Module):
    features: Sequence[int]
    activation: Callable = jax.nn.silu
    activate_final: bool = False
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, *inputs: jax.Array) -> jax.Array:
        feats = tuple(self.features)
        x = ConcatDense(feats[0], dtype=self.dtype)(*inputs)
        if len(feats) > 1 or self.activate_final:
            x = self.activation(x)
        for i, f in enumerate(feats[1:]):
            is_last = i == len(feats) - 2
            x = nn.Dense(f, dtype=self.dtype)(x)
            if not is_last or self.activate_final:
                x = self.activation(x)
        return x

class NonLinearLayerWithResidualAndLayerNorm(nn.Module):
    output_size: int
    activation_fn: Callable = jax.nn.silu

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        out = self.activation_fn(nn.Dense(self.output_size)(nn.LayerNorm()(x)))
        return out + x

class StableMLP(nn.Module):
    mlp_units: Sequence[int]
    activate_final: bool = False
    zero_init_output: bool = False
    output_variance_scaling: Optional[float] = None
    stable_layer: bool = True
    activation: Callable = jax.nn.silu
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, *inputs: jax.Array) -> jax.Array:
        units = tuple(self.mlp_units)
        if not self.activate_final:
            assert len(units) > 1, 'MLP is single linear layer with no non-linearity'
        activated_units = units if self.activate_final else units[:-1]
        for i in range(len(activated_units) - 1):
            assert activated_units[i] == activated_units[i + 1], 'constant width required'
        if self.zero_init_output or self.output_variance_scaling:
            assert self.activate_final is False
        if self.stable_layer:
            x = self.activation(ConcatDense(activated_units[0], dtype=self.dtype)(*inputs))
            for width in activated_units[1:]:
                x = NonLinearLayerWithResidualAndLayerNorm(width, activation_fn=self.activation)(x)
        else:
            x = MLP(activated_units, activate_final=True, activation=self.activation, dtype=self.dtype)(*inputs)
        if not self.activate_final:
            if self.zero_init_output:
                kernel_init = nn.initializers.zeros_init()
            elif self.output_variance_scaling:
                kernel_init = nn.initializers.variance_scaling(self.output_variance_scaling, 'fan_avg', 'uniform')
            else:
                kernel_init = nn.linear.default_kernel_init
            x = nn.Dense(units[-1], kernel_init=kernel_init, dtype=self.dtype)(x)
        return x

class EGCL(nn.Module):
    mlp_units: Sequence[int]
    n_invariant_feat_hidden: int
    activation_fn: Callable = jax.nn.silu
    residual_h: bool = True
    residual_x: bool = True
    stable_mlp: bool = False
    normalization_constant: float = 1.0
    variance_scaling_init: float = 0.001
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, vectors: jax.Array, h: jax.Array) -> Tuple[jax.Array, jax.Array]:
        assert vectors.ndim == 3 and h.ndim == 3
        B, N, D = vectors.shape
        avg_num_neighbours = N - 1
        mlp_cls = StableMLP if self.stable_mlp else MLP
        gram = jnp.einsum('bnd,bmd->bnm', vectors, vectors)
        r2 = jnp.diagonal(gram, axis1=-2, axis2=-1)
        l2 = jnp.maximum(r2[:, :, None] + r2[:, None, :] - 2.0 * gram, 0.0)
        lengths = jnp.where(l2 == 0, 1.0, l2) ** 0.5
        mask = dense_edge_mask(N, dtype=vectors.dtype)
        m_ij = mlp_cls(self.mlp_units, activation=self.activation_fn, activate_final=True, dtype=self.dtype)(h[:, None, :, :], h[:, :, None, :], l2[..., None])
        phi_x_out = mlp_cls(self.mlp_units, activation=self.activation_fn, activate_final=True, dtype=self.dtype)(m_ij)
        phi_x_out = nn.Dense(1, kernel_init=nn.initializers.variance_scaling(self.variance_scaling_init, 'fan_avg', 'uniform'), dtype=self.dtype)(phi_x_out)
        w = phi_x_out[..., 0].astype(vectors.dtype) * mask / (self.normalization_constant + lengths)
        shifts_i = jnp.sum(w, axis=2)[:, :, None] * vectors - jnp.einsum('bij,bjd->bid', w, vectors)
        vectors_out = shifts_i / avg_num_neighbours
        gate = jax.nn.sigmoid(nn.Dense(1, dtype=self.dtype)(m_ij))
        m_i = jnp.sum((m_ij * gate).astype(vectors.dtype) * mask[None, :, :, None], axis=2) / jnp.sqrt(jnp.asarray(avg_num_neighbours, dtype=vectors.dtype))
        features_out = mlp_cls((*self.mlp_units, self.n_invariant_feat_hidden), activation=self.activation_fn, activate_final=False, dtype=self.dtype)(m_i, h)
        features_out = features_out.astype(h.dtype)
        if self.residual_h:
            features_out = features_out + h
        if self.residual_x:
            vectors_out = vectors_out + vectors
        return (vectors_out, features_out)

class EGNN(nn.Module):
    n_blocks: int
    mlp_units: Sequence[int]
    n_invariant_feat_hidden: int
    activation_fn: Callable = jax.nn.silu
    stable_mlp: bool = False
    residual_h: bool = True
    residual_x: bool = True
    normalization_constant: float = 1.0
    variance_scaling_init: float = 0.001
    dtype: Optional[jnp.dtype] = None
    remat_blocks: object = False

    @nn.compact
    def __call__(self, positions: jax.Array, node_features: jax.Array, global_features: jax.Array) -> jax.Array:
        assert positions.ndim == 3
        B, N, D = positions.shape
        pos_mean = jnp.mean(positions, axis=-2, keepdims=True)
        vectors = positions - pos_mean
        initial_vectors = vectors
        h = node_features
        if self.remat_blocks == 'dots':
            egcl_cls = nn.remat(EGCL, policy=jax.checkpoint_policies.dots_saveable)
        elif self.remat_blocks:
            egcl_cls = nn.remat(EGCL)
        else:
            egcl_cls = EGCL
        for i in range(self.n_blocks):
            h = ConcatDense(self.n_invariant_feat_hidden, dtype=self.dtype)(h, global_features[:, None, :]).astype(positions.dtype)
            vectors, h = egcl_cls(mlp_units=self.mlp_units, n_invariant_feat_hidden=self.n_invariant_feat_hidden, activation_fn=self.activation_fn, residual_h=self.residual_h, residual_x=self.residual_x, normalization_constant=self.normalization_constant, variance_scaling_init=self.variance_scaling_init, stable_mlp=self.stable_mlp, dtype=self.dtype, name=f'EGCL_{i}')(vectors, h)
        if self.residual_x:
            vectors = vectors - initial_vectors
        vectors = vectors - pos_mean
        vectors = vectors * self.param('final_scaling', nn.initializers.ones_init(), ())
        return vectors

class VectorNet(nn.Module):
    features: Sequence[int] = (512, 512, 512)
    embedding_dim: int = 32

    @nn.compact
    def __call__(self, x: jax.Array, t: jax.Array, features: Optional[jax.Array]=None) -> jax.Array:
        assert x.ndim == 2 and t.ndim == 1
        event_dim = x.shape[-1]
        t_embed = timestep_embedding(t, self.embedding_dim)
        for feat in self.features:
            x = nn.activation.gelu(ConcatDense(feat)(x, t_embed))
        return nn.Dense(event_dim)(x)

class FlatEGNNField(nn.Module):
    n_nodes: int
    dim: int
    n_features: int
    n_invariant_feat_hidden: int
    time_embedding_dim: int
    n_blocks_egnn: int
    mlp_units: Sequence[int]
    stable_mlp: bool = False
    compute_dtype: Optional[str] = None
    remat_blocks: object = False

    @nn.compact
    def __call__(self, positions: jax.Array, time: jax.Array, node_features: jax.Array) -> jax.Array:
        assert positions.ndim == 2 and time.ndim == 1
        B = positions.shape[0]
        pos = jnp.reshape(positions, (B, self.n_nodes, self.dim))
        feats = jnp.reshape(node_features, (B, self.n_nodes)).astype(jnp.int32)
        h = nn.Embed(num_embeddings=self.n_features, features=self.n_invariant_feat_hidden)(feats)
        t_emb = timestep_embedding(time, self.time_embedding_dim)
        dtype = jnp.dtype(self.compute_dtype) if self.compute_dtype else None
        vectors = EGNN(n_blocks=self.n_blocks_egnn, mlp_units=self.mlp_units, n_invariant_feat_hidden=self.n_invariant_feat_hidden, stable_mlp=self.stable_mlp, dtype=dtype, remat_blocks=self.remat_blocks)(pos, h, t_emb)
        return jnp.reshape(vectors, (B, self.n_nodes * self.dim))
