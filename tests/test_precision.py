"""Mixed-precision (bf16 compute) validation + multi-probe Hutchinson."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ecnf_jax.cnf.build import build_cnf
from ecnf_jax.cnf.sampling import SolveConfig, get_log_prob
from ecnf_jax.models.egnn import EGNN
from ecnf_jax.ops.divergence import (
    exact_divergence,
    value_and_multi_probe_hutchinson,
)
from ecnf_jax.utils.test_utils import random_rotation_matrix


def _mk_cnf(compute_dtype=None):
    return build_cnf(
        n_frames=5,
        dim=3,
        sigma_min=0.01,
        base_scale=1.0,
        n_blocks_egnn=2,
        mlp_units=(16,),
        n_invariant_feat_hidden=8,
        time_embedding_dim=6,
        n_features=1,
        compute_dtype=compute_dtype,
    )


class TestBF16:
    def test_bf16_close_to_f32(self):
        cnf32 = _mk_cnf(None)
        cnf16 = _mk_cnf("bfloat16")
        x = jax.random.normal(jax.random.PRNGKey(0), (4, 15))
        t = jnp.full((4,), 0.5)
        feats = jnp.zeros((4, 5), dtype=jnp.int32)
        params = cnf32.init(jax.random.PRNGKey(1), x, t, feats)
        out32 = cnf32.apply(params, x, t, feats)
        out16 = cnf16.apply(params, x, t, feats)
        assert out16.dtype == jnp.float32  # geometry path keeps f32 output
        # bf16 has ~3 decimal digits; fields are O(0.1).
        np.testing.assert_allclose(
            np.asarray(out16), np.asarray(out32), atol=5e-2, rtol=5e-2
        )

    def test_bf16_equivariance_exact(self):
        """bf16 MLP compute must preserve E(3) equivariance exactly (to
        f32 geometry roundoff): only invariants enter the MLPs."""
        net = EGNN(
            n_blocks=2, mlp_units=(16,), n_invariant_feat_hidden=8,
            dtype=jnp.bfloat16,
        )
        pos = jax.random.normal(jax.random.PRNGKey(0), (2, 5, 3))
        h = jax.random.normal(jax.random.PRNGKey(1), (2, 5, 8))
        temb = jax.random.normal(jax.random.PRNGKey(2), (2, 6))
        params = net.init(jax.random.PRNGKey(3), pos, h, temb)
        R = random_rotation_matrix(jax.random.PRNGKey(4), 3)

        out = net.apply(params, pos, h, temb)
        rot_out = net.apply(params, jnp.einsum("ij,bnj->bni", R, pos), h, temb)
        # Rotation changes the invariants only at f32 rounding level, but
        # bf16 activations can amplify tiny invariant differences; the
        # property must still hold to bf16 resolution.
        np.testing.assert_allclose(
            np.asarray(jnp.einsum("ij,bnj->bni", R, out)),
            np.asarray(rot_out),
            atol=2e-2, rtol=2e-2,
        )


class TestMultiProbeHutchinson:
    def test_converges_to_exact(self):
        W = jax.random.normal(jax.random.PRNGKey(0), (6, 6))
        f = lambda x: jnp.tanh(x @ W) + 0.5 * x
        x = jax.random.normal(jax.random.PRNGKey(1), (3, 6))
        exact = exact_divergence(f, x)
        eps = jax.random.normal(jax.random.PRNGKey(2), (512, 3, 6))
        _, est = value_and_multi_probe_hutchinson(f, x, eps)
        np.testing.assert_allclose(np.asarray(est), np.asarray(exact), rtol=0.15)

    def test_variance_decreases(self):
        W = jax.random.normal(jax.random.PRNGKey(0), (6, 6))
        f = lambda x: jnp.tanh(x @ W)
        x = jax.random.normal(jax.random.PRNGKey(1), (2, 6))

        def est(key, k):
            eps = jax.random.normal(key, (k, 2, 6))
            return value_and_multi_probe_hutchinson(f, x, eps)[1]

        keys = jax.random.split(jax.random.PRNGKey(2), 64)
        var1 = jnp.var(jnp.stack([est(k, 1) for k in keys]), axis=0)
        var8 = jnp.var(jnp.stack([est(k, 8) for k in keys]), axis=0)
        assert float(jnp.mean(var8)) < float(jnp.mean(var1)) / 4

    def test_log_prob_with_probes(self):
        cnf = _mk_cnf()
        x = jax.random.normal(jax.random.PRNGKey(0), (4, 15)) * 0.5
        x = x.reshape(4, 5, 3)
        x = (x - x.mean(axis=1, keepdims=True)).reshape(4, 15)
        t = jnp.zeros(4)
        feats = jnp.zeros((4, 5), dtype=jnp.int32)
        params = cnf.init(jax.random.PRNGKey(1), x, t, feats)
        exact, _, _ = get_log_prob(cnf, params, x, jax.random.PRNGKey(2), feats)
        approx, _, _ = get_log_prob(
            cnf, params, x, jax.random.PRNGKey(2), feats, approx=True,
            cfg=SolveConfig(hutchinson_probes=64),
        )
        # 64 probes: statistical agreement with the exact trace (log-probs
        # are O(-20); the estimator error at K=64 is well under 2 nats here).
        np.testing.assert_allclose(np.asarray(approx), np.asarray(exact), atol=2.0)
