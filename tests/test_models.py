"""Model tests: ConcatDense fusion parity, MLP shapes, EGNN properties.

EGNN property tests mirror the reference's equivariance harness
(`ecnf/nets/egnn_test.py`, `ecnf/utils/test.py:60-76`) plus permutation
equivariance and zero-CoM output checks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ecnf_jax.models.mlp import MLP, StableMLP, ConcatDense
from ecnf_jax.models.egnn import EGNN, EGCL
from ecnf_jax.models.vector_net import VectorNet
from ecnf_jax.utils.test_utils import random_rotation_matrix


class TestConcatDense:
    def test_matches_dense_on_concat(self):
        """Split matmuls must agree with Dense(concat) for identical params."""
        key = jax.random.PRNGKey(0)
        a = jax.random.normal(key, (4, 3))
        b = jax.random.normal(jax.random.PRNGKey(1), (4, 5))

        fused = ConcatDense(7)
        params = fused.init(jax.random.PRNGKey(2), a, b)
        out_fused = fused.apply(params, a, b)

        out_dense = (
            jnp.concatenate([a, b], axis=-1) @ params["params"]["kernel"]
            + params["params"]["bias"]
        )
        np.testing.assert_allclose(out_fused, out_dense, rtol=1e-5, atol=1e-6)

    def test_broadcast_matches_materialized(self):
        """Edge-style broadcasting (senders x receivers) must equal the
        materialized concat formulation."""
        B, N, H = 2, 5, 4
        h = jax.random.normal(jax.random.PRNGKey(0), (B, N, H))
        l2 = jax.random.normal(jax.random.PRNGKey(1), (B, N, N, 1))

        fused = ConcatDense(6)
        params = fused.init(jax.random.PRNGKey(2), h[:, None], h[:, :, None], l2)
        out = fused.apply(params, h[:, None], h[:, :, None], l2)
        assert out.shape == (B, N, N, 6)

        # Materialized equivalent.
        hs = jnp.broadcast_to(h[:, None], (B, N, N, H))
        hr = jnp.broadcast_to(h[:, :, None], (B, N, N, H))
        concat = jnp.concatenate([hs, hr, l2], axis=-1)
        dense_out = (
            concat @ params["params"]["kernel"] + params["params"]["bias"]
        )
        np.testing.assert_allclose(out, dense_out, rtol=1e-5, atol=1e-6)


class TestMLP:
    def test_shapes(self):
        m = MLP([12, 8, 4])
        x = jnp.ones((32, 10))
        params = m.init(jax.random.PRNGKey(0), x)
        assert m.apply(params, x).shape == (32, 4)

    def test_stable_mlp_shapes(self):
        m = StableMLP([12, 12])
        x = jnp.ones((32, 10))
        params = m.init(jax.random.PRNGKey(0), x)
        assert m.apply(params, x).shape == (32, 12)

    def test_stable_mlp_zero_init(self):
        m = StableMLP([8, 8], zero_init_output=True)
        x = jax.random.normal(jax.random.PRNGKey(0), (4, 6))
        params = m.init(jax.random.PRNGKey(1), x)
        np.testing.assert_allclose(m.apply(params, x), np.zeros((4, 8)), atol=1e-7)


def _make_egnn(n_blocks=2, units=(16,), hid=8):
    return EGNN(n_blocks=n_blocks, mlp_units=units, n_invariant_feat_hidden=hid)


def _init_egnn(net, key, B=3, N=5, D=3, hid=8, t_dim=6):
    pos = jax.random.normal(key, (B, N, D))
    h = jax.random.normal(jax.random.PRNGKey(7), (B, N, hid))
    t_emb = jax.random.normal(jax.random.PRNGKey(8), (B, t_dim))
    params = net.init(jax.random.PRNGKey(9), pos, h, t_emb)
    return params, pos, h, t_emb


class TestEGNN:
    @pytest.mark.parametrize("dim", [2, 3])
    def test_rotation_equivariance(self, dim):
        """f(R x) == R f(x) (reference `egnn_test.py:27-31`, tol 1e-6)."""
        B, N, hid = 2, 5, 8
        net = _make_egnn()
        params, pos, h, t_emb = _init_egnn(net, jax.random.PRNGKey(0), B=B, N=N, D=dim)
        R = random_rotation_matrix(jax.random.PRNGKey(1), dim)

        out = net.apply(params, pos, h, t_emb)
        out_rot = jnp.einsum("ij,bnj->bni", R, out)
        rot_out = net.apply(params, jnp.einsum("ij,bnj->bni", R, pos), h, t_emb)
        np.testing.assert_allclose(out_rot, rot_out, atol=1e-5, rtol=1e-5)

    def test_translation_covariance(self):
        """The field on centered coords is translation-invariant; the final
        recentring subtracts the input-position mean (`egnn.py:186`), so
        ``f(x + s) == f(x) - s`` exactly."""
        net = _make_egnn()
        params, pos, h, t_emb = _init_egnn(net, jax.random.PRNGKey(2))
        shift = jnp.array([1.0, -2.0, 3.0])
        out1 = net.apply(params, pos, h, t_emb)
        out2 = net.apply(params, pos + shift, h, t_emb)
        np.testing.assert_allclose(out1 - shift, out2, atol=1e-5, rtol=1e-4)

    def test_permutation_equivariance(self):
        net = _make_egnn()
        params, pos, h, t_emb = _init_egnn(net, jax.random.PRNGKey(3))
        perm = jnp.array([2, 0, 4, 1, 3])
        out = net.apply(params, pos, h, t_emb)
        out_perm = net.apply(params, pos[:, perm], h[:, perm], t_emb)
        np.testing.assert_allclose(out[:, perm], out_perm, atol=1e-5, rtol=1e-4)

    def test_batch_consistency(self):
        """Batched forward must equal per-sample forwards."""
        net = _make_egnn()
        params, pos, h, t_emb = _init_egnn(net, jax.random.PRNGKey(4))
        out = net.apply(params, pos, h, t_emb)
        for i in range(pos.shape[0]):
            out_i = net.apply(params, pos[i : i + 1], h[i : i + 1], t_emb[i : i + 1])
            np.testing.assert_allclose(out[i], out_i[0], atol=1e-5, rtol=1e-4)

    def test_gradients_finite(self):
        net = _make_egnn()
        params, pos, h, t_emb = _init_egnn(net, jax.random.PRNGKey(6))

        def loss(p):
            return jnp.sum(net.apply(p, pos, h, t_emb) ** 2)

        grads = jax.grad(loss)(params)
        for leaf in jax.tree_util.tree_leaves(grads):
            assert np.all(np.isfinite(leaf))

    def test_coincident_points_finite(self):
        """Zero pairwise distances must not produce NaNs (safe_norm)."""
        net = _make_egnn()
        params, pos, h, t_emb = _init_egnn(net, jax.random.PRNGKey(7))
        pos = jnp.zeros_like(pos)  # all points coincident
        out = net.apply(params, pos, h, t_emb)
        assert np.all(np.isfinite(out))
        grads = jax.grad(lambda p: jnp.sum(net.apply(p, pos, h, t_emb) ** 2))(params)
        for leaf in jax.tree_util.tree_leaves(grads):
            assert np.all(np.isfinite(leaf))


class TestVectorNet:
    def test_shapes(self):
        net = VectorNet(features=(32, 32), embedding_dim=8)
        x = jax.random.normal(jax.random.PRNGKey(0), (4, 2))
        t = jnp.zeros(4)
        params = net.init(jax.random.PRNGKey(1), x, t)
        assert net.apply(params, x, t).shape == (4, 2)


class TestRematBlocks:
    """`remat_blocks=True` must be a pure perf lever: identical parameter
    tree (explicit EGCL_i names keep checkpoints interchangeable),
    identical forward values, identical gradients."""

    def test_params_forward_and_grad_identical(self):
        net = _make_egnn()
        net_rm = EGNN(
            n_blocks=2, mlp_units=(16,), n_invariant_feat_hidden=8,
            remat_blocks=True,
        )
        params, pos, h, t_emb = _init_egnn(net, jax.random.PRNGKey(10))
        params_rm = net_rm.init(jax.random.PRNGKey(9), pos, h, t_emb)

        paths = jax.tree_util.tree_structure(params)
        paths_rm = jax.tree_util.tree_structure(params_rm)
        assert paths == paths_rm
        for a, b in zip(
            jax.tree_util.tree_leaves(params),
            jax.tree_util.tree_leaves(params_rm),
        ):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

        out = net.apply(params, pos, h, t_emb)
        out_rm = net_rm.apply(params, pos, h, t_emb)
        np.testing.assert_allclose(np.asarray(out), np.asarray(out_rm),
                                   rtol=0, atol=0)

        def loss(p, n):
            return jnp.sum(n.apply(p, pos, h, t_emb) ** 2)

        g = jax.grad(loss)(params, net)
        g_rm = jax.grad(loss)(params, net_rm)
        for a, b in zip(jax.tree_util.tree_leaves(g),
                        jax.tree_util.tree_leaves(g_rm)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-6, atol=1e-6)
