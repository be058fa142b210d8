"""The flax-free model layer against the flax modules it replaced.

For each module: the parameter tree has the same paths and shapes as
flax's, and applying flax-initialized parameters gives the same output.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("flax")

from tests import flax_reference as ref  # noqa: E402
from ecnf_jax.cnf.build import FlatEGNNField  # noqa: E402
from ecnf_jax.models.egnn import EGCL, EGNN  # noqa: E402
from ecnf_jax.models.mlp import MLP, ConcatDense, StableMLP  # noqa: E402
from ecnf_jax.models.vector_net import VectorNet  # noqa: E402


def _shapes(tree):
    return jax.tree_util.tree_map(lambda a: a.shape, tree)


def _check(ours, theirs, *inputs, atol=1e-5):
    flax_vars = theirs.init(jax.random.PRNGKey(0), *inputs)
    our_vars = ours.init(jax.random.PRNGKey(0), *inputs)
    assert _shapes(our_vars) == _shapes(flax_vars)
    got = ours.apply(flax_vars, *inputs)
    want = theirs.apply(flax_vars, *inputs)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(
            np.asarray(g, np.float32), np.asarray(w, np.float32), atol=atol
        )


def _normal(seed, shape):
    return jax.random.normal(jax.random.PRNGKey(seed), shape)


H = _normal(1, (2, 5, 8))
POS = _normal(2, (2, 5, 3))
T_EMB = _normal(3, (2, 4))


@pytest.mark.parametrize("dtype", [None, jnp.bfloat16])
def test_concat_dense(dtype):
    _check(
        ConcatDense(6, dtype=dtype), ref.ConcatDense(6, dtype=dtype),
        H[:, None], H[:, :, None], _normal(4, (2, 5, 5, 1)), atol=2e-2,
    )


@pytest.mark.parametrize("activate_final", [False, True])
def test_mlp(activate_final):
    _check(
        MLP((12, 8, 4), activate_final=activate_final),
        ref.MLP((12, 8, 4), activate_final=activate_final),
        H, H,
    )


@pytest.mark.parametrize(
    "kwargs",
    [{}, {"zero_init_output": True}, {"output_variance_scaling": 0.01},
     {"stable_layer": False}, {"dtype": jnp.bfloat16}],
)
def test_stable_mlp(kwargs):
    _check(
        StableMLP((12, 12, 4), **kwargs), ref.StableMLP((12, 12, 4), **kwargs),
        H, atol=2e-2 if "dtype" in kwargs else 1e-5,
    )


@pytest.mark.parametrize("stable_mlp", [False, True])
def test_egcl(stable_mlp):
    kw = dict(mlp_units=(16, 16), n_invariant_feat_hidden=8, stable_mlp=stable_mlp)
    _check(EGCL(**kw), ref.EGCL(**kw), POS, H)


@pytest.mark.parametrize("remat_blocks", [False, True, "dots"])
def test_egnn(remat_blocks):
    kw = dict(
        n_blocks=2, mlp_units=(16, 16), n_invariant_feat_hidden=8,
        remat_blocks=remat_blocks,
    )
    _check(EGNN(**kw), ref.EGNN(**kw), POS, H, T_EMB)


def test_egnn_bf16():
    kw = dict(n_blocks=2, mlp_units=(16, 16), n_invariant_feat_hidden=8,
              dtype=jnp.bfloat16)
    _check(EGNN(**kw), ref.EGNN(**kw), POS, H, T_EMB, atol=1e-2)


def test_flat_egnn_field():
    kw = dict(
        n_nodes=5, dim=3, n_features=2, n_invariant_feat_hidden=8,
        time_embedding_dim=4, n_blocks_egnn=2, mlp_units=(16, 16),
    )
    x = POS.reshape(2, 15)
    t = jnp.array([0.2, 0.7])
    feats = jnp.array([[0, 1, 0, 1, 1], [1, 1, 0, 0, 1]], jnp.int32)
    _check(FlatEGNNField(**kw), ref.FlatEGNNField(**kw), x, t, feats)


def test_vector_net():
    x = _normal(5, (4, 2))
    t = jnp.linspace(0.0, 1.0, 4)
    _check(
        VectorNet(features=(32, 32), embedding_dim=8),
        ref.VectorNet(features=(32, 32), embedding_dim=8),
        x, t,
    )


def test_init_distributions_match_flax():
    # Same initializers: lecun-normal kernels, zero biases, the
    # variance-scaled phi_x head, unit final scaling, normal embeddings.
    kw = dict(
        n_nodes=5, dim=3, n_features=3, n_invariant_feat_hidden=64,
        time_embedding_dim=8, n_blocks_egnn=1, mlp_units=(128, 128),
    )
    x = POS.reshape(2, 15)
    t = jnp.zeros(2)
    feats = jnp.zeros((2, 5), jnp.int32)
    ours = FlatEGNNField(**kw).init(jax.random.PRNGKey(0), x, t, feats)
    theirs = ref.FlatEGNNField(**kw).init(jax.random.PRNGKey(0), x, t, feats)
    flat_ours = dict(jax.tree_util.tree_leaves_with_path(ours))
    for path, want in jax.tree_util.tree_leaves_with_path(theirs):
        got, want = np.asarray(flat_ours[path]), np.asarray(want)
        if np.all(want == want.ravel()[0]):  # constant inits: exact
            np.testing.assert_array_equal(got, want)
            continue
        assert want.size >= 16, jax.tree_util.keystr(path)
        np.testing.assert_allclose(got.std(), want.std(), rtol=0.25)
        tol = 5 * want.std() / np.sqrt(want.size)  # sampling error of a mean
        np.testing.assert_allclose(got.mean(), want.mean(), atol=tol)
