"""Hand-linearized EGNN trace (`ops/tangent.py`) vs autodiff.

The structured tangent path must reproduce `jax.linearize` exactly in f32
(same math, reference semantics `ecnf/cnf/sample_and_log_prob.py:64-66`)
across model shapes, and end-to-end through `get_log_prob`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ecnf_jax.cnf.build import build_cnf
from ecnf_jax.cnf.sampling import SolveConfig, get_log_prob
from ecnf_jax.ops.divergence import value_and_exact_divergence
from ecnf_jax.ops.tangent import egnn_value_and_trace


def _setup(n, dim, blocks, units, cdt=None, B=6):
    cnf = build_cnf(
        n_frames=n, dim=dim, sigma_min=0.01, base_scale=1.0,
        n_blocks_egnn=blocks, mlp_units=units,
        n_invariant_feat_hidden=16, time_embedding_dim=8, n_features=2,
        compute_dtype=cdt,
    )
    D = n * dim
    x = jax.random.normal(jax.random.PRNGKey(0), (B, D))
    t = jnp.linspace(0.1, 0.9, B)
    feats = jnp.tile(jnp.arange(n) % 2, (B, 1)).astype(jnp.int32)
    params = cnf.init(jax.random.PRNGKey(1), x[:2], t[:2], feats[:2])
    return cnf, params, x, t, feats


class TestStructuredTangent:
    @pytest.mark.parametrize(
        "n,dim,blocks,units",
        [(5, 3, 2, (32, 32)), (4, 2, 3, (32, 32, 32)), (5, 3, 2, (32,) * 4)],
    )
    def test_matches_linearize_f32(self, n, dim, blocks, units):
        cnf, params, x, t, feats = _setup(n, dim, blocks, units)
        basis, off = cnf.exact_trace_plan(params)
        f = lambda xb: cnf.apply(params, xb, t, feats)
        v_ref, div_ref = value_and_exact_divergence(
            f, x, basis=basis, trace_offset=off
        )
        v, div = egnn_value_and_trace(
            params, x, t, feats, basis,
            n_nodes=n, dim=dim, n_blocks=blocks, mlp_units=units,
            time_embedding_dim=8, trace_offset=off,
        )
        np.testing.assert_allclose(v, v_ref, atol=1e-6)
        np.testing.assert_allclose(div, div_ref, rtol=1e-4, atol=1e-4)

    def test_identity_basis_full_trace(self):
        # Without the trace plan the path must still give the full trace.
        cnf, params, x, t, feats = _setup(5, 3, 2, (32, 32))
        D = x.shape[-1]
        f = lambda xb: cnf.apply(params, xb, t, feats)
        _, div_ref = value_and_exact_divergence(f, x)
        _, div = egnn_value_and_trace(
            params, x, t, feats, jnp.eye(D),
            n_nodes=5, dim=3, n_blocks=2, mlp_units=(32, 32),
            time_embedding_dim=8,
        )
        np.testing.assert_allclose(div, div_ref, rtol=1e-4, atol=1e-4)

    def test_bf16_close_to_bf16_linearize(self):
        cnf, params, x, t, feats = _setup(5, 3, 2, (32, 32), cdt="bfloat16")
        basis, off = cnf.exact_trace_plan(params)
        f = lambda xb: cnf.apply(params, xb, t, feats)
        v_ref, div_ref = value_and_exact_divergence(
            f, x, basis=basis, trace_offset=off
        )
        v, div = egnn_value_and_trace(
            params, x, t, feats, basis,
            n_nodes=5, dim=3, n_blocks=2, mlp_units=(32, 32),
            time_embedding_dim=8, compute_dtype="bfloat16", trace_offset=off,
        )
        np.testing.assert_allclose(v, v_ref, atol=1e-6)  # same primal math
        np.testing.assert_allclose(div, div_ref, rtol=2e-2, atol=2e-2)

    def test_divergence_rotation_invariant(self):
        # For an E(n)-equivariant field, J(Rx) = R J(x) R^T, so the exact
        # divergence is rotation-invariant — a physics-grounded check of the
        # whole tangent stack (seeds, geometry tangent, epilogue).
        cnf, params, x, t, feats = _setup(5, 3, 2, (32, 32))
        from ecnf_jax.utils.test_utils import random_rotation_matrix

        R = random_rotation_matrix(jax.random.PRNGKey(7), 3)
        basis, off = cnf.exact_trace_plan(params)

        def div_of(xb):
            return egnn_value_and_trace(
                params, xb, t, feats, basis,
                n_nodes=5, dim=3, n_blocks=2, mlp_units=(32, 32),
                time_embedding_dim=8, trace_offset=off,
            )[1]

        x_rot = (x.reshape(-1, 5, 3) @ R.T).reshape(x.shape)
        np.testing.assert_allclose(div_of(x_rot), div_of(x), rtol=1e-4)

    def test_divergence_permutation_invariant(self):
        # Permuting identical nodes permutes J's rows/cols: trace unchanged.
        cnf, params, x, t, feats = _setup(5, 3, 2, (32, 32))
        feats = jnp.zeros_like(feats)  # identical nodes
        basis, off = cnf.exact_trace_plan(params)

        def div_of(xb):
            return egnn_value_and_trace(
                params, xb, t, feats, basis,
                n_nodes=5, dim=3, n_blocks=2, mlp_units=(32, 32),
                time_embedding_dim=8, trace_offset=off,
            )[1]

        perm = jnp.array([2, 0, 4, 1, 3])
        x_perm = x.reshape(-1, 5, 3)[:, perm].reshape(x.shape)
        np.testing.assert_allclose(div_of(x_perm), div_of(x), rtol=1e-4)

    def test_per_sample_probes_match_jvp(self):
        # Hutchinson form: per-sample probe directions [K, B, D] (raw
        # Gaussian, NOT zero-CoM) must give eps . (J eps) exactly — the
        # translation component is reconstructed analytically.
        cnf, params, x, t, feats = _setup(5, 3, 2, (32, 32))
        B, D = x.shape
        eps = jax.random.normal(jax.random.PRNGKey(9), (3, B, D))
        f = lambda xb: cnf.apply(params, xb, t, feats)
        from ecnf_jax.ops.divergence import value_and_multi_probe_hutchinson

        v_ref, div_ref = value_and_multi_probe_hutchinson(f, x, eps)
        v, div = egnn_value_and_trace(
            params, x, t, feats, eps,
            n_nodes=5, dim=3, n_blocks=2, mlp_units=(32, 32),
            time_embedding_dim=8,
        )
        np.testing.assert_allclose(v, v_ref, atol=1e-6)
        np.testing.assert_allclose(div / 3.0, div_ref, rtol=1e-4, atol=1e-4)

    def test_get_log_prob_approx_dispatch(self):
        # End-to-end Hutchinson: structured-tangent solve equals the jvp
        # solve, for single- and multi-probe configs (same probe key).
        cnf, params, x, t, feats = _setup(5, 3, 2, (32, 32))
        key = jax.random.PRNGKey(4)
        for K in (1, 3):
            base = SolveConfig(
                use_fixed_step_size=True, step_size=0.2, hutchinson_probes=K
            )
            on = get_log_prob(cnf, params, x, key, feats, approx=True, cfg=base)[0]
            off = get_log_prob(
                cnf, params, x, key, feats, approx=True,
                cfg=SolveConfig(
                    use_fixed_step_size=True, step_size=0.2,
                    hutchinson_probes=K, structured_tangent=False,
                ),
            )[0]
            np.testing.assert_allclose(on, off, rtol=1e-5, atol=1e-5)

    def test_get_log_prob_dispatch(self):
        # End-to-end: the structured-tangent solve equals the linearize solve.
        cnf, params, x, t, feats = _setup(5, 3, 2, (32, 32))
        key = jax.random.PRNGKey(3)
        base = SolveConfig(use_fixed_step_size=True, step_size=0.2)
        on = get_log_prob(cnf, params, x, key, feats, cfg=base)[0]
        off = get_log_prob(
            cnf, params, x, key, feats,
            cfg=SolveConfig(
                use_fixed_step_size=True, step_size=0.2, structured_tangent=False
            ),
        )[0]
        assert cnf.tangent_value_and_div is not None
        np.testing.assert_allclose(on, off, rtol=1e-5, atol=1e-5)
