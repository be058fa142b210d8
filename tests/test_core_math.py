"""Unit tests for core CNF math: OT path, zero-CoM base, timestep embedding.

Validates closed forms against the reference semantics
(`ecnf/cnf/core.py:35-39`, `ecnf/cnf/zero_com_base.py:64-94`,
`ecnf/cnf/build_cnf.py:18-61`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ecnf_jax.cnf.core import optimal_transport_conditional_vf
from ecnf_jax.cnf.base import (
    ZeroCoMGaussian,
    DiagGaussian,
    remove_mean,
    centre_gravity_zero_gaussian_log_likelihood,
)
from ecnf_jax.ops.numerics import timestep_embedding, safe_norm, maybe_masked_mean


class TestOTPath:
    def test_endpoints(self):
        key = jax.random.PRNGKey(0)
        x0 = jax.random.normal(key, (7, 6))
        x1 = jax.random.normal(jax.random.PRNGKey(1), (7, 6))
        sigma_min = 0.01
        x_t0, _ = optimal_transport_conditional_vf(x0, x1, jnp.zeros(7), sigma_min)
        np.testing.assert_allclose(x_t0, x0, rtol=1e-6)
        x_t1, _ = optimal_transport_conditional_vf(x0, x1, jnp.ones(7), sigma_min)
        np.testing.assert_allclose(x_t1, sigma_min * x0 + x1, rtol=1e-5, atol=1e-6)

    def test_vf_is_path_derivative(self):
        # u_t must equal d(x_t)/dt for the OT path.
        x0 = jnp.array([[1.0, -2.0]])
        x1 = jnp.array([[3.0, 0.5]])
        sigma_min = 0.05
        t = jnp.array([0.3])
        _, u_t = optimal_transport_conditional_vf(x0, x1, t, sigma_min)
        grad = jax.jacfwd(
            lambda tt: optimal_transport_conditional_vf(x0, x1, tt, sigma_min)[0][0]
        )(t)[:, 0]
        np.testing.assert_allclose(u_t[0], grad, rtol=1e-6)

    def test_batched_matches_per_sample(self):
        x0 = jax.random.normal(jax.random.PRNGKey(2), (5, 4))
        x1 = jax.random.normal(jax.random.PRNGKey(3), (5, 4))
        t = jax.random.uniform(jax.random.PRNGKey(4), (5,))
        xb, ub = optimal_transport_conditional_vf(x0, x1, t, 0.01)
        for i in range(5):
            xi, ui = optimal_transport_conditional_vf(x0[i], x1[i], t[i], 0.01)
            np.testing.assert_allclose(xb[i], xi, rtol=1e-6)
            np.testing.assert_allclose(ub[i], ui, rtol=1e-6)


class TestZeroCoMGaussian:
    def test_samples_have_zero_com(self):
        base = ZeroCoMGaussian(n_nodes=5, dim=3, scale=2.0)
        x = base.sample(jax.random.PRNGKey(0), (64,))
        x = x.reshape(64, 5, 3)
        com = jnp.mean(x, axis=1)
        np.testing.assert_allclose(com, np.zeros_like(com), atol=1e-5)

    def test_log_prob_closed_form(self):
        # For unit scale: log p = -0.5 r^2 - 0.5 (N-1) D log(2 pi).
        N, D = 4, 2
        base = ZeroCoMGaussian(n_nodes=N, dim=D, scale=1.0)
        x = jax.random.normal(jax.random.PRNGKey(1), (8, N, D))
        x = remove_mean(x)
        lp = base.log_prob(x.reshape(8, N * D))
        expected = -0.5 * jnp.sum(x**2, axis=(-1, -2)) - 0.5 * (N - 1) * D * np.log(
            2 * np.pi
        )
        np.testing.assert_allclose(lp, expected, rtol=1e-6)

    def test_scale_log_det_correction(self):
        # Scaled log-prob must use (N-1)*D effective DoF:
        # log p_s(x) = log p_1(x / s) - (N-1) D log s   (build_cnf.py:50-57).
        N, D, s = 5, 3, 2.5
        base1 = ZeroCoMGaussian(n_nodes=N, dim=D, scale=1.0)
        bases = ZeroCoMGaussian(n_nodes=N, dim=D, scale=s)
        x = remove_mean(jax.random.normal(jax.random.PRNGKey(2), (6, N, D))).reshape(
            6, N * D
        )
        np.testing.assert_allclose(
            bases.log_prob(x),
            base1.log_prob(x / s) - (N - 1) * D * np.log(s),
            rtol=1e-6,
        )

    def test_log_prob_integrates_to_one_2d(self):
        # N=2, D=1: the zero-CoM hyperplane is 1-dimensional; check the
        # pushforward density of u = (x1 - x2)/sqrt(2)... simpler: MC check
        # E_q[exp(log p - log q)] = 1 with q = the sampler itself.
        base = ZeroCoMGaussian(n_nodes=2, dim=1, scale=1.0)
        x = base.sample(jax.random.PRNGKey(3), (4096,))
        lp = base.log_prob(x)
        # x = (z, -z) with z ~ N(0, 1/2) effectively; check self-consistency:
        # mean of log p should match closed form for 1 DoF Gaussian.
        r2 = jnp.sum(x**2, axis=-1)
        expected = -0.5 * r2 - 0.5 * 1 * np.log(2 * np.pi)
        np.testing.assert_allclose(lp, expected, rtol=1e-5)

    def test_sample_and_log_prob_consistent(self):
        base = ZeroCoMGaussian(n_nodes=4, dim=3, scale=1.7)
        x, lp = base.sample_and_log_prob(jax.random.PRNGKey(4), (16,))
        np.testing.assert_allclose(lp, base.log_prob(x), rtol=1e-6)

    def test_rotation_invariance(self):
        base = ZeroCoMGaussian(n_nodes=6, dim=2, scale=1.0)
        x = base.sample(jax.random.PRNGKey(5), (4,)).reshape(4, 6, 2)
        theta = 0.7
        R = jnp.array(
            [[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]]
        )
        xr = jnp.einsum("ij,bnj->bni", R, x)
        np.testing.assert_allclose(
            base.log_prob(x.reshape(4, -1)),
            base.log_prob(xr.reshape(4, -1)),
            rtol=1e-5,
        )


class TestDiagGaussian:
    def test_log_prob_matches_scipy(self):
        from scipy.stats import norm

        base = DiagGaussian(dim=3, scale=2.0)
        x = np.random.RandomState(0).randn(5, 3).astype(np.float32)
        lp = base.log_prob(jnp.asarray(x))
        expected = norm.logpdf(x, scale=2.0).sum(-1)
        np.testing.assert_allclose(lp, expected, rtol=1e-5)


class TestTimestepEmbedding:
    def test_shape_and_range(self):
        t = jnp.linspace(0, 1, 11)
        emb = timestep_embedding(t, 8)
        assert emb.shape == (11, 8)
        assert jnp.all(jnp.abs(emb) <= 1.0 + 1e-6)

    def test_formula(self):
        # Direct transcription of the reference formula (build_cnf.py:18-32).
        t = jnp.array([0.25, 0.75])
        dim = 6
        emb = timestep_embedding(t, dim)
        ts = np.asarray(t) * 1000
        half = dim // 2
        freqs = np.exp(np.arange(half) * -(np.log(10_000) / (half - 1)))
        args = ts[:, None] * freqs[None, :]
        expected = np.concatenate([np.sin(args), np.cos(args)], axis=1)
        np.testing.assert_allclose(emb, expected, rtol=1e-5, atol=1e-5)


class TestNumerics:
    def test_safe_norm_zero(self):
        x = jnp.zeros((3,))
        assert float(safe_norm(x)) == 1.0
        g = jax.grad(lambda v: jnp.sum(safe_norm(v, axis=-1)))(jnp.zeros((2, 3)))
        assert np.all(np.isfinite(g))

    def test_safe_norm_nonzero(self):
        x = jnp.array([3.0, 4.0])
        np.testing.assert_allclose(float(safe_norm(x)), 5.0, rtol=1e-6)

    def test_maybe_masked_mean(self):
        a = jnp.array([1.0, 2.0, 3.0, 4.0])
        m = jnp.array([1, 1, 0, 0])
        assert float(maybe_masked_mean(a, m)) == 1.5
        assert float(maybe_masked_mean(a, None)) == 2.5
        assert float(maybe_masked_mean(a, jnp.zeros(4))) == 0.0
