"""CNF round-trip and log-prob correctness tests.

Strengthens the reference's smoke test (`ecnf/cnf/core_test.py` computed
``log_q`` two ways but never asserted) into real assertions:

- with a *linear* vector field the ODE log-det is known in closed form;
- `sample_and_log_prob_cnf` must agree with re-scoring via `get_log_prob`;
- the zero-CoM CNF must preserve the zero-CoM subspace.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ecnf_jax.cnf.core import FlowMatchingCNF, optimal_transport_conditional_vf
from ecnf_jax.cnf.base import DiagGaussian, ZeroCoMGaussian
from ecnf_jax.cnf.sampling import (
    SolveConfig,
    sample_cnf,
    get_log_prob,
    sample_and_log_prob_cnf,
)
from functools import partial


def _linear_cnf(dim=3, a=0.5):
    """CNF whose field is f(x) = a x: x(1) = e^a x(0), logdet = a * dim."""
    base = DiagGaussian(dim=dim, scale=1.0)

    def apply(params, x, t, features=None):
        return a * x

    return FlowMatchingCNF(
        init=lambda *args, **kw: {},
        apply=apply,
        sample_base=base.sample,
        get_x_t_and_conditional_u_t=partial(
            optimal_transport_conditional_vf, sigma_min=0.01
        ),
        log_prob_base=base.log_prob,
        sample_and_log_prob_base=base.sample_and_log_prob,
    )


class TestLinearFlow:
    def test_sample_is_exp_scaling(self):
        cnf = _linear_cnf(dim=3, a=0.5)
        key = jax.random.PRNGKey(0)
        x1 = sample_cnf(cnf, {}, key, 16, cfg=SolveConfig())
        x0 = cnf.sample_base(key, (16,))
        np.testing.assert_allclose(x1, x0 * np.exp(0.5), rtol=1e-4)

    def test_log_prob_closed_form(self):
        # For x1 = e^a x0: log p(x1) = log N(e^{-a} x1) - a * dim.
        dim, a = 3, 0.5
        cnf = _linear_cnf(dim=dim, a=a)
        x = jax.random.normal(jax.random.PRNGKey(1), (8, dim))
        log_p, log_pb, delta = get_log_prob(cnf, {}, x, jax.random.PRNGKey(2))
        expected = DiagGaussian(dim=dim, scale=1.0).log_prob(x * np.exp(-a)) - a * dim
        np.testing.assert_allclose(log_p, expected, rtol=1e-4, atol=1e-4)

    def test_hutchinson_matches_exact_for_linear(self):
        # For a linear field the Hutchinson estimate has zero variance in
        # expectation only; but for f = a x, J = a I and eps.(J eps) =
        # a |eps|^2 which is NOT deterministic. Instead check that the
        # exact path with chunking matches unchunked.
        cnf = _linear_cnf(dim=4, a=-0.3)
        x = jax.random.normal(jax.random.PRNGKey(3), (4, 4))
        lp1, _, _ = get_log_prob(cnf, {}, x, jax.random.PRNGKey(4))
        lp2, _, _ = get_log_prob(
            cnf, {}, x, jax.random.PRNGKey(4), cfg=SolveConfig(trace_column_chunk=2)
        )
        np.testing.assert_allclose(lp1, lp2, rtol=1e-5)

    def test_sample_and_log_prob_consistent_with_rescore(self):
        cnf = _linear_cnf(dim=2, a=0.4)
        x1, log_q = sample_and_log_prob_cnf(cnf, {}, jax.random.PRNGKey(5), 8)
        log_q2, _, _ = get_log_prob(cnf, {}, x1, jax.random.PRNGKey(6))
        np.testing.assert_allclose(log_q, log_q2, rtol=1e-3, atol=1e-3)

    def test_rk4_fixed_step_matches_closed_form(self):
        # The rk4 fixed-step option through the full
        # sample/log-prob surface (field + divergence in one solve).
        dim, a = 3, 0.5
        cnf = _linear_cnf(dim=dim, a=a)
        rk4 = SolveConfig(use_fixed_step_size=True, step_size=0.05, method="rk4")
        key = jax.random.PRNGKey(0)
        x1 = sample_cnf(cnf, {}, key, 16, cfg=rk4)
        x0 = cnf.sample_base(key, (16,))
        np.testing.assert_allclose(x1, x0 * np.exp(a), rtol=1e-4)
        x = jax.random.normal(jax.random.PRNGKey(1), (8, dim))
        log_p, _, _ = get_log_prob(cnf, {}, x, jax.random.PRNGKey(2), cfg=rk4)
        expected = DiagGaussian(dim=dim, scale=1.0).log_prob(x * np.exp(-a)) - a * dim
        np.testing.assert_allclose(log_p, expected, rtol=1e-4, atol=1e-4)

    def test_fixed_step_matches_adaptive(self):
        cnf = _linear_cnf(dim=2, a=0.4)
        cfg_fixed = SolveConfig(use_fixed_step_size=True, step_size=0.02)
        x1a, lqa = sample_and_log_prob_cnf(cnf, {}, jax.random.PRNGKey(7), 4)
        x1f, lqf = sample_and_log_prob_cnf(
            cnf, {}, jax.random.PRNGKey(7), 4, cfg=cfg_fixed
        )
        np.testing.assert_allclose(x1a, x1f, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(lqa, lqf, rtol=1e-3, atol=1e-3)


class TestZeroCoMFlow:
    def test_zero_com_preserved(self):
        """A zero-CoM-projecting field keeps samples on the hyperplane."""
        N, D = 4, 2
        base = ZeroCoMGaussian(n_nodes=N, dim=D, scale=1.0)

        def apply(params, x, t, features=None):
            v = 0.3 * x
            v = v.reshape(-1, N, D)
            v = v - v.mean(axis=1, keepdims=True)
            return v.reshape(-1, N * D)

        cnf = FlowMatchingCNF(
            init=lambda *a, **k: {},
            apply=apply,
            sample_base=base.sample,
            get_x_t_and_conditional_u_t=partial(
                optimal_transport_conditional_vf, sigma_min=0.01
            ),
            log_prob_base=base.log_prob,
            sample_and_log_prob_base=base.sample_and_log_prob,
        )
        x1 = sample_cnf(cnf, {}, jax.random.PRNGKey(0), 8)
        com = x1.reshape(8, N, D).mean(axis=1)
        np.testing.assert_allclose(com, np.zeros_like(com), atol=1e-5)
