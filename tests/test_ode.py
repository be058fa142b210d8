"""ODE engine tests: fixed + adaptive Dopri5 vs closed forms and scipy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ecnf_jax.ops.ode import odeint_adaptive, odeint_fixed, odeint
from ecnf_jax.ops.divergence import exact_divergence, hutchinson_divergence


def linear_field(t, y):
    # dy/dt = -y  -> y(t) = y0 exp(-t)
    return -y


def stiffish_field(t, y):
    return -5.0 * y + jnp.sin(10.0 * t[:, None])


class TestFixedStep:
    def test_exponential_decay(self):
        y0 = jnp.ones((4, 3)) * jnp.array([1.0, 2.0, -3.0])
        y1, stats = odeint_fixed(linear_field, y0, 0.0, 1.0, step_size=0.05)
        np.testing.assert_allclose(y1, y0 * np.exp(-1.0), rtol=1e-6)
        assert int(stats.num_steps) == 20

    def test_backwards(self):
        y0 = jnp.ones((2, 2))
        y1, _ = odeint_fixed(linear_field, y0, 1.0, 0.0, step_size=0.05)
        np.testing.assert_allclose(y1, y0 * np.exp(1.0), rtol=1e-6)

    def test_roundtrip(self):
        y0 = jax.random.normal(jax.random.PRNGKey(0), (3, 5))
        fwd, _ = odeint_fixed(stiffish_field, y0, 0.0, 1.0, step_size=0.02)
        back, _ = odeint_fixed(stiffish_field, fwd, 1.0, 0.0, step_size=0.02)
        np.testing.assert_allclose(back, y0, rtol=1e-4, atol=1e-5)


class TestRK4:
    def test_exponential_decay(self):
        y0 = jnp.ones((4, 3)) * jnp.array([1.0, 2.0, -3.0])
        y1, stats = odeint_fixed(
            linear_field, y0, 0.0, 1.0, step_size=0.05, method="rk4"
        )
        np.testing.assert_allclose(y1, y0 * np.exp(-1.0), rtol=1e-6)
        assert int(stats.num_steps) == 20

    def test_fourth_order_convergence(self):
        # Halving the step must cut the error ~16x (order 4) on a
        # time-dependent field with a known solution.
        y0 = jnp.full((2, 1), 0.5)

        def field(t, y):
            return -y + jnp.sin(3.0 * t)[:, None]

        def exact(t):
            # y' = -y + sin(3t), y(0)=0.5 (integrating factor):
            c = 0.5 + 0.3
            return c * np.exp(-t) + (np.sin(3 * t) - 3 * np.cos(3 * t)) / 10.0

        # Steps large enough that the truncation error stays above f32
        # rounding noise (~1e-8; at h<=0.05 the error already hits it).
        errs = []
        for h in (0.5, 0.25, 0.125):
            y1, _ = odeint_fixed(field, y0, 0.0, 1.0, step_size=h, method="rk4")
            errs.append(abs(float(y1[0, 0]) - exact(1.0)))
        assert errs[0] / errs[1] > 12.0
        assert errs[1] / errs[2] > 12.0

    def test_backwards_roundtrip(self):
        y0 = jax.random.normal(jax.random.PRNGKey(0), (3, 5))
        fwd, _ = odeint_fixed(
            stiffish_field, y0, 0.0, 1.0, step_size=0.02, method="rk4"
        )
        back, _ = odeint_fixed(
            stiffish_field, fwd, 1.0, 0.0, step_size=0.02, method="rk4"
        )
        np.testing.assert_allclose(back, y0, rtol=1e-4, atol=1e-5)

    def test_unknown_method_raises(self):
        with pytest.raises(ValueError, match="unknown fixed-step method"):
            odeint_fixed(linear_field, jnp.ones((1, 1)), 0.0, 1.0, method="rk45")


class TestAdaptive:
    def test_exponential_decay(self):
        y0 = jnp.ones((4, 3)) * jnp.array([1.0, 2.0, -3.0])
        y1, stats = odeint_adaptive(linear_field, y0, 0.0, 1.0, rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(y1, y0 * np.exp(-1.0), rtol=1e-5)
        assert int(stats.num_steps) > 0

    def test_vs_scipy(self):
        from scipy.integrate import solve_ivp

        def np_field(t, y):
            y = y.reshape(1, -1)
            return np.asarray(
                stiffish_field(np.array([t]), y)
            ).reshape(-1)

        y0 = np.array([[0.5, -1.2, 2.0]])
        ref = solve_ivp(
            np_field, (0.0, 1.0), y0[0], method="RK45", rtol=1e-8, atol=1e-10
        ).y[:, -1]
        ours, _ = odeint_adaptive(
            stiffish_field, jnp.asarray(y0), 0.0, 1.0, rtol=1e-6, atol=1e-8
        )
        np.testing.assert_allclose(ours[0], ref, rtol=1e-4, atol=1e-6)

    def test_per_sample_scales(self):
        # Samples with very different magnitudes must each meet tolerance.
        y0 = jnp.array([[1e-3], [1.0], [1e3]])
        y1, _ = odeint_adaptive(linear_field, y0, 0.0, 2.0, rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(y1, y0 * np.exp(-2.0), rtol=1e-5)

    def test_backwards(self):
        y0 = jnp.full((2, 4), 0.3)
        y1, _ = odeint_adaptive(linear_field, y0, 1.0, 0.0, rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(y1, y0 * np.exp(1.0), rtol=1e-5)

    def test_time_dependent_field(self):
        # dy/dt = 2t -> y(1) = y0 + 1.
        def f(t, y):
            return jnp.broadcast_to((2.0 * t)[:, None], y.shape)

        y0 = jnp.zeros((3, 2))
        y1, _ = odeint_adaptive(f, y0, 0.0, 1.0)
        np.testing.assert_allclose(y1, np.ones((3, 2)), rtol=1e-5)

    def test_diverged_samples_freeze_promptly(self):
        """A sample whose field blows up must not grind to max_steps."""

        def exploding(t, y):
            # Sample 0 explodes hard; sample 1 is benign.
            rate = jnp.array([[200.0], [0.1]])
            return rate * y * y  # finite-time blow-up for y0 > 0

        y0 = jnp.array([[5.0], [0.5]])
        y1, stats = odeint_adaptive(
            exploding, y0, 0.0, 1.0, rtol=1e-5, atol=1e-5, max_steps=512
        )
        # The benign sample still integrates correctly: dy/dt = 0.1 y^2.
        expected = 0.5 / (1.0 - 0.05)
        np.testing.assert_allclose(y1[1], expected, rtol=1e-4)
        # The diverged sample ends non-finite and the loop exits well before
        # max_steps (frozen, not force-accepted at dtmin forever).
        assert not np.all(np.isfinite(y1[0]))
        assert int(stats.num_attempts) < 512

    def test_jit_under_jit(self):
        @jax.jit
        def run(y0):
            y1, _ = odeint_adaptive(linear_field, y0, 0.0, 1.0)
            return y1

        y0 = jnp.ones((2, 2))
        np.testing.assert_allclose(run(y0), y0 * np.exp(-1.0), rtol=1e-4)

    def test_max_steps_exhaustion_yields_nan(self):
        """A solve truncated by max_steps must NOT return a silently-wrong
        mid-trajectory state (found with f32 + unattainable tolerances:
        every step rejected down to dtmin until the budget ran out, and
        the truncated state looked like a plausible answer)."""
        y0 = jnp.ones((3, 2))
        y1, stats = odeint_adaptive(
            linear_field, y0, 0.0, 1.0, rtol=1e-6, atol=1e-8, max_steps=3
        )
        assert int(stats.num_attempts) == 3
        assert not np.any(np.isfinite(np.asarray(y1)))
        # With a sufficient budget the same solve is exact and finite.
        y1_ok, _ = odeint_adaptive(linear_field, y0, 0.0, 1.0, rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(y1_ok, y0 * np.exp(-1.0), rtol=1e-5)


class TestDivergence:
    def _field(self):
        W = jax.random.normal(jax.random.PRNGKey(0), (6, 6))

        def f(x):
            return jnp.tanh(x @ W) + 0.5 * x

        return f, W

    def test_exact_matches_jacobian(self):
        f, W = self._field()
        x = jax.random.normal(jax.random.PRNGKey(1), (5, 6))
        div = exact_divergence(f, x)
        for i in range(5):
            J = jax.jacfwd(lambda v: f(v[None])[0])(x[i])
            np.testing.assert_allclose(div[i], jnp.trace(J), rtol=1e-5)

    def test_exact_chunked(self):
        f, _ = self._field()
        x = jax.random.normal(jax.random.PRNGKey(2), (4, 6))
        np.testing.assert_allclose(
            exact_divergence(f, x, column_chunk=4),
            exact_divergence(f, x),
            rtol=1e-5,
        )

    def test_sharded_columns_match_unsharded(self):
        from ecnf_jax.ops.divergence import sharded_value_and_exact_divergence
        from ecnf_jax.parallel import get_mesh

        f, _ = self._field()
        x = jax.random.normal(jax.random.PRNGKey(5), (3, 6))
        mesh = get_mesh()  # 8 devices; D=6 pads to 8 columns
        v_ref, div_ref = jax.jit(lambda xb: (f(xb), exact_divergence(f, xb)))(x)
        v, div = jax.jit(
            lambda xb: sharded_value_and_exact_divergence(f, xb, mesh)
        )(x)
        np.testing.assert_allclose(v, v_ref, rtol=1e-5)
        np.testing.assert_allclose(div, div_ref, rtol=1e-5)

    def test_2d_mesh_batch_and_columns(self):
        from ecnf_jax.ops.divergence import sharded_value_and_exact_divergence
        from ecnf_jax.parallel import get_mesh_2d, DATA_AXIS, TRACE_AXIS

        f, _ = self._field()
        x = jax.random.normal(jax.random.PRNGKey(6), (4, 6))
        mesh = get_mesh_2d(n_data=2, n_trace=4)  # 4 samples / 2, 6 cols -> 8 / 4
        v_ref, div_ref = f(x), exact_divergence(f, x)
        v, div = jax.jit(
            lambda xb: sharded_value_and_exact_divergence(
                f, xb, mesh, axis_name=TRACE_AXIS, batch_axis=DATA_AXIS
            )
        )(x)
        np.testing.assert_allclose(v, v_ref, rtol=1e-5)
        np.testing.assert_allclose(div, div_ref, rtol=1e-5)

    def test_sharded_columns_in_log_prob_solve(self):
        """The sharded trace composes with the full reverse ODE solve."""
        from ecnf_jax.cnf.build import build_mlp_cnf
        from ecnf_jax.cnf.sampling import get_log_prob, SolveConfig
        from ecnf_jax.parallel import get_mesh

        cnf = build_mlp_cnf(dim=2, sigma_min=0.01, base_scale=1.0, features=(16,))
        params = cnf.init(
            jax.random.PRNGKey(0),
            jnp.zeros((1, 2)),
            jnp.zeros((1,)),
            None,
        )
        x = jax.random.normal(jax.random.PRNGKey(1), (4, 2))
        cfg = SolveConfig(use_fixed_step_size=True, step_size=0.1)
        args = dict(cfg=cfg, key=jax.random.PRNGKey(2))
        ref = get_log_prob(cnf, params, x, **args)
        shd = get_log_prob(cnf, params, x, trace_mesh=get_mesh(), **args)
        np.testing.assert_allclose(shd[0], ref[0], rtol=1e-4, atol=1e-5)

    def test_hutchinson_unbiased(self):
        f, _ = self._field()
        x = jax.random.normal(jax.random.PRNGKey(3), (2, 6))
        exact = exact_divergence(f, x)
        keys = jax.random.split(jax.random.PRNGKey(4), 2000)
        ests = jax.vmap(
            lambda k: hutchinson_divergence(f, x, jax.random.normal(k, x.shape))
        )(keys)
        np.testing.assert_allclose(jnp.mean(ests, axis=0), exact, rtol=0.1)

    def test_hutchpp_exact_for_low_rank_jacobian(self):
        # When the sketch covers the Jacobian's range, the residual
        # operator (I-P) J (I-P) is zero and Hutch++ is *deterministic*:
        # tr(Q^T J Q) alone equals tr(J), for any probes.
        from ecnf_jax.ops.divergence import value_and_hutchpp_divergence

        D, r = 12, 3
        U = jax.random.normal(jax.random.PRNGKey(0), (D, r))
        V = jax.random.normal(jax.random.PRNGKey(1), (r, D))
        W = U @ V  # rank 3
        f = lambda xb: xb @ W.T
        x = jax.random.normal(jax.random.PRNGKey(2), (4, D))
        exact = jnp.full((4,), jnp.trace(W))
        for seed in range(3):
            k1, k2 = jax.random.split(jax.random.PRNGKey(10 + seed))
            sketch = jax.random.normal(k1, (4, 4, D))  # m1=4 >= rank
            probes = jax.random.normal(k2, (2, 4, D))
            _, div = value_and_hutchpp_divergence(f, x, sketch, probes)
            np.testing.assert_allclose(div, exact, rtol=1e-4, atol=1e-4)
            # Pure-sketch form (no residual probes): also exact here, and
            # must not NaN on the empty probe axis.
            _, div0 = value_and_hutchpp_divergence(
                f, x, sketch, jnp.zeros((0, 4, D))
            )
            np.testing.assert_allclose(div0, exact, rtol=1e-4, atol=1e-4)

    def test_hutchpp_unbiased_and_lower_variance(self):
        # Decaying-spectrum Jacobian: at a matched JVP budget Hutch++
        # (2*m1 + m2 JVPs) must beat plain Hutchinson (K JVPs) on RMSE.
        from ecnf_jax.ops.divergence import (
            value_and_hutchpp_divergence,
            value_and_multi_probe_hutchinson,
        )

        D = 16
        Q, _ = jnp.linalg.qr(jax.random.normal(jax.random.PRNGKey(0), (D, D)))
        lam = 2.0 ** (-jnp.arange(D, dtype=jnp.float32))  # fast decay
        W = (Q * lam) @ Q.T
        f = lambda xb: xb @ W.T
        x = jnp.zeros((1, D))
        exact = float(jnp.trace(W))

        def hpp(k):
            k1, k2 = jax.random.split(k)
            return value_and_hutchpp_divergence(
                f, x,
                jax.random.normal(k1, (4, 1, D)),
                jax.random.normal(k2, (4, 1, D)),
            )[1][0]

        def plain(k):
            return value_and_multi_probe_hutchinson(
                f, x, jax.random.normal(k, (12, 1, D))
            )[1][0]

        keys = jax.random.split(jax.random.PRNGKey(5), 400)
        e_pp = jax.vmap(hpp)(keys)
        e_pl = jax.vmap(plain)(keys)
        np.testing.assert_allclose(jnp.mean(e_pp), exact, rtol=0.05)
        rmse_pp = float(jnp.sqrt(jnp.mean((e_pp - exact) ** 2)))
        rmse_pl = float(jnp.sqrt(jnp.mean((e_pl - exact) ** 2)))
        assert rmse_pp < 0.5 * rmse_pl, (rmse_pp, rmse_pl)

    def test_hutchpp_in_log_prob_solve(self):
        # End-to-end dispatch: hutchpp_sketch>0 routes the approx solve
        # through Hutch++; finite result, unbiased across keys vs exact.
        from ecnf_jax.cnf.build import build_mlp_cnf
        from ecnf_jax.cnf.sampling import get_log_prob, SolveConfig

        cnf = build_mlp_cnf(dim=4, sigma_min=0.01, base_scale=1.0, features=(16,))
        x = jax.random.normal(jax.random.PRNGKey(0), (6, 4)) * 0.5
        params = cnf.init(jax.random.PRNGKey(1), x[:2], jnp.zeros(2))
        fixed = dict(use_fixed_step_size=True, step_size=0.2)
        exact_lp = get_log_prob(
            cnf, params, x, jax.random.PRNGKey(2), cfg=SolveConfig(**fixed)
        )[0]
        cfg = SolveConfig(hutchpp_sketch=2, hutchinson_probes=2, **fixed)
        lps = jnp.stack([
            get_log_prob(cnf, params, x, jax.random.PRNGKey(k), approx=True, cfg=cfg)[0]
            for k in range(24)
        ])
        assert np.isfinite(np.asarray(lps)).all()
        np.testing.assert_allclose(
            jnp.mean(lps, axis=0), exact_lp, rtol=0.05, atol=0.05
        )


class TestExactTracePlan:
    """The EGNN structural trace shortcut (`FlowMatchingCNF.exact_trace_plan`):
    JVPs on the zero-CoM basis + analytic ``-dim * final_scaling`` translation
    term must reproduce the full identity-basis trace exactly."""

    N, DIM = 5, 3

    def _cnf_and_params(self, final_scaling=1.37):
        from ecnf_jax.cnf.build import build_cnf

        cnf = build_cnf(
            n_frames=self.N, dim=self.DIM, sigma_min=0.01, base_scale=1.0,
            n_blocks_egnn=2, mlp_units=(16, 16), n_invariant_feat_hidden=8,
            time_embedding_dim=4, n_features=1,
        )
        B = 3
        feats = jnp.zeros((B, self.N), dtype=jnp.int32)
        x = jax.random.normal(jax.random.PRNGKey(0), (B, self.N * self.DIM))
        params = cnf.init(jax.random.PRNGKey(1), x[:2], jnp.zeros(2), feats[:2])
        # Non-trivial final_scaling so the analytic term is exercised.
        params = jax.tree_util.tree_map(lambda a: a, params)
        params["params"]["EGNN_0"]["final_scaling"] = jnp.asarray(final_scaling)
        return cnf, params, x, feats

    def test_zero_com_basis_orthonormal_and_complete(self):
        from ecnf_jax.ops.divergence import zero_com_trace_basis

        basis = zero_com_trace_basis(self.N, self.DIM)  # [12, 15]
        K, D = basis.shape
        assert (K, D) == ((self.N - 1) * self.DIM, self.N * self.DIM)
        np.testing.assert_allclose(basis @ basis.T, np.eye(K), atol=1e-6)
        # Rows are orthogonal to every uniform-translation direction.
        for d in range(self.DIM):
            u = np.zeros((self.N, self.DIM))
            u[:, d] = 1.0 / np.sqrt(self.N)
            np.testing.assert_allclose(basis @ u.reshape(-1), 0.0, atol=1e-6)

    def test_egnn_translation_is_exact_eigenvector(self):
        """f(x + 1(x)delta) - f(x) = -final_scaling * 1(x)delta, exactly the
        structure the analytic trace term relies on."""
        cnf, params, x, feats = self._cnf_and_params()
        t = jnp.full((x.shape[0],), 0.3)
        s = params["params"]["EGNN_0"]["final_scaling"]
        for d in range(self.DIM):
            u = np.zeros((self.N, self.DIM), np.float32)
            u[:, d] = 1.0
            u = jnp.asarray(u.reshape(-1))
            tangent = jnp.broadcast_to(u, x.shape)
            _, jv = jax.jvp(lambda xb: cnf.apply(params, xb, t, feats), (x,), (tangent,))
            np.testing.assert_allclose(jv, -s * tangent, rtol=1e-5, atol=1e-5)

    def test_plan_trace_matches_full_trace(self):
        from ecnf_jax.ops.divergence import value_and_exact_divergence

        cnf, params, x, feats = self._cnf_and_params()
        t = jnp.full((x.shape[0],), 0.7)
        f = lambda xb: cnf.apply(params, xb, t, feats)
        basis, offset = cnf.exact_trace_plan(params)
        v_full, div_full = value_and_exact_divergence(f, x)
        v_plan, div_plan = value_and_exact_divergence(
            f, x, basis=basis, trace_offset=offset
        )
        np.testing.assert_allclose(v_plan, v_full, rtol=1e-6)
        np.testing.assert_allclose(div_plan, div_full, rtol=1e-5, atol=1e-5)

    def test_log_prob_plan_on_equals_off(self):
        from ecnf_jax.cnf.sampling import SolveConfig, get_log_prob

        cnf, params, x, feats = self._cnf_and_params()
        key = jax.random.PRNGKey(3)
        cfg_on = SolveConfig(use_fixed_step_size=True, step_size=0.25)
        cfg_off = SolveConfig(
            use_fixed_step_size=True, step_size=0.25, use_exact_trace_plan=False
        )
        lp_on, _, _ = get_log_prob(cnf, params, x, key, feats, cfg=cfg_on)
        lp_off, _, _ = get_log_prob(cnf, params, x, key, feats, cfg=cfg_off)
        np.testing.assert_allclose(lp_on, lp_off, rtol=1e-5, atol=1e-4)

    def test_sharded_columns_with_plan_basis(self):
        from ecnf_jax.ops.divergence import (
            sharded_value_and_exact_divergence,
            value_and_exact_divergence,
        )
        from ecnf_jax.parallel import get_mesh

        cnf, params, x, feats = self._cnf_and_params()
        t = jnp.full((x.shape[0],), 0.5)
        f = lambda xb: cnf.apply(params, xb, t, feats)
        basis, offset = cnf.exact_trace_plan(params)
        mesh = get_mesh()  # 8 devices; 12 basis rows pad to 16
        _, div_ref = value_and_exact_divergence(f, x)
        _, div = jax.jit(
            lambda xb: sharded_value_and_exact_divergence(
                f, xb, mesh, basis=basis, trace_offset=offset
            )
        )(x)
        np.testing.assert_allclose(div, div_ref, rtol=1e-5, atol=1e-5)


class TestDispatch:
    def test_odeint_dispatch(self):
        y0 = jnp.ones((2, 2))
        yf, _ = odeint(linear_field, y0, 0.0, 1.0, use_fixed_step_size=True)
        ya, _ = odeint(linear_field, y0, 0.0, 1.0, use_fixed_step_size=False)
        np.testing.assert_allclose(yf, ya, rtol=1e-4)
