"""Training tests: update step, EMA, whole-epoch sharded runner, MoG e2e.

The MoG end-to-end test is the framework's answer to the reference's manual
"run MoG_target.py and look at the KL" validation (`MoG_target.py:140-202`):
a tiny CNF must drive the test NLL toward the target entropy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ecnf_jax.cnf.build import build_mlp_cnf, build_cnf
from ecnf_jax.cnf.sampling import SolveConfig, get_log_prob, sample_cnf
from ecnf_jax.targets.mog import MoGTarget
from ecnf_jax.training.state import init_training_state, make_update_fn
from ecnf_jax.training.optim import build_optimizer
from ecnf_jax.training.evaluation import (
    calculate_forward_ess,
    calculate_reverse_ess,
    setup_padded_reshaped_data,
    eval_fn,
)
from ecnf_jax.parallel.mesh import get_mesh, replicated, data_sharded


class TestUpdateStep:
    def _setup(self, use_ema=False):
        cnf = build_mlp_cnf(dim=2, sigma_min=1e-4, base_scale=5.0, features=(16, 16))
        opt = build_optimizer(1e-3, use_schedule=False)
        state = init_training_state(
            cnf,
            opt,
            jax.random.PRNGKey(0),
            example_x=jnp.zeros((2, 2)),
            use_ema=use_ema,
        )
        update = make_update_fn(cnf, opt, use_ema=use_ema)
        return cnf, state, update

    def test_loss_decreases(self):
        cnf, state, update = self._setup()
        target = MoGTarget()
        data = target.sample(jax.random.PRNGKey(1), (256,))
        losses = []
        for _ in range(20):
            state, info = update(state, data, None)
            losses.append(float(info["loss"]))
        assert losses[-1] < losses[0]
        assert np.isfinite(losses).all()

    def test_info_keys(self):
        cnf, state, update = self._setup()
        data = jax.random.normal(jax.random.PRNGKey(2), (8, 2))
        _, info = update(state, data, None)
        assert set(info.keys()) == {"loss", "grad_norm", "update_norm"}

    def test_ema_tracks_params(self):
        cnf, state, update = self._setup(use_ema=True)
        data = jax.random.normal(jax.random.PRNGKey(3), (8, 2))
        state1, _ = update(state, data, None)
        # EMA must move toward new params but stay close to the old ones.
        leaf = lambda t: jax.tree_util.tree_leaves(t)[0]
        p0, e0 = leaf(state.params), leaf(state.ema_params)
        p1, e1 = leaf(state1.params), leaf(state1.ema_params)
        np.testing.assert_allclose(e1, e0 * 0.999 + p1 * 0.001, rtol=1e-5, atol=1e-7)

    def test_no_ema_is_none(self):
        cnf, state, update = self._setup(use_ema=False)
        assert state.ema_params is None
        data = jax.random.normal(jax.random.PRNGKey(4), (8, 2))
        state1, _ = update(state, data, None)
        assert state1.ema_params is None


class TestShardedStep:
    def test_update_on_mesh(self):
        """The same update step must run sharded over the 8-device mesh and
        agree numerically with the single-device step."""
        mesh = get_mesh()
        assert mesh.devices.size == 8, "conftest must expose 8 CPU devices"
        cnf = build_mlp_cnf(dim=2, sigma_min=1e-4, base_scale=5.0, features=(16, 16))
        opt = build_optimizer(1e-3, use_schedule=False)
        state = init_training_state(
            cnf, opt, jax.random.PRNGKey(0), example_x=jnp.zeros((2, 2))
        )
        data = jax.random.normal(jax.random.PRNGKey(1), (64, 2))

        update_plain = make_update_fn(cnf, opt)
        update_mesh = make_update_fn(cnf, opt, mesh=mesh)

        s1, i1 = update_plain(state, data, None)
        data_sharded_arr = jax.device_put(data, data_sharded(mesh))
        state_rep = jax.device_put(state, replicated(mesh))
        s2, i2 = update_mesh(state_rep, data_sharded_arr, None)

        np.testing.assert_allclose(float(i1["loss"]), float(i2["loss"]), rtol=1e-5)
        for a, b in zip(
            jax.tree_util.tree_leaves(s1.params), jax.tree_util.tree_leaves(s2.params)
        ):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6)

    def test_egnn_update_on_mesh(self):
        """Full EGNN CNF train step sharded over the mesh."""
        mesh = get_mesh()
        cnf = build_cnf(
            n_frames=4,
            dim=2,
            sigma_min=0.01,
            base_scale=1.0,
            n_blocks_egnn=2,
            mlp_units=(16,),
            n_invariant_feat_hidden=8,
            time_embedding_dim=6,
            n_features=1,
        )
        opt = build_optimizer(1e-4, use_schedule=False)
        x = jax.random.normal(jax.random.PRNGKey(0), (16, 8))
        feats = jnp.zeros((16, 4), dtype=jnp.int32)
        state = init_training_state(
            cnf, opt, jax.random.PRNGKey(1), example_x=x[:2], example_features=feats[:2]
        )
        update = make_update_fn(cnf, opt, mesh=mesh)
        state = jax.device_put(state, replicated(mesh))
        xs = jax.device_put(x, data_sharded(mesh))
        fs = jax.device_put(feats, data_sharded(mesh))
        state, info = update(state, xs, fs)
        assert np.isfinite(float(info["loss"]))


class TestEvaluation:
    def test_forward_ess_uniform_weights(self):
        log_w = jnp.zeros(100)
        mask = jnp.ones(100, dtype=jnp.int32)
        info = calculate_forward_ess(log_w, mask)
        np.testing.assert_allclose(float(info["forward_ess"]), 1.0, rtol=1e-5)

    def test_reverse_ess_uniform_weights(self):
        log_w = jnp.zeros(100)
        np.testing.assert_allclose(float(calculate_reverse_ess(log_w)), 1.0, rtol=1e-5)

    def test_forward_ess_degenerate(self):
        # One dominant weight -> ESS ~ 1/n.
        log_w = jnp.array([100.0] + [0.0] * 99)
        mask = jnp.ones(100, dtype=jnp.int32)
        ess = float(calculate_forward_ess(log_w, mask)["forward_ess"])
        assert ess < 0.05

    def test_ess_masks_non_finite_weights(self):
        # NaN-frozen diverged/budget-exhausted ODE samples (`ops/ode.py`)
        # yield non-finite log-weights; they must be excluded, not poison
        # the aggregate (reference `evaluation.py:15` semantics).
        log_w = jnp.array([0.0, 0.0, jnp.nan, -jnp.inf, 0.0])
        mask = jnp.ones(5, dtype=jnp.int32)
        ess = float(calculate_forward_ess(log_w, mask)["forward_ess"])
        np.testing.assert_allclose(ess, 1.0, rtol=1e-5)  # 3 finite, uniform
        rv = float(calculate_reverse_ess(jnp.array([0.0, jnp.nan, 0.0, 0.0])))
        assert np.isfinite(rv)
        # Non-finite entries get zero weight; n stays the full count.
        np.testing.assert_allclose(rv, (1.0 / (3 * (1 / 3) ** 2)) / 4, rtol=1e-5)

    def test_padded_reshape(self):
        data = jnp.arange(10.0)
        reshaped, mask = setup_padded_reshaped_data(data, 4, reshape_axis=1)
        assert reshaped.shape == (3, 4)
        assert mask.shape == (3, 4)
        assert int(mask.sum()) == 10

    def test_eval_fn_scan_and_loop_agree(self):
        """The host-loop eval (default) must match the scanned variant."""
        data = jnp.arange(20.0)

        def batch_fn(x, key, mask):
            s = jnp.where(mask, x, 0.0).sum() / jnp.maximum(mask.sum(), 1)
            return {"m": s, "rand": jax.random.uniform(key)}

        info_loop, _, _ = eval_fn(
            data, jax.random.PRNGKey(0), eval_on_test_batch_fn=batch_fn,
            batch_size=6, use_scan=False,
        )
        info_scan, _, _ = eval_fn(
            data, jax.random.PRNGKey(0), eval_on_test_batch_fn=batch_fn,
            batch_size=6, use_scan=True,
        )
        for k in info_loop:
            np.testing.assert_allclose(
                float(info_loop[k]), float(info_scan[k]), rtol=1e-6
            )

    def test_eval_fn_scan_chunk_agrees_with_loop(self):
        """Bounded-chunk dispatch (scan_chunk=G + a chunk fn) must
        reproduce the host loop exactly — same per-batch keys — including
        a further-info (log-weights) path and a non-divisible remainder.
        The chunk fn follows the production contract
        (`training/setup.py:_eval_data_chunk`): one jit, scanning the
        per-batch fn over the chunk."""
        data = jnp.arange(20.0)

        def batch_fn(x, key, mask):
            s = jnp.where(mask, x, 0.0).sum() / jnp.maximum(mask.sum(), 1)
            return x * 2.0, {"m": s, "rand": jax.random.uniform(key)}

        chunk_fn = jax.jit(
            lambda xg, kg, mg: jax.lax.map(
                lambda t: batch_fn(t[0], key=t[1], mask=t[2]), (xg, kg, mg)
            )
        )

        results = {}
        for name, kw in [
            ("loop", dict(use_scan=False)),
            # scan_chunk without a chunk fn falls back to the host loop.
            ("chunk_nofn", dict(scan_chunk=2)),
            ("chunk2", dict(scan_chunk=2, eval_on_test_chunk_fn=chunk_fn)),
            ("chunk3", dict(scan_chunk=3, eval_on_test_chunk_fn=chunk_fn)),
            ("chunk99", dict(scan_chunk=99, eval_on_test_chunk_fn=chunk_fn)),
        ]:
            results[name] = eval_fn(
                data, jax.random.PRNGKey(0), eval_on_test_batch_fn=batch_fn,
                batch_size=6, **kw,
            )
        info_loop, further_loop, mask_loop = results["loop"]
        for name in ("chunk_nofn", "chunk2", "chunk3", "chunk99"):
            info, further, mask = results[name]
            for k in info_loop:
                np.testing.assert_allclose(
                    float(info_loop[k]), float(info[k]), rtol=1e-6, err_msg=name
                )
            np.testing.assert_allclose(
                np.asarray(further_loop), np.asarray(further), err_msg=name
            )
            np.testing.assert_array_equal(
                np.asarray(mask_loop), np.asarray(mask)
            )

    def test_padded_reshape_axis0(self):
        data = jnp.arange(10.0)
        reshaped, mask = setup_padded_reshaped_data(data, 4, reshape_axis=0)
        assert reshaped.shape == (4, 3)
        assert int(mask.sum()) == 10

    def test_eval_fn_masked_mean_exact(self):
        """Padded entries must not bias the aggregated metrics."""
        data = jnp.arange(10.0)

        def batch_fn(x, key, mask):
            s = jnp.where(mask, x, 0.0).sum() / jnp.maximum(mask.sum(), 1)
            return {"mean_x": s}

        info, _, _ = eval_fn(
            data, jax.random.PRNGKey(0), eval_on_test_batch_fn=batch_fn, batch_size=4
        )
        np.testing.assert_allclose(float(info["mean_x"]), 4.5, rtol=1e-6)


@pytest.mark.slow
class TestMoGEndToEnd:
    def test_mog_learns(self):
        """~200 updates on MoG data should bring model NLL near target NLL."""
        target = MoGTarget()
        train = target.sample(jax.random.PRNGKey(0), (2048,))
        test = target.sample(jax.random.PRNGKey(1), (128,))

        cnf = build_mlp_cnf(dim=2, sigma_min=1e-4, base_scale=5.0, features=(64, 64))
        opt = build_optimizer(2e-3, use_schedule=False, optimizer_name="adamw")
        state = init_training_state(
            cnf, opt, jax.random.PRNGKey(2), example_x=train[:2]
        )
        update = make_update_fn(cnf, opt)

        key = jax.random.PRNGKey(3)
        for i in range(200):
            key, sk = jax.random.split(key)
            idx = jax.random.randint(sk, (128,), 0, train.shape[0])
            state, info = update(state, train[idx], None)

        log_q, _, _ = get_log_prob(cnf, state.params, test, jax.random.PRNGKey(4))
        target_lp = target.log_prob(test)
        kl = float(jnp.mean(target_lp - log_q))
        # Untrained model KL is O(10); trained should be clearly smaller.
        assert np.isfinite(kl)
        assert kl < 3.0, f"KL too large after training: {kl}"


class TestMicrobatch:
    """`microbatch=k` must implement grad = mean of k chunk grads with the
    per-chunk key split, then the identical optimizer/EMA path — a pure
    perf lever (docs/PERF.md "Train-step roofline")."""

    def _setup(self, microbatch=None, use_ema=True):
        cnf = build_mlp_cnf(dim=2, sigma_min=1e-4, base_scale=5.0,
                            features=(16, 16))
        opt = build_optimizer(1e-3, use_schedule=False)
        state = init_training_state(
            cnf, opt, jax.random.PRNGKey(0), example_x=jnp.zeros((2, 2)),
            use_ema=use_ema,
        )
        update = make_update_fn(cnf, opt, use_ema=use_ema,
                                microbatch=microbatch)
        return cnf, opt, state, update

    def test_matches_handrolled_mean_of_chunk_grads(self):
        import optax
        from ecnf_jax.cnf.loss import flow_matching_loss_fn

        cnf, opt, state, update = self._setup(microbatch=2)
        data = jax.random.normal(jax.random.PRNGKey(5), (8, 2))

        new_state, info = update(state, data, None)

        # Hand-rolled twin of the documented semantics.
        key, sub = jax.random.split(state.key)
        subs = jax.random.split(sub, 2)
        grads, losses = [], []
        for i in range(2):
            g, inf = jax.grad(flow_matching_loss_fn, argnums=1,
                              has_aux=True)(
                cnf, state.params, data[4 * i: 4 * (i + 1)], subs[i], None)
            grads.append(g)
            losses.append(inf["loss"])
        mean_g = jax.tree_util.tree_map(lambda a, b: (a + b) / 2, *grads)
        updates, _ = opt.update(mean_g, state.opt_state, params=state.params)
        expect_params = optax.apply_updates(state.params, updates)

        for a, b in zip(jax.tree_util.tree_leaves(new_state.params),
                        jax.tree_util.tree_leaves(expect_params)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(
            float(info["loss"]), float((losses[0] + losses[1]) / 2),
            rtol=1e-6)
        assert np.isfinite(float(info["grad_norm"]))
        assert np.isfinite(float(info["update_norm"]))

    def test_microbatch_one_bitwise_equals_default(self):
        _, _, state, update_mb1 = self._setup(microbatch=1)
        _, _, state2, update_none = self._setup(microbatch=None)
        data = jax.random.normal(jax.random.PRNGKey(6), (8, 2))
        s1, i1 = update_mb1(state, data, None)
        s2, i2 = update_none(state2, data, None)
        for a, b in zip(jax.tree_util.tree_leaves(s1.params),
                        jax.tree_util.tree_leaves(s2.params)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert float(i1["loss"]) == float(i2["loss"])

    def test_loss_decreases_with_microbatch(self):
        cnf, _, state, update = self._setup(microbatch=4, use_ema=False)
        target = MoGTarget()
        data = target.sample(jax.random.PRNGKey(1), (256,))
        losses = []
        for _ in range(60):
            state, info = update(state, data, None)
            losses.append(float(info["loss"]))
        # Per-chunk RNG draws make single losses noisy; compare means.
        assert np.mean(losses[-10:]) < np.mean(losses[:10])
        assert np.isfinite(losses).all()

    def test_features_chunked_not_broadcast(self):
        """Per-sample integer features must follow their samples into
        chunks (regression guard for the reshape-vs-slice distinction)."""
        cnf = build_cnf(
            n_frames=3, dim=2, sigma_min=0.01, base_scale=1.0,
            n_blocks_egnn=1, mlp_units=(8,), n_invariant_feat_hidden=4,
            time_embedding_dim=4, n_features=2,
        )
        opt = build_optimizer(1e-3, use_schedule=False)
        feats = jnp.asarray([[0, 0, 0]] * 2 + [[1, 1, 1]] * 2,
                            dtype=jnp.int32)
        x = jax.random.normal(jax.random.PRNGKey(7), (4, 6))
        state = init_training_state(
            cnf, opt, jax.random.PRNGKey(0), x[:2], feats[:2])
        update = make_update_fn(cnf, opt, microbatch=2)
        from ecnf_jax.cnf.loss import flow_matching_loss_fn
        new_state, info = update(state, x, feats)

        key, sub = jax.random.split(state.key)
        subs = jax.random.split(sub, 2)
        grads = []
        for i in range(2):
            g, _ = jax.grad(flow_matching_loss_fn, argnums=1,
                            has_aux=True)(
                cnf, state.params, x[2 * i: 2 * (i + 1)], subs[i],
                feats[2 * i: 2 * (i + 1)])
            grads.append(g)
        import optax
        mean_g = jax.tree_util.tree_map(lambda a, b: (a + b) / 2, *grads)
        updates, _ = opt.update(mean_g, state.opt_state, params=state.params)
        expect_params = optax.apply_updates(state.params, updates)
        for a, b in zip(jax.tree_util.tree_leaves(new_state.params),
                        jax.tree_util.tree_leaves(expect_params)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-6, atol=1e-7)
