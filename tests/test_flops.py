"""FLOP counter (`ops/flops.py`) used for MFU reporting in bench.py.

Pins: dot_general formula (batched + plain), dtype bucketing, control-flow
recursion (scan x length, while flagged, cond max), and a trace of the real
LJ13 headline solve landing in the range a hand FLOP model derives.
"""
import jax
import jax.numpy as jnp
import pytest

from ecnf_jax.ops.flops import FlopCount, count_fn_flops, mfu


class TestDotGeneral:
    def test_plain_matmul_f32(self):
        def f(a, b):
            return a @ b

        a = jnp.zeros((8, 16))
        b = jnp.zeros((16, 32))
        c = count_fn_flops(f, a, b)
        assert c.f32 == 2 * 8 * 16 * 32
        assert c.bf16 == 0
        assert not c.has_while

    def test_bf16_bucket(self):
        def f(a, b):
            return a @ b

        a = jnp.zeros((8, 16), jnp.bfloat16)
        b = jnp.zeros((16, 32), jnp.bfloat16)
        c = count_fn_flops(f, a, b)
        assert c.bf16 == 2 * 8 * 16 * 32
        assert c.f32 == 0

    def test_mixed_dtype_counts_as_f32(self):
        def f(a, b):
            return jax.lax.dot_general(
                a, b, (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            )

        a = jnp.zeros((4, 8), jnp.bfloat16)
        b = jnp.zeros((8, 4), jnp.float32)
        c = count_fn_flops(f, a, b)
        assert c.f32 == 2 * 4 * 8 * 4

    def test_batched_einsum(self):
        def f(a, b):
            return jnp.einsum("bij,bjk->bik", a, b)

        a = jnp.zeros((5, 8, 16))
        b = jnp.zeros((5, 16, 32))
        c = count_fn_flops(f, a, b)
        assert c.total == 2 * 5 * 8 * 16 * 32


class TestControlFlow:
    def test_scan_multiplies_by_length(self):
        w = jnp.zeros((16, 16))

        def f(x):
            def body(carry, _):
                return carry @ w, None

            y, _ = jax.lax.scan(body, x, None, length=7)
            return y

        c = count_fn_flops(f, jnp.zeros((4, 16)))
        assert c.total == 7 * 2 * 4 * 16 * 16

    def test_while_flagged_not_scaled(self):
        w = jnp.zeros((16, 16))

        def f(x):
            def cond(s):
                return s[0] < 3

            def body(s):
                i, y = s
                return i + 1, y @ w

            return jax.lax.while_loop(cond, body, (0, x))

        c = count_fn_flops(f, jnp.zeros((4, 16)))
        assert c.has_while
        assert c.total == 2 * 4 * 16 * 16  # body counted once

    def test_cond_takes_max_branch(self):
        w = jnp.zeros((16, 16))

        def f(p, x):
            return jax.lax.cond(
                p, lambda y: (y @ w) @ w, lambda y: y @ w, x
            )

        c = count_fn_flops(f, True, jnp.zeros((4, 16)))
        assert c.total == 2 * (2 * 4 * 16 * 16)

    def test_jit_recursed(self):
        w = jnp.zeros((16, 16))

        @jax.jit
        def g(x):
            return x @ w

        c = count_fn_flops(lambda x: g(g(x)), jnp.zeros((4, 16)))
        assert c.total == 2 * (2 * 4 * 16 * 16)


H100 = "NVIDIA H100 80GB HBM3"


class TestMfu:
    def test_unknown_device_none(self):
        assert mfu(FlopCount(f32=1e12), 1.0, "cpu") is None
        # No peak is assumed for a kind that is not in the table.
        assert mfu(FlopCount(bf16=1e12), 1.0, "NVIDIA H100 PCIe") is None

    def test_while_none(self):
        assert mfu(FlopCount(bf16=1e12, has_while=True), 1.0, H100) is None

    def test_h100_value(self):
        # 989e12 bf16 FLOPs in 2 s on one H100 -> 50% MFU.
        got = mfu(FlopCount(bf16=989e12), 2.0, H100)
        assert got == pytest.approx(0.5)

    def test_mixed_roofline(self):
        # f32 FLOPs run at the TF32 peak, half the bf16 rate.
        got = mfu(FlopCount(bf16=989e12 / 2, f32=495e12 / 2), 1.0, H100)
        assert got == pytest.approx(0.5 + 0.5)


class TestHeadlineProgram:
    def test_lj13_solve_flops_match_perf_model(self):
        """Trace (no compile) the real LJ13 exact-logprob rk4 solve and
        check the counted FLOPs agree with a hand model:
        ~37 network streams x O(10^8) FLOP/sample x B x 80 rk4 stages."""
        from ecnf_jax.cnf.build import build_cnf
        from ecnf_jax.cnf.sampling import SolveConfig, sample_and_log_prob_cnf

        B = 8
        cnf = build_cnf(
            n_frames=13, dim=3, sigma_min=0.01, base_scale=1.0,
            n_blocks_egnn=3, mlp_units=(128, 128, 128),
            n_invariant_feat_hidden=64, time_embedding_dim=8, n_features=1,
            compute_dtype="bfloat16",
        )
        feats = jnp.zeros((B, 13), dtype=jnp.int32)
        x0 = jnp.zeros((2, 39))
        params = cnf.init(jax.random.PRNGKey(0), x0, jnp.zeros(2), feats[:2])
        cfg = SolveConfig(use_fixed_step_size=True, step_size=0.05, method="rk4")

        def run(key):
            return sample_and_log_prob_cnf(
                cnf, params, key, B, features=feats, approx=False, cfg=cfg
            )

        c = count_fn_flops(run, jax.random.PRNGKey(0))
        assert not c.has_while
        # 20 rk4 steps x 4 stages = 80 field evals; 37 streams
        # (primal + 36 zero-CoM trace columns); the hand model puts one
        # stream at ~84-133 MFLOP/sample -> total in [1.5e13, 5e13] at B=8.
        per_stream_sample = c.total / 80 / 37 / B
        assert 4e7 < per_stream_sample < 2.5e8, per_stream_sample
        # The MLP stack dominates and runs in bf16.
        assert c.bf16 > 0.8 * c.total
