"""The driver-facing bench suite (`bench.py`): dispatch, JSON shape,
and baseline bookkeeping (VERDICT r1 item 6, ADVICE r1 item 1).

The rates themselves are measured on the GPU (PERF.md); these tests pin
the *contract*: one JSON line on stdout with numeric
`metric/value/unit/vs_baseline`, extras attached in suite mode, per-(task,
method) baselines so vs_baseline always compares like with like, and env
knobs routed to the right sub-benchmarks.
"""
import importlib
import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import bench  # noqa: E402


def _reload(monkeypatch, **env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    return importlib.reload(bench)


@pytest.fixture(autouse=True)
def _restore_bench_module():
    yield
    importlib.reload(bench)


def _fake_rates(mod, monkeypatch, lj13=300.0, qm9=25.0, train=95.0):
    calls = []

    def fake_lj13(method, reps):
        calls.append(("lj13", method, reps))
        return lj13

    def fake_qm9(reps, method="dopri5"):
        calls.append(("qm9", method, reps))
        return qm9

    def fake_train(reps=3, n_steps=100):
        calls.append(("qm9_train", None, reps))
        return train

    monkeypatch.setattr(mod, "bench_lj13", fake_lj13)
    monkeypatch.setattr(mod, "bench_qm9_sample_logprob", fake_qm9)
    monkeypatch.setattr(mod, "bench_qm9_train_step", fake_train)
    return calls


def _run_main(mod, capsys):
    mod.main()
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, f"bench must print exactly one stdout line: {out}"
    return json.loads(out[0])


class TestSuiteMode:
    def test_suite_json_shape(self, monkeypatch, capsys):
        mod = _reload(monkeypatch, ECNF_BENCH_TASK="suite")
        calls = _fake_rates(mod, monkeypatch)
        rec = _run_main(mod, capsys)
        assert rec["metric"] == "lj13_sample_with_exact_logprob"
        assert rec["value"] == 300.0
        assert rec["unit"] == "samples/s/chip"
        assert isinstance(rec["vs_baseline"], (int, float))
        # rk4 headline -> dopri5 is the reference-stepper parity extra.
        assert set(rec["extras"]) == {
            "lj13_dopri5_reference_stepper",
            "qm9_sample_logprob_hutch4",
            "qm9_sample_logprob_hutch4_rk4",
            "qm9_train_step",
        }
        assert ("lj13", "rk4", mod.REPS) in calls
        assert ("lj13", "dopri5", 3) in calls
        assert ("qm9", "dopri5", 3) in calls
        assert ("qm9", "rk4", 3) in calls

    def test_vs_baseline_keyed_by_method(self, monkeypatch, capsys):
        """ADVICE r1: the ratio must compare like with like — the rk4
        headline and the dopri5 parity extra use different baselines."""
        mod = _reload(monkeypatch, ECNF_BENCH_TASK="suite")
        _fake_rates(mod, monkeypatch, lj13=300.0)
        rec = _run_main(mod, capsys)
        rk4_base = mod.CPU_BASELINES[("lj13", "rk4")]
        dopri5_base = mod.CPU_BASELINES[("lj13", "dopri5")]
        assert rec["vs_baseline"] == round(300.0 / rk4_base, 2)
        extra = rec["extras"]["lj13_dopri5_reference_stepper"]
        assert extra["vs_baseline"] == round(300.0 / dopri5_base, 2)
        assert rk4_base != dopri5_base  # distinct programs, distinct baselines

    def test_extra_failure_keeps_headline_and_is_machine_visible(
        self, monkeypatch, capsys
    ):
        """VERDICT r3 item 1: a crashed extra must not silently vanish
        from the JSON — it stays under its key with an `error` field."""
        mod = _reload(monkeypatch, ECNF_BENCH_TASK="suite")

        def boom(reps, method="dopri5"):
            raise RuntimeError("qm9 compile blew up")

        _fake_rates(mod, monkeypatch)
        monkeypatch.setattr(mod, "bench_qm9_sample_logprob", boom)
        rec = _run_main(mod, capsys)
        assert rec["metric"] == "lj13_sample_with_exact_logprob"
        failed = rec["extras"]["qm9_sample_logprob_hutch4"]
        assert failed == {"error": "RuntimeError: qm9 compile blew up"}
        assert "value" not in failed
        assert rec["extras"]["qm9_train_step"]["value"] == 95.0

    def test_extras_opt_out(self, monkeypatch, capsys):
        mod = _reload(monkeypatch, ECNF_BENCH_TASK="suite",
                      ECNF_BENCH_EXTRAS="0")
        calls = _fake_rates(mod, monkeypatch)
        rec = _run_main(mod, capsys)
        assert "extras" not in rec
        assert calls == [("lj13", "rk4", mod.REPS)]


class TestSingleTasks:
    def test_qm9_sample_task(self, monkeypatch, capsys):
        # The single task dispatches the env-selected METHOD (rk4 default)
        # and must quote the baseline for that same method.
        mod = _reload(monkeypatch, ECNF_BENCH_TASK="qm9_sample_logprob")
        _fake_rates(mod, monkeypatch, qm9=30.0)
        rec = _run_main(mod, capsys)
        assert rec["metric"] == "qm9_sample_logprob_hutch4"
        base = mod.CPU_BASELINES[("qm9_hutch4", mod.METHOD)]
        assert rec["vs_baseline"] == round(30.0 / base, 2)

    def test_qm9_train_task(self, monkeypatch, capsys):
        mod = _reload(monkeypatch, ECNF_BENCH_TASK="qm9_train_step")
        _fake_rates(mod, monkeypatch, train=88.0)
        rec = _run_main(mod, capsys)
        base = mod.CPU_BASELINES[("qm9_train_step", "")]
        assert rec == {"metric": "qm9_train_step", "value": 88.0,
                       "unit": "steps/s/chip",
                       "vs_baseline": round(88.0 / base, 2)}

    def test_headline_env_override(self, monkeypatch, capsys):
        mod = _reload(monkeypatch, ECNF_BENCH_TASK="lj13_sample_logprob",
                      ECNF_BENCH_BASELINE="2.0")
        _fake_rates(mod, monkeypatch, lj13=100.0)
        rec = _run_main(mod, capsys)
        assert rec["vs_baseline"] == 50.0


class TestDetailsSideChannel:
    def test_spread_and_mfu_merged_into_json(self, monkeypatch, capsys):
        """VERDICT r2 items 7-8: run-to-run spread and MFU ride in the
        same JSON line, attached to the metric they describe."""
        mod = _reload(monkeypatch, ECNF_BENCH_TASK="suite")
        _fake_rates(mod, monkeypatch, lj13=300.0)
        mod.DETAILS["lj13_rk4"] = {"spread_min": 290.0,
                                   "spread_median": 295.0,
                                   "reps": 5, "mfu": 0.31, "tflops": 1.2}
        mod.DETAILS["qm9_train_step"] = {"spread_min": 90.0,
                                         "spread_median": 93.0, "reps": 3}
        rec = _run_main(mod, capsys)
        assert rec["spread_min"] == 290.0
        assert rec["spread_median"] == 295.0
        assert rec["mfu"] == 0.31
        assert rec["value"] == 300.0  # best-of-reps stays the headline value
        train = rec["extras"]["qm9_train_step"]
        assert train["spread_median"] == 93.0

    def test_record_details_math(self, monkeypatch):
        """spread = rates from the rep times; MFU only for while-free
        counts on a known device."""
        from ecnf_jax.ops.flops import FlopCount, PEAKS

        import jax

        mod = _reload(monkeypatch)
        n_dev = jax.device_count()
        # 3 reps at 1.0/2.0/4.0 s for 48 samples; rates are per-chip.
        mod._record_details("t", [2.0, 1.0, 4.0], 48.0,
                            FlopCount(bf16=0.0, f32=1e12))
        det = mod.DETAILS["t"]
        assert det["spread_min"] == round(48.0 / 4.0 / n_dev, 2)   # worst rep
        assert det["spread_median"] == round(48.0 / 2.0 / n_dev, 2)
        assert det["reps"] == 3
        assert det["tflops"] == 1.0
        # Host CPU has no PEAKS entry -> no mfu key, but spread still there.
        import jax
        if jax.devices()[0].device_kind not in PEAKS:
            assert "mfu" not in det

    def test_while_loop_count_suppresses_mfu(self, monkeypatch):
        import jax

        from ecnf_jax.ops.flops import FlopCount

        mod = _reload(monkeypatch)
        mod._record_details("t2", [1.0], 48.0,
                            FlopCount(bf16=1e12, f32=0.0, has_while=True))
        assert "mfu" not in mod.DETAILS["t2"]
        # ADVICE r3: a one-trip while-body count must not masquerade as a
        # full-run FLOP total — it ships under a distinctly named key.
        assert "tflops" not in mod.DETAILS["t2"]
        assert mod.DETAILS["t2"]["tflops_one_trip"] == 1.0
        assert mod.DETAILS["t2"]["spread_min"] == round(
            48.0 / jax.device_count(), 2
        )


class TestBaselineTable:
    def test_all_dispatched_tasks_have_baselines(self):
        """Every (task, method) the suite quotes a ratio for must exist in
        the measured table; a missing entry silently reports 0.0."""
        for key in [("lj13", "rk4"), ("lj13", "dopri5"),
                    ("qm9_hutch4", "dopri5"), ("qm9_hutch4", "rk4"),
                    ("qm9_train_step", "")]:
            assert key in bench.CPU_BASELINES
            assert bench.CPU_BASELINES[key] > 0

    def test_missing_baseline_reports_zero(self):
        assert bench._vs(123.0, None) == 0.0
        assert bench._vs(123.0, bench._baseline("nope", "rk4")) == 0.0


class TestGpuOnly:
    """Cells measure on the GPU only: on the CPU they fail instead of
    reporting a host number under a device metric's name."""

    def test_require_gpu_refuses_cpu(self, monkeypatch):
        mod = _reload(monkeypatch)
        with pytest.raises(RuntimeError, match="need a GPU"):
            mod._require_gpu()

    def test_solve_cell_refuses_cpu(self, monkeypatch):
        mod = _reload(monkeypatch)
        with pytest.raises(RuntimeError, match="need a GPU"):
            mod.bench_lj13("rk4", reps=1)

    def test_train_cell_refuses_cpu(self, monkeypatch):
        mod = _reload(monkeypatch)
        with pytest.raises(RuntimeError, match="need a GPU"):
            mod.bench_qm9_train_step(reps=1)

    def test_suite_extras_record_the_refusal(self, monkeypatch, capsys):
        mod = _reload(monkeypatch, ECNF_BENCH_TASK="suite")
        monkeypatch.setattr(mod, "bench_lj13", lambda method, reps: 300.0)
        rec = _run_main(mod, capsys)
        assert rec["value"] == 300.0
        for key in ("qm9_sample_logprob_hutch4", "qm9_train_step"):
            assert "need a GPU" in rec["extras"][key]["error"]


class TestImpossibleMfuGuard:
    def test_record_details_rejects_mfu_above_peak(self, monkeypatch):
        """A sync that does not cover execution reads an impossible MFU;
        _record_details must refuse to record such a reading."""
        from ecnf_jax.ops.flops import FlopCount
        import ecnf_jax.ops.flops as flops

        mod = _reload(monkeypatch)
        monkeypatch.setattr(flops, "mfu", lambda *a, **k: 350.0)
        with pytest.raises(RuntimeError, match="exceeds chip peak"):
            mod._record_details("t", [1.0], 48.0,
                                FlopCount(bf16=1e12, f32=0.0))

    def test_plausible_mfu_recorded(self, monkeypatch):
        from ecnf_jax.ops.flops import FlopCount
        import ecnf_jax.ops.flops as flops

        mod = _reload(monkeypatch)
        monkeypatch.setattr(flops, "mfu", lambda *a, **k: 0.53)
        mod._record_details("t", [1.0], 48.0, FlopCount(bf16=1e12, f32=0.0))
        assert mod.DETAILS["t"]["mfu"] == 0.53
