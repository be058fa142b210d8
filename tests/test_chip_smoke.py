"""`chip_smoke.py`: refuses to run without a GPU, prints no result there,
and its reference comparisons are wired up (rehearsed here at toy size on
the CPU; the real widths run only on the card)."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

TINY = cs.Sizes(
    lj13=(5, 1, (16, 16), 8), qm9=(19, 1, (16, 16), 8),
    lj13_batch=4, hutch_batch=4, adaptive_batch=4, train_batch=8, reps=1,
)


def _run(args, cwd):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_exits_nonzero_without_gpu():
    proc = _run([str(REPO / "chip_smoke.py")], REPO)
    assert proc.returncode != 0
    assert "needs a GPU" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_exits_nonzero_alone_in_a_directory(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(["chip_smoke.py", "--multi"], tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_check_fails_above_tolerance():
    assert "0.000e+00" in cs.check({"a": (0.0, "order")})
    with pytest.raises(AssertionError, match="above tolerance"):
        cs.check({"a": (1.0, "order"), "b": (0.0, "bf16")})
    with pytest.raises(AssertionError):
        cs.check({"nan": (float("nan"), "bf16")})


def test_sampling_and_compare_phases_at_toy_size(capsys):
    results = {}
    cs.TOL["sync"], saved = 10.0, cs.TOL["sync"]  # CPU timing noise at toy size
    try:
        cs.phase_sample_exact(TINY, results)
        cs.phase_sample_hutch(TINY, results)
        cs.phase_compare(TINY, results)
    finally:
        cs.TOL["sync"] = saved
    out = capsys.readouterr().out
    for phase in ("sample_exact:", "sample_hutch:", "compare:"):
        assert phase in out
    assert "equivariance_bf16=" in out and "tangent_vs_linearize=" in out


@pytest.mark.gpu
def test_chip_smoke_on_the_card():
    """The full smoke run at real widths, on a GPU only."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; run `python chip_smoke.py` on the card")
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                          capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
