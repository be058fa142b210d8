"""Native (C++) xyz parser vs the pure-Python reference transcription."""
import io

import numpy as np
import pytest

from ecnf_jax.targets.qm9 import process_xyz_gdb9
from ecnf_jax.targets.native import parse_xyz_native, get_parser

# Synthetic GDB9-style xyz file, including the "*^" exponent quirk.
XYZ = b"""5
gdb 42\t157.7118\t157.70997\t157.70699\t0.\t13.21\t-0.3877\t0.1171\t0.5048\t35.3641\t0.044749\t-40.47893\t-40.476062\t-40.475117\t-40.498597\t6.469
C\t-0.0126981359\t 1.0858041578\t 0.0080009958\t-0.535689
H\t 0.002150416*^-2\t-0.6050024169\t 0.0019761204\t 0.133921
H\t 1.0117308433\t 1.4637511618\t 0.0002765748\t 0.133922
H\t-0.540815069\t 1.4475266138\t-0.8766437152\t 0.133923
H\t-0.5238136345\t 1.4379326443\t 0.9063972942\t 0.133923
"""


@pytest.mark.skipif(get_parser() is None, reason="no C++ toolchain")
def test_native_matches_python():
    py = process_xyz_gdb9(io.BytesIO(XYZ))
    nat = parse_xyz_native(XYZ)
    assert nat["num_atoms"] == py["num_atoms"] == 5
    np.testing.assert_array_equal(nat["charges"], py["charges"])
    np.testing.assert_allclose(nat["positions"], py["positions"], rtol=1e-12)
    assert nat["index"] == py["index"] == 42
    for k in ("A", "mu", "zpve", "U0", "Cv", "gap"):
        np.testing.assert_allclose(nat[k], py[k], rtol=1e-12)
    # The *^ exponent quirk parsed identically:
    np.testing.assert_allclose(nat["positions"][1, 0], 0.002150416e-2, rtol=1e-12)


@pytest.mark.skipif(get_parser() is None, reason="no C++ toolchain")
def test_native_rejects_malformed():
    with pytest.raises(ValueError):
        parse_xyz_native(b"not an xyz file")


@pytest.mark.skipif(get_parser() is None, reason="no C++ toolchain")
def test_native_throughput_sane():
    """Parse many copies quickly (native should be >10k molecules/s)."""
    import time

    t0 = time.perf_counter()
    for _ in range(2000):
        parse_xyz_native(XYZ)
    dt = time.perf_counter() - t0
    assert dt < 2.0, f"native parser too slow: {2000/dt:.0f} mol/s"
