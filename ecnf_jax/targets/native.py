"""ctypes bindings for the native xyz parser (with lazy build + fallback).

The shared library is compiled from `_native/xyz_parser.cpp` with g++ on
first use and cached next to the source (it is not committed).  If no
compiler is available the caller falls back to the pure-Python parser in
`ecnf_jax/targets/qm9.py`.
"""
import ctypes
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent / "_native"
_SRC = _NATIVE_DIR / "xyz_parser.cpp"
_LIB = _NATIVE_DIR / "libxyzparse.so"

_lib = None
_PROP_NAMES = (
    "A", "B", "C", "mu", "alpha", "homo", "lumo", "gap",
    "r2", "zpve", "U0", "U", "H", "G", "Cv",
)


def _build() -> bool:
    # Build to a private name and rename into place, so concurrent first
    # uses (e.g. test workers) never load a half-written library.
    tmp = _LIB.with_name(f".{_LIB.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, _LIB)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        print(f"native xyz parser build failed ({e}); using Python fallback")
        tmp.unlink(missing_ok=True)
        return False


def get_parser() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native parser, or None."""
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
        if not _build():
            return None
    lib = ctypes.CDLL(str(_LIB))
    lib.parse_xyz.restype = ctypes.c_int
    lib.parse_xyz.argtypes = [
        ctypes.c_char_p,
        ctypes.c_long,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_longlong),
    ]
    _lib = lib
    return _lib


def parse_xyz_native(data: bytes, max_atoms: int = 32) -> Optional[Dict]:
    """Parse one xyz buffer with the native parser.

    Returns the same dict layout as the Python `process_xyz_gdb9`
    (num_atoms, charges, positions + scalar properties), or None if the
    native parser is unavailable.  Raises ValueError on malformed input.
    """
    lib = get_parser()
    if lib is None:
        return None
    num_atoms = ctypes.c_int()
    charges = np.zeros(max_atoms, dtype=np.int64)
    positions = np.zeros(max_atoms * 3, dtype=np.float64)
    props = np.zeros(15, dtype=np.float64)
    index = ctypes.c_longlong()
    rc = lib.parse_xyz(
        data,
        len(data),
        max_atoms,
        ctypes.byref(num_atoms),
        charges.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        positions.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        props.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.byref(index),
    )
    if rc != 0:
        raise ValueError(f"native xyz parse failed with code {rc}")
    n = num_atoms.value
    out = {
        "num_atoms": n,
        "charges": charges[:n].copy(),
        "positions": positions[: n * 3].reshape(n, 3).copy(),
        "index": int(index.value),
    }
    for name, val in zip(_PROP_NAMES, props):
        out[name] = float(val)
    return out
