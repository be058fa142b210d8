"""QM9 pipeline END-TO-END rehearsal on a miniature GDB9-format fixture.

The real pipeline (`ecnf_jax/targets/qm9.py`) needs the 82 MB figshare
tarball; this drives the FULL `qm9pos_download_and_save_data` path —
download (mocked to deliver the fixture), exclusion parsing, seed-0
splits, tar extraction, xyz parsing (native C++ parser and the Python
fallback), 19-atom filtering, `.npy` persistence — and then loads the
results through `targets.data.load_qm9` into train-ready FullGraphSamples.

Reference semantics under test: `qm9_download_data/prepare/qm9.py:28-134`,
`prepare/process.py:180-243`, `dataset.py:43-61`, `targets/data.py:93-122`.
"""
import tarfile
from pathlib import Path

import numpy as np
import pytest

import ecnf_jax.targets.qm9 as qm9
from ecnf_jax.targets.data import load_qm9

# Miniature GDB9: 50 molecules, 5 excluded, splits 20 train / 4 test (10%
# of 45, floored) / 21 valid.
N_MOLS = 50
N_EXCL = 5
N_TRAIN = 20

# Atom-count cycle: mostly 19-atom molecules (the kept class for
# remove_h=False), some off-size ones that the filter must drop.
ATOM_COUNTS = [19, 19, 5, 19, 12]
# 19-atom molecules are built as 9 heavy atoms + 10 hydrogens so the same
# fixture also exercises the remove_h=True branch (9 heavy == kept).
HEAVY = ["C", "C", "O", "N", "C", "C", "O", "C", "F"]


def _mol_positions(mol_id: int, n_atoms: int) -> np.ndarray:
    """Deterministic positions that encode the molecule id (traceability)."""
    rng = np.random.default_rng(1000 + mol_id)
    pos = rng.normal(size=(n_atoms, 3)).round(6)
    pos[0, 0] = float(mol_id)  # fingerprint
    return pos


def _xyz_bytes(mol_id: int) -> bytes:
    n_atoms = ATOM_COUNTS[mol_id % len(ATOM_COUNTS)]
    pos = _mol_positions(mol_id, n_atoms)
    if n_atoms == 19:
        species = HEAVY + ["H"] * 10
    else:
        species = (["C", "H", "O", "N", "F"] * 4)[:n_atoms]
    lines = [f"{n_atoms}"]
    props = "\t".join(f"{0.1 * (mol_id + k):.6f}" for k in range(15))
    lines.append(f"gdb {mol_id + 1}\t{props}")
    for a, (sp, p) in enumerate(zip(species, pos)):
        # One coordinate per molecule uses GDB9's broken '*^' exponent form
        # (reference fix-up at `prepare/process.py:213`).
        x = f"{p[0] * 1e5:.6f}*^-5" if a == 1 else f"{p[0]:.6f}"
        lines.append(f"{sp}\t{x}\t{p[1]:.6f}\t{p[2]:.6f}\t-0.123456")
    lines.append("100.0\t200.0\t300.0")  # frequencies (ignored)
    lines.append("C\tC")  # SMILES (ignored)
    lines.append("InChI=1S/fixture\tInChI=1S/fixture")  # InChI (ignored)
    return ("\n".join(lines) + "\n").encode()


@pytest.fixture(scope="module")
def fixture_files(tmp_path_factory):
    src = tmp_path_factory.mktemp("gdb9_fixture")
    tar_path = src / "dsgdb9nsd.xyz.tar.bz2"
    with tarfile.open(tar_path, "w:bz2") as tar:
        for i in range(N_MOLS):
            import io

            data = _xyz_bytes(i)
            info = tarfile.TarInfo(name=f"dsgdb9nsd_{i + 1:06d}.xyz")
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    excl_path = src / "uncharacterized.txt"
    lines = ["header line\n", "\n"]
    for i in range(1, N_EXCL + 1):  # exclude molecules 1..5 (1-based)
        lines.append(f"{i}  6.2  other fields\n")
    lines.append("footer\n")
    excl_path.write_text("".join(lines))
    return tar_path, excl_path


@pytest.fixture()
def mini_constants(monkeypatch):
    monkeypatch.setattr(qm9, "N_GDB9", N_MOLS)
    monkeypatch.setattr(qm9, "N_EXCLUDED", N_EXCL)
    monkeypatch.setattr(qm9, "N_TRAIN", N_TRAIN)


def _species(mol_id: int):
    n_atoms = ATOM_COUNTS[mol_id % len(ATOM_COUNTS)]
    if n_atoms == 19:
        return HEAVY + ["H"] * 10
    return (["C", "H", "O", "N", "F"] * 4)[:n_atoms]


def _expected_split_positions(splits, n_atoms=19):
    """Kept (19-atom) molecules of a split in tar-index order."""
    out = {}
    for name, idxs in splits.items():
        rows = []
        for i in sorted(int(j) for j in idxs):
            if ATOM_COUNTS[i % len(ATOM_COUNTS)] == 19:
                rows.append(_mol_positions(i, 19)[:n_atoms])
        out[name] = np.array(rows)
    return out


def _expected_split_heavy_positions(splits, n_heavy=9):
    """remove_h semantics: molecules with exactly `n_heavy` non-H atoms,
    positions compacted to the heavy atoms in original order."""
    out = {}
    for name, idxs in splits.items():
        rows = []
        for i in sorted(int(j) for j in idxs):
            n_atoms = ATOM_COUNTS[i % len(ATOM_COUNTS)]
            heavy = np.array([sp != "H" for sp in _species(i)])
            if heavy.sum() == n_heavy:
                rows.append(_mol_positions(i, n_atoms)[heavy][:n_heavy])
        out[name] = np.array(rows)
    return out


class TestQm9EndToEnd:
    def _run_pipeline(self, tmp_path, fixture_files, monkeypatch):
        tar_src, excl_src = fixture_files
        base = tmp_path / "qm9"

        downloaded = []

        def fake_download(url, dest):
            # Deliver the fixture in place of the figshare payloads.
            downloaded.append(url)
            src = tar_src if dest.endswith(".tar.bz2") else excl_src
            Path(dest).write_bytes(Path(src).read_bytes())

        monkeypatch.setattr(qm9, "_download", fake_download)
        qm9.qm9pos_download_and_save_data(str(base))
        assert len(downloaded) == 2  # both the tarball and the exclusions
        return base

    def test_full_pipeline_and_load(self, tmp_path, fixture_files, mini_constants, monkeypatch):
        base = self._run_pipeline(tmp_path, fixture_files, monkeypatch)

        splits = qm9.gen_splits_gdb9(str(base / "uncharacterized.txt"))
        assert len(splits["train"]) == N_TRAIN
        assert len(splits["test"]) == int(0.1 * (N_MOLS - N_EXCL))
        # Excluded 0-based ids 0..4 never appear.
        all_idx = np.concatenate(list(splits.values()))
        assert all_idx.min() >= N_EXCL

        expected = _expected_split_positions(splits)
        for split in ("train", "valid", "test"):
            arr = np.load(base / f"qm9pos_{split}.npy")
            assert arr.shape[1:] == (19, 3)
            assert arr.shape[0] == len(expected[split])
            # Fingerprint column traces each row to its source molecule;
            # the '*^-5' exponent fix-up must round-trip the value.
            np.testing.assert_allclose(arr, expected[split], atol=1e-9)

        # The loader turns the saved splits into train-ready graph samples.
        train, valid, test = load_qm9(path=base)
        assert train.positions.shape[1:] == (19, 3)
        assert train.positions.shape[0] == len(expected["train"])
        assert (np.asarray(train.features) == 0).all()
        np.testing.assert_allclose(
            np.asarray(train.positions), expected["train"], atol=1e-5
        )

    def test_python_fallback_parser_matches_native(
        self, tmp_path, fixture_files, mini_constants, monkeypatch
    ):
        base_native = self._run_pipeline(
            tmp_path / "native", fixture_files, monkeypatch
        )
        # Force the pure-Python parser and re-run.
        import ecnf_jax.targets.native as native

        monkeypatch.setattr(native, "get_parser", lambda: None)
        base_py = self._run_pipeline(tmp_path / "py", fixture_files, monkeypatch)
        for split in ("train", "valid", "test"):
            np.testing.assert_allclose(
                np.load(base_native / f"qm9pos_{split}.npy"),
                np.load(base_py / f"qm9pos_{split}.npy"),
                atol=1e-12,
            )

    def test_remove_h_branch(self, tmp_path, fixture_files, mini_constants, monkeypatch):
        tar_src, excl_src = fixture_files
        base = tmp_path / "qm9h"
        base.mkdir(parents=True)
        (base / "dsgdb9nsd.xyz.tar.bz2").write_bytes(tar_src.read_bytes())
        (base / "uncharacterized.txt").write_bytes(excl_src.read_bytes())

        qm9.qm9pos_download_and_save_data(str(base), remove_h=True)
        splits = qm9.gen_splits_gdb9(str(base / "uncharacterized.txt"))
        arr = np.load(base / "qm9pos_train_no_h.npy")
        assert arr.shape[1:] == (9, 3)
        # Both the 19-atom molecules (9 heavy + 10 H) and the 12-atom ones
        # (9 heavy interleaved with 3 H) have exactly 9 heavy atoms; the
        # compaction must pick the heavy-atom rows in original order.
        expected = _expected_split_heavy_positions(splits)
        assert arr.shape == expected["train"].shape
        np.testing.assert_allclose(arr, expected["train"], atol=1e-9)
