"""QM9 positional dataset pipeline — torch-free.

Re-implementation of the reference's
`ecnf/targets/qm9_download_data/` (the only torch-dependent subsystem in
the main path) with numpy only, preserving byte-level split parity:

- figshare download of GDB9 xyz tarball + uncharacterized list
  (reference `data/prepare/qm9.py:28-35,82-89`),
- split generation with the identical RNG (``np.random.seed(0)``,
  100k train / 10% test / rest valid over 130831 included molecules,
  3054 exclusions — `data/prepare/qm9.py:105-134`),
- xyz parsing (`data/prepare/process.py:180-243`),
- filter to molecules with exactly 19 atoms (remove_h=False) and save
  ``qm9pos_{train,valid,test}.npy`` position arrays sliced to 19 atoms
  (`dataset.py:43-61`).

Requires network access for the initial download (~82 MB); all later loads
hit the cached ``.npy`` files.
"""
import logging
import tarfile
import urllib.request
from pathlib import Path
from typing import Dict, Optional

import numpy as np

GDB9_URL_DATA = "https://springernature.figshare.com/ndownloader/files/3195389"
GDB9_URL_EXCLUDED = "https://springernature.figshare.com/ndownloader/files/3195404"

CHARGE_OF = {"H": 1, "C": 6, "N": 7, "O": 8, "F": 9}
N_GDB9 = 133885
N_EXCLUDED = 3054
N_TRAIN = 100000


def _is_int(s: str) -> bool:
    try:
        int(s)
        return True
    except ValueError:
        return False


def gen_splits_gdb9(excluded_txt_path: str) -> Dict[str, np.ndarray]:
    """Deterministic train/valid/test molecule-index splits.

    Byte-parity with reference `data/prepare/qm9.py:66-134`: same exclusion
    parsing, same ``np.random.seed(0)`` permutation, same split sizes.
    """
    with open(excluded_txt_path) as f:
        lines = f.readlines()
        excluded_strings = [line.split()[0] for line in lines if len(line.split()) > 0]
    excluded_idxs = [int(idx) - 1 for idx in excluded_strings if _is_int(idx)]
    assert len(excluded_idxs) == N_EXCLUDED, (
        f"There should be exactly {N_EXCLUDED} excluded molecules, "
        f"found {len(excluded_idxs)}"
    )

    included_idxs = np.array(sorted(set(range(N_GDB9)) - set(excluded_idxs)))
    n_mols = N_GDB9 - N_EXCLUDED
    n_test = int(0.1 * n_mols)
    n_valid = n_mols - (N_TRAIN + n_test)

    np.random.seed(0)
    data_perm = np.random.permutation(n_mols)
    train, valid, test, extra = np.split(
        data_perm, [N_TRAIN, N_TRAIN + n_valid, N_TRAIN + n_valid + n_test]
    )
    assert len(extra) == 0
    return {
        "train": included_idxs[train],
        "valid": included_idxs[valid],
        "test": included_idxs[test],
    }


def process_xyz_gdb9(datafile) -> Dict[str, np.ndarray]:
    """Parse one GDB9 xyz file into charges/positions/properties.

    Parity with reference `data/prepare/process.py:180-243` (property list
    ordering, ``*^`` exponent fix-up).
    """
    xyz_lines = [line.decode("UTF-8") for line in datafile.readlines()]

    num_atoms = int(xyz_lines[0])
    mol_props_line = xyz_lines[1]
    mol_xyz = xyz_lines[2 : num_atoms + 2]

    atom_charges, atom_positions = [], []
    for line in mol_xyz:
        atom, posx, posy, posz, _ = line.replace("*^", "e").split()
        atom_charges.append(CHARGE_OF[atom])
        atom_positions.append([float(posx), float(posy), float(posz)])

    prop_strings = [
        "tag", "index", "A", "B", "C", "mu", "alpha", "homo", "lumo",
        "gap", "r2", "zpve", "U0", "U", "H", "G", "Cv",
    ]
    prop_values = mol_props_line.split()
    mol_props = {"tag": prop_values[0], "index": int(prop_values[1])}
    for name, val in zip(prop_strings[2:], prop_values[2:]):
        mol_props[name] = float(val)

    molecule = {
        "num_atoms": num_atoms,
        "charges": np.array(atom_charges, dtype=np.int64),
        "positions": np.array(atom_positions, dtype=np.float64),
    }
    molecule.update(mol_props)
    return molecule


def process_xyz_files_from_tar(
    tar_path: str, file_idx_list: Optional[np.ndarray] = None
) -> Dict[str, np.ndarray]:
    """Extract and parse xyz members of the GDB9 tarball, stacked + padded.

    Parity with reference `data/prepare/process.py:25-93` (sorted member
    order, index selection, pad-to-max-atoms stacking).
    """
    from ecnf_jax.targets.native import parse_xyz_native, get_parser

    use_native = get_parser() is not None
    with tarfile.open(tar_path, "r") as tar:
        files = sorted(
            (m for m in tar.getmembers() if m.name.endswith(".xyz")),
            key=lambda m: m.name,
        )
        if file_idx_list is not None:
            wanted = set(int(i) for i in file_idx_list)
            files = [f for i, f in enumerate(files) if i in wanted]
        molecules = []
        for member in files:
            with tar.extractfile(member) as f:
                if use_native:
                    mol = parse_xyz_native(f.read())
                    mol["tag"] = "gdb"
                    molecules.append(mol)
                else:
                    molecules.append(process_xyz_gdb9(f))

    props = molecules[0].keys()
    assert all(mol.keys() == props for mol in molecules)
    stacked: Dict[str, np.ndarray] = {}
    max_atoms = max(mol["num_atoms"] for mol in molecules)
    for key in props:
        vals = [mol[key] for mol in molecules]
        first = vals[0]
        if isinstance(first, str):
            continue  # tags are not needed downstream
        if np.ndim(first) == 0:
            stacked[key] = np.array(vals)
        else:
            padded = [
                np.pad(v, [(0, max_atoms - v.shape[0])] + [(0, 0)] * (v.ndim - 1))
                for v in vals
            ]
            stacked[key] = np.stack(padded)
    return stacked


def _download(url: str, dest: str) -> None:
    logging.info("downloading %s -> %s", url, dest)
    urllib.request.urlretrieve(url, filename=dest)


def qm9pos_download_and_save_data(base_path: str, remove_h: bool = False) -> None:
    """Download + process QM9 and save positional splits.

    Parity with reference `dataset.py:43-61`: keep molecules with exactly
    19 atoms (9 heavy atoms when ``remove_h``), slice positions to the
    first ``n_atoms`` columns, save per-split ``.npy``.
    """
    n_atoms = 9 if remove_h else 19
    base = Path(base_path)
    base.mkdir(parents=True, exist_ok=True)

    tar_path = base / "dsgdb9nsd.xyz.tar.bz2"
    if not tar_path.exists():
        _download(GDB9_URL_DATA, str(tar_path))
    excluded_path = base / "uncharacterized.txt"
    if not excluded_path.exists():
        _download(GDB9_URL_EXCLUDED, str(excluded_path))

    splits = gen_splits_gdb9(str(excluded_path))

    out = {}
    for split_name, split_idx in splits.items():
        data = process_xyz_files_from_tar(str(tar_path), file_idx_list=split_idx)
        if remove_h:
            mask_h = data["charges"] > 1
            num_heavy = mask_h.sum(axis=1)
            keep = num_heavy == n_atoms
            # Compact heavy-atom positions per molecule.
            positions = np.zeros((keep.sum(), n_atoms, 3))
            sel = np.where(keep)[0]
            for row, i in enumerate(sel):
                positions[row] = data["positions"][i][mask_h[i]][:n_atoms]
        else:
            keep = data["num_atoms"] == n_atoms
            positions = data["positions"][keep][:, :n_atoms]
        out[split_name] = positions
        suffix = "_no_h" if remove_h else ""
        np.save(base / f"qm9pos_{split_name}{suffix}.npy", positions)
        print(f"qm9pos {split_name}: {positions.shape}")
