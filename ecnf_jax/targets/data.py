"""Datasets: FullGraphSample + DW4 / LJ13 / QM9 / ALDP loaders.

Parity with the reference's `ecnf/targets/data.py` (split conventions,
shapes, feature encodings) with two environment-driven differences:

- The original DW4/LJ13 ``.npy`` blobs (from vgsatorras/en_flows,
  `data.py:37-38,61-62`) are not distributable; when absent, statistically
  equivalent datasets are regenerated by HMC on the *same* target energies
  (`ecnf_jax/targets/mcmc.py`) and cached.  If the original files are
  present they are used with the reference's exact split logic.
- ALDP h5 trajectories are read directly with h5py (mdtraj's HDF5 layout:
  the ``coordinates`` dataset) instead of requiring mdtraj.
"""
from pathlib import Path
from typing import NamedTuple, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ecnf_jax.utils.optional import require

GraphFeatures = jax.Array
Positions = jax.Array

_DEFAULT_DATA_DIR = Path(__file__).resolve().parent.parent.parent / "data"


class FullGraphSample(NamedTuple):
    """Positions + per-node features (reference `data.py:15-20`)."""

    positions: Positions
    features: GraphFeatures

    def __getitem__(self, i):
        return FullGraphSample(self.positions[i], self.features[i])


def positional_dataset_only_to_full_graph(positions: jax.Array) -> FullGraphSample:
    """Zero integer features for pure-positional datasets (reference
    `data.py:23-28`)."""
    assert positions.ndim == 3  # [n_data_points, n_nodes, dim]
    features = jnp.zeros((*positions.shape[:-1], 1), dtype=jnp.int32)
    return FullGraphSample(positions=positions, features=features)


def _data_dir(path: Optional[Union[Path, str]]) -> Path:
    if path is None:
        return _DEFAULT_DATA_DIR
    return Path(path)


def _generate_dw4_data(path: Path) -> np.ndarray:
    """Regenerate a DW4 dataset by HMC on the double-well energy."""
    from ecnf_jax.targets.energies import double_well_log_prob
    from ecnf_jax.targets.mcmc import run_hmc

    print("DW4 source blob missing; regenerating via HMC (deterministic seed)")
    samples, acc = run_hmc(
        double_well_log_prob,
        jax.random.PRNGKey(2023),
        n_samples_per_chain=200,
        n_chains=64,
        n_nodes=4,
        dim=2,
        step_size=0.12,
        n_leapfrog=15,
        burn_in=2000,
        thin=20,
        init_scale=1.0,
    )
    print(f"DW4 HMC acceptance rate: {float(acc):.2f}")
    data = np.asarray(samples, dtype=np.float64)
    _gate_on_mixing("DW4", data, n_chains=64, log_prob_fn=double_well_log_prob)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(path, data)
    return data


def _gate_on_mixing(name: str, data: np.ndarray, n_chains: int, log_prob_fn) -> None:
    """Refuse to ship a regenerated dataset whose chains have not mixed.

    Acceptance rate alone is insufficient (0.99 acceptance can mean tiny
    steps and no exploration); gate on split-R̂ of the energy and the mean
    pairwise distance plus a minimum effective sample size.  Thresholds:
    R̂ < 1.05 (standard convergence cut), ESS > 10 x n_chains (each chain
    contributes a nontrivial number of independent draws).
    """
    from ecnf_jax.targets.diagnostics import mcmc_diagnostics

    report = mcmc_diagnostics(data, n_chains=n_chains, log_prob_fn=log_prob_fn)
    print(
        f"{name} HMC diagnostics: "
        + ", ".join(f"{k}={v:.4g}" for k, v in sorted(report.items()))
    )
    for stat in ("energy", "dist"):
        rhat = report[f"rhat_{stat}"]
        ess = report[f"ess_{stat}"]
        assert rhat < 1.05, f"{name} HMC did not converge: split-Rhat({stat})={rhat:.3f}"
        assert ess > 10 * n_chains, f"{name} HMC ESS too low: ess({stat})={ess:.0f}"


def load_dw4(
    train_set_size: int = 1000,
    val_set_size: int = 1000,
    test_set_size: int = 1000,
    path: Optional[Union[Path, str]] = None,
) -> Tuple[FullGraphSample, FullGraphSample, FullGraphSample]:
    """DW4: 4 particles in 2-D (reference `data.py:31-55`).

    With the original ``dw4-dataidx.npy`` present, splits follow the
    reference exactly (train = head, val/test = tail).  Otherwise an
    HMC-regenerated dataset of the same layout is used.
    """
    d = _data_dir(path)
    fpath = d / "dw4-dataidx.npy"
    gen_path = d / "dw4_generated.npy"
    if fpath.exists():
        dataset = np.load(fpath, allow_pickle=True)[0]
        dataset = np.asarray(dataset, dtype=np.float64).reshape(-1, 4, 2)
    elif gen_path.exists():
        dataset = np.load(gen_path).reshape(-1, 4, 2)
    else:
        dataset = _generate_dw4_data(gen_path).reshape(-1, 4, 2)

    dataset = jnp.asarray(dataset, dtype=jnp.float32)
    train = dataset[:train_set_size]
    val = dataset[-test_set_size - val_set_size : -test_set_size]
    test = dataset[-test_set_size:]
    return (
        positional_dataset_only_to_full_graph(train),
        positional_dataset_only_to_full_graph(val),
        positional_dataset_only_to_full_graph(test),
    )


def _generate_lj13_data(path: Path) -> np.ndarray:
    """Regenerate an LJ13 dataset by HMC on the Lennard-Jones energy."""
    from ecnf_jax.targets.energies import lennard_jones_log_prob
    from ecnf_jax.targets.mcmc import run_hmc, icosahedron_with_center

    print("LJ13 source blobs missing; regenerating via HMC (deterministic seed)")
    key = jax.random.PRNGKey(13)
    key_init, key_run = jax.random.split(key)
    # Random inits overlap particles (infinite LJ energy); start chains from
    # noisy icosahedra — the LJ13 ground-state geometry — and equilibrate.
    x0 = icosahedron_with_center(64, key_init, noise=0.03)
    samples, acc = run_hmc(
        lennard_jones_log_prob,
        key_run,
        n_samples_per_chain=120,
        n_chains=64,
        n_nodes=13,
        dim=3,
        step_size=0.012,
        n_leapfrog=40,
        burn_in=6000,
        thin=20,
        init_positions=x0,
    )
    print(f"LJ13 HMC acceptance rate: {float(acc):.2f}")
    assert float(acc) > 0.3, f"LJ13 HMC failed to mix (acceptance {float(acc):.2f})"
    data = np.asarray(samples, dtype=np.float64)
    _gate_on_mixing("LJ13", data, n_chains=64, log_prob_fn=lennard_jones_log_prob)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(path, data)
    return data


def load_lj13(
    train_set_size: int = 1000, path: Optional[Union[Path, str]] = None
) -> Tuple[FullGraphSample, FullGraphSample, FullGraphSample]:
    """LJ13: 13 particles in 3-D (reference `data.py:58-91`).

    Reference layout: train from ``holdout_data_LJ13.npy`` indexed by
    ``idx_LJ13.npy``; val = rows 1000:2000 and test = rows :1000 of
    ``all_data_LJ13.npy``.  Used verbatim when those files exist; otherwise
    a regenerated dataset supplies disjoint train/val/test blocks.
    """
    d = _data_dir(path)
    fpath_train = d / "holdout_data_LJ13.npy"
    fpath_idx = d / "idx_LJ13.npy"
    fpath_val_test = d / "all_data_LJ13.npy"

    if fpath_train.exists() and fpath_val_test.exists():
        train_data = np.asarray(np.load(fpath_train, allow_pickle=True), dtype=np.float64)
        idxs = np.asarray(np.load(fpath_idx, allow_pickle=True), dtype=np.int64)
        val_test = np.asarray(np.load(fpath_val_test, allow_pickle=True), dtype=np.float64)
        val_data = val_test[1000:2000]
        test_data = val_test[:1000]
        assert train_set_size <= len(idxs)
        train_data = train_data[idxs[:train_set_size]]
    else:
        gen_path = d / "lj13_generated.npy"
        if gen_path.exists():
            data = np.load(gen_path)
        else:
            data = _generate_lj13_data(gen_path)
        data = data.reshape(-1, 13, 3)
        n = len(data)
        assert n >= train_set_size + 2000, "regenerated LJ13 dataset too small"
        test_data = data[:1000]
        val_data = data[1000:2000]
        train_data = data[2000 : 2000 + train_set_size]

    to3 = lambda a: jnp.asarray(np.reshape(a, (-1, 13, 3)), dtype=jnp.float32)
    return (
        positional_dataset_only_to_full_graph(to3(train_data)),
        positional_dataset_only_to_full_graph(to3(val_data)),
        positional_dataset_only_to_full_graph(to3(test_data)),
    )


SYNTHETIC_QM9_MARKER = "QM9_SYNTHETIC_NOTE.txt"


def load_qm9(
    train_set_size: Optional[int] = None,
    path: Optional[Union[Path, str]] = None,
    allow_synthetic: bool = False,
) -> Tuple[FullGraphSample, FullGraphSample, FullGraphSample]:
    """QM9 positional (19-atom molecules), reference `data.py:93-122`.

    Expects ``qm9pos_{train,valid,test}.npy`` under the data dir; when
    missing, runs the torch-free download/processing pipeline
    (`ecnf_jax/targets/qm9.py`) which requires network access.

    Provenance guard: `scripts/make_synthetic_qm9.py` can write seeded
    Gaussian stand-ins (for hardware validation where egress is blocked)
    alongside a ``QM9_SYNTHETIC_NOTE.txt`` marker.  When the marker is
    present this loader REFUSES to serve the data unless explicitly opted
    in via ``allow_synthetic=True`` or ``ECNF_ALLOW_SYNTHETIC_QM9=1`` —
    synthetic noise must never silently masquerade as QM9 (the reference's
    analogue is auto-downloading the real data on a miss, `data.py:104-105`;
    it never substitutes).
    """
    import os

    d = _data_dir(path)
    fpath_train = d / "qm9pos_train.npy"
    fpath_val = d / "qm9pos_valid.npy"
    fpath_test = d / "qm9pos_test.npy"

    # The marker check runs BEFORE the auto-download branch: a stale
    # marker must refuse up front, not after an expensive real-GDB9
    # download that would then be rejected.
    # Opt-in only on an explicit truthy value: "false"/"no"/typos must
    # refuse, not silently consent (ADVICE r4).
    if (d / SYNTHETIC_QM9_MARKER).exists() and not (
        allow_synthetic
        or os.environ.get("ECNF_ALLOW_SYNTHETIC_QM9", "").lower()
        in ("1", "true", "yes")
    ):
        raise RuntimeError(
            f"{d} is marked as holding SYNTHETIC QM9 stand-in data "
            f"(marker: {d / SYNTHETIC_QM9_MARKER}), not real QM9 — "
            "training on it yields meaningless quality numbers. For "
            "hardware-validation runs opt in explicitly with "
            "load_qm9(..., allow_synthetic=True) or "
            "ECNF_ALLOW_SYNTHETIC_QM9=1. For real QM9, delete BOTH the "
            "marker file and the qm9pos_*.npy stand-ins (or run "
            "scripts/qm9_real_data.sh), then re-run with network access "
            "so qm9pos_download_and_save_data can fetch GDB9."
        )

    if not fpath_train.exists():
        from ecnf_jax.targets.qm9 import qm9pos_download_and_save_data

        qm9pos_download_and_save_data(base_path=str(d))

    train_data = np.load(str(fpath_train))
    if train_set_size is not None:
        assert train_set_size <= len(train_data)
    train_data = train_data[:train_set_size]
    test_data = np.load(str(fpath_test))
    valid_data = np.load(str(fpath_val))

    return (
        positional_dataset_only_to_full_graph(jnp.asarray(train_data, dtype=jnp.float32)),
        positional_dataset_only_to_full_graph(jnp.asarray(valid_data, dtype=jnp.float32)),
        positional_dataset_only_to_full_graph(jnp.asarray(test_data, dtype=jnp.float32)),
    )


def _read_mdtraj_h5_positions(path: str) -> np.ndarray:
    """Read an mdtraj-format HDF5 trajectory's coordinates with h5py."""
    h5py = require("h5py", "reading HDF5 trajectories")
    with h5py.File(path, "r") as f:
        return np.asarray(f["coordinates"])


def load_aldp(
    train_path: Optional[str] = None,
    val_path: Optional[str] = None,
    test_path: Optional[str] = None,
    train_n_points: Optional[int] = None,
    val_n_points: Optional[int] = None,
    test_n_points: Optional[int] = None,
    val_skip_n: int = 0,
    test_skip_n: int = 0,
) -> Tuple[Optional[FullGraphSample], Optional[FullGraphSample], Optional[FullGraphSample]]:
    """Alanine dipeptide from mdtraj-format h5 (reference `data.py:125-154`).

    Features are the per-atom index (``arange(n_atoms)``), matching the
    reference's encoding (`data.py:146`).

    ``val_skip_n`` / ``test_skip_n`` drop that many leading frames before
    applying ``*_n_points`` — net-new over the reference (which assumes
    three separate files, `examples/config/aldp.yaml`): when only the one
    mini h5 exists, skips carve DISJOINT train/val/test splits out of it
    instead of silently evaluating on the training frames.
    """
    paths = [train_path, val_path, test_path]
    n_points = [train_n_points, val_n_points, test_n_points]
    skips = [0, val_skip_n, test_skip_n]
    datasets = [None, None, None]

    for i in range(3):
        if paths[i] is not None:
            positions = _read_mdtraj_h5_positions(paths[i])
            n_atoms = positions.shape[1]
            features = jnp.arange(n_atoms, dtype=jnp.int32)[:, None]
            if skips[i]:
                positions = positions[skips[i]:]
            if n_points[i] is not None:
                positions = positions[: n_points[i]]
            datasets[i] = FullGraphSample(
                positions=jnp.asarray(positions, dtype=jnp.float32),
                features=jnp.repeat(features[None, :], positions.shape[0], axis=0),
            )
    return tuple(datasets)
