"""QM9 pipeline tests (no network): splits RNG parity, extras, collate."""
import numpy as np
import pytest

from ecnf_jax.targets.qm9 import gen_splits_gdb9, N_EXCLUDED, N_GDB9, N_TRAIN
from ecnf_jax.targets.qm9_extras import (
    ProcessedDataset,
    add_thermo_targets,
    batch_stack,
    collate_fn,
)


class TestSplits:
    def test_split_generation_deterministic(self, tmp_path):
        # Craft an exclusion file with exactly 3054 entries (ids 1..3054 in
        # GDB9's 1-based numbering); the reference asserts this count.
        p = tmp_path / "uncharacterized.txt"
        lines = ["header\n", "\n"]
        for i in range(1, N_EXCLUDED + 1):
            lines.append(f"{i} some other fields\n")
        p.write_text("".join(lines))

        splits1 = gen_splits_gdb9(str(p))
        splits2 = gen_splits_gdb9(str(p))
        n_mols = N_GDB9 - N_EXCLUDED
        n_test = int(0.1 * n_mols)
        assert len(splits1["train"]) == N_TRAIN
        assert len(splits1["test"]) == n_test
        assert len(splits1["valid"]) == n_mols - N_TRAIN - n_test
        # Deterministic (np.random.seed(0) parity with the reference).
        for k in splits1:
            np.testing.assert_array_equal(splits1[k], splits2[k])
        # Excluded molecules never appear.
        all_idx = np.concatenate([splits1[k] for k in splits1])
        assert all_idx.min() >= N_EXCLUDED  # ids 0..3053 were excluded
        assert len(np.unique(all_idx)) == n_mols

    def test_wrong_exclusion_count_rejected(self, tmp_path):
        p = tmp_path / "uncharacterized.txt"
        p.write_text("1 x\n2 y\n")
        with pytest.raises(AssertionError):
            gen_splits_gdb9(str(p))


def _toy_data():
    rng = np.random.RandomState(0)
    charges = np.array(
        [[6, 1, 1, 1, 1], [8, 1, 1, 0, 0], [6, 8, 1, 1, 0]], dtype=np.int64
    )
    return {
        "num_atoms": np.array([5, 3, 4]),
        "charges": charges,
        "positions": rng.randn(3, 5, 3),
        "U0": np.array([-40.0, -75.0, -110.0]),
        "zpve": np.array([0.04, 0.02, 0.03]),
    }


class TestThermo:
    def test_add_thermo_targets(self):
        data = _toy_data()
        therm = {
            "U0": {1: -0.5, 6: -37.8, 8: -75.0},
            "zpve": {1: 0.0, 6: 0.0, 8: 0.0},
        }
        out = add_thermo_targets(dict(data), therm)
        # Molecule 0: C + 4H -> -37.8 + 4 * -0.5 = -39.8.
        np.testing.assert_allclose(out["U0_thermo"][0], -39.8)
        # Molecule 1: O + 2H -> -75.0 - 1.0 = -76.0.
        np.testing.assert_allclose(out["U0_thermo"][1], -76.0)


class TestProcessedDataset:
    def test_one_hot_and_stats(self):
        ds = ProcessedDataset(_toy_data(), subtract_thermo=False)
        np.testing.assert_array_equal(ds.included_species, [1, 6, 8])
        assert ds.num_species == 3
        assert ds.max_charge == 8
        oh = ds.data["one_hot"]
        assert oh.shape == (3, 5, 3)
        assert oh[0, 0, 1]  # C
        assert oh[1, 0, 2]  # O
        assert not oh[1, 3].any()  # padding row
        assert "U0" in ds.stats

    def test_subtract_thermo(self):
        data = _toy_data()
        data["U0_thermo"] = np.array([-39.8, -76.0, -113.0])
        ds = ProcessedDataset(data, subtract_thermo=True)
        np.testing.assert_allclose(ds.data["U0"], [-0.2, 1.0, 3.0])

    def test_convert_units(self):
        ds = ProcessedDataset(_toy_data(), subtract_thermo=False)
        u0 = ds.data["U0"].copy()
        ds.convert_units({"U0": 27.2114})
        np.testing.assert_allclose(ds.data["U0"], u0 * 27.2114)

    def test_getitem(self):
        ds = ProcessedDataset(_toy_data(), subtract_thermo=False)
        item = ds[1]
        assert item["num_atoms"] == 3


class TestCollate:
    def test_masks(self):
        mols = [
            {"charges": np.array([6, 1, 1]), "positions": np.random.randn(3, 3)},
            {"charges": np.array([8, 1]), "positions": np.random.randn(2, 3)},
        ]
        out = collate_fn(mols)
        assert out["charges"].shape == (2, 3)
        np.testing.assert_array_equal(
            out["atom_mask"], [[True, True, True], [True, True, False]]
        )
        edge = out["edge_mask"].reshape(2, 3, 3)
        assert not edge[0].diagonal().any()  # no self-edges
        assert edge[0].sum() == 6  # 3 atoms fully connected
        assert edge[1].sum() == 2  # 2 atoms

    def test_batch_stack_padding(self):
        out = batch_stack([np.ones((2, 3)), np.ones((4, 3))])
        assert out.shape == (2, 4, 3)
        assert out[0, 2:].sum() == 0
