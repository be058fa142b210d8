"""Target energy + dataset tests.

Energy formulas are validated against direct edge-list transcriptions of the
reference (`target_energy/double_well.py:9-19`, `leonard_jones.py:10-27`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ecnf_jax.ops.graph import get_senders_and_receivers_fully_connected
from ecnf_jax.ops.numerics import safe_norm
from ecnf_jax.targets.energies import (
    double_well_energy,
    double_well_log_prob,
    lennard_jones_energy,
    lennard_jones_log_prob,
)
from ecnf_jax.targets.mog import MoGTarget


def _dw_energy_edge_list(x, a=0.0, b=-4.0, c=0.9, d0=4.0, tau=1.0):
    """Direct transcription of reference double_well.py:9-19."""
    n_nodes, _ = x.shape
    senders, receivers = get_senders_and_receivers_fully_connected(n_nodes)
    vectors = x[senders] - x[receivers]
    differences = safe_norm(vectors, axis=-1)
    diff_minus_d0 = differences - d0
    return (
        jnp.sum(a * diff_minus_d0 + b * diff_minus_d0**2 + c * diff_minus_d0**4)
        / tau
        / 2
    )


def _lj_energy_edge_list(x, epsilon=1.0, tau=1.0, r=1.0, coef=0.5):
    """Direct transcription of reference leonard_jones.py:10-27."""
    n_nodes, _ = x.shape
    r = jnp.ones(n_nodes) * r
    senders, receivers = get_senders_and_receivers_fully_connected(n_nodes)
    vectors = x[senders] - x[receivers]
    d = safe_norm(vectors, axis=-1)
    term = (r[receivers] / d) ** 12 - 2 * (r[receivers] / d) ** 6
    energy = epsilon / (2 * tau) * jnp.sum(term)
    com = jnp.mean(x, axis=0)
    return energy + coef * jnp.sum((x - com) ** 2)


class TestEnergies:
    def test_dw4_matches_edge_list(self):
        x = jax.random.normal(jax.random.PRNGKey(0), (4, 2)) * 2
        np.testing.assert_allclose(
            double_well_energy(x), _dw_energy_edge_list(x), rtol=1e-5
        )

    def test_dw4_batched(self):
        xb = jax.random.normal(jax.random.PRNGKey(1), (5, 4, 2)) * 2
        eb = double_well_log_prob(xb)
        for i in range(5):
            np.testing.assert_allclose(
                eb[i], -_dw_energy_edge_list(xb[i]), rtol=1e-5
            )

    def test_lj13_matches_edge_list(self):
        x = jax.random.normal(jax.random.PRNGKey(2), (13, 3))
        np.testing.assert_allclose(
            lennard_jones_energy(x), _lj_energy_edge_list(x), rtol=1e-4
        )

    def test_lj13_batched(self):
        xb = jax.random.normal(jax.random.PRNGKey(3), (3, 13, 3))
        eb = lennard_jones_log_prob(xb)
        for i in range(3):
            np.testing.assert_allclose(
                eb[i], -_lj_energy_edge_list(xb[i]), rtol=1e-4
            )

    def test_energies_translation_invariant_dw(self):
        x = jax.random.normal(jax.random.PRNGKey(4), (4, 2))
        shift = jnp.array([3.0, -1.0])
        np.testing.assert_allclose(
            double_well_energy(x), double_well_energy(x + shift), rtol=1e-4
        )


class TestMoG:
    def test_log_prob_normalized(self):
        """MC check: E_q[p/q] == 1 with q = broad Gaussian."""
        target = MoGTarget()
        key = jax.random.PRNGKey(0)
        scale = 25.0
        x = jax.random.normal(key, (200_000, 2)) * scale
        log_q = (
            -0.5 * jnp.sum((x / scale) ** 2, axis=-1)
            - np.log(2 * np.pi)
            - 2 * np.log(scale)
        )
        log_p = target.log_prob(x)
        ratio = jnp.exp(jax.nn.logsumexp(log_p - log_q) - np.log(x.shape[0]))
        np.testing.assert_allclose(float(ratio), 1.0, rtol=0.15)

    def test_sample_statistics(self):
        target = MoGTarget()
        samples = target.sample(jax.random.PRNGKey(1), (50_000,))
        # Mean of samples should approximate the mean of the mixture means.
        np.testing.assert_allclose(
            samples.mean(axis=0), target.means.mean(axis=0), atol=0.2
        )


class TestALDPLoader:
    def test_reads_h5(self):
        from pathlib import Path

        from ecnf_jax.targets.data import load_aldp

        path = Path(__file__).resolve().parent.parent / "data" / "aldp_500K_train_mini.h5"
        if not path.exists():
            pytest.skip("aldp h5 not present")
        train, _, _ = load_aldp(train_path=str(path), train_n_points=100)
        assert train.positions.shape == (100, 22, 3)
        assert train.features.shape == (100, 22, 1)
        # Features are the per-atom index (reference data.py:146).
        np.testing.assert_array_equal(
            np.asarray(train.features[0, :, 0]), np.arange(22)
        )

    def test_skip_carves_disjoint_splits(self):
        """val/test_skip_n drop leading frames so one trajectory file can
        serve disjoint train/test splits (examples/configs/aldp_soak.yaml)."""
        from pathlib import Path

        from ecnf_jax.targets.data import load_aldp

        path = Path(__file__).resolve().parent.parent / "data" / "aldp_500K_train_mini.h5"
        if not path.exists():
            pytest.skip("aldp h5 not present")
        p = str(path)
        train, valid, test = load_aldp(
            train_path=p, val_path=p, test_path=p,
            train_n_points=50, val_n_points=30, test_n_points=30,
            val_skip_n=50, test_skip_n=80,
        )
        full, _, _ = load_aldp(train_path=p, train_n_points=110)
        np.testing.assert_array_equal(
            np.asarray(valid.positions), np.asarray(full.positions[50:80])
        )
        np.testing.assert_array_equal(
            np.asarray(test.positions), np.asarray(full.positions[80:110])
        )
        # Train (prefix) and test (skipped) share no frames.
        assert not np.isin(
            np.asarray(test.positions).reshape(30, -1).sum(axis=1),
            np.asarray(train.positions).reshape(50, -1).sum(axis=1),
        ).any()


class TestEdgeList:
    def test_sender_receiver_pattern(self):
        """Exact ordering parity with reference graph.py:6-14."""
        s, r = get_senders_and_receivers_fully_connected(4)
        expected_r, expected_s = [], []
        for i in range(4):
            for j in range(3):
                expected_r.append(i)
                expected_s.append((i + 1 + j) % 4)
        np.testing.assert_array_equal(np.asarray(s), expected_s)
        np.testing.assert_array_equal(np.asarray(r), expected_r)


class TestQM9SyntheticGuard:
    """`load_qm9` must refuse the synthetic stand-in unless explicitly
    opted in (VERDICT r3 item 3): `python examples/qm9.py` must never
    silently train "QM9" on seeded noise."""

    @staticmethod
    def _write_standins(d, with_marker=True):
        from ecnf_jax.targets.data import SYNTHETIC_QM9_MARKER

        rng = np.random.default_rng(0)
        for name, n in [("train", 8), ("valid", 4), ("test", 4)]:
            np.save(d / f"qm9pos_{name}.npy",
                    rng.normal(size=(n, 19, 3)).astype(np.float32))
        if with_marker:
            (d / SYNTHETIC_QM9_MARKER).write_text("synthetic stand-in\n")

    def test_marker_refuses_by_default(self, tmp_path, monkeypatch):
        from ecnf_jax.targets.data import load_qm9

        monkeypatch.delenv("ECNF_ALLOW_SYNTHETIC_QM9", raising=False)
        self._write_standins(tmp_path)
        with pytest.raises(RuntimeError, match="SYNTHETIC"):
            load_qm9(path=tmp_path)

    def test_opt_in_kwarg(self, tmp_path, monkeypatch):
        from ecnf_jax.targets.data import load_qm9

        monkeypatch.delenv("ECNF_ALLOW_SYNTHETIC_QM9", raising=False)
        self._write_standins(tmp_path)
        train, valid, test = load_qm9(path=tmp_path, allow_synthetic=True)
        assert train.positions.shape == (8, 19, 3)

    def test_opt_in_env(self, tmp_path, monkeypatch):
        from ecnf_jax.targets.data import load_qm9

        self._write_standins(tmp_path)
        monkeypatch.setenv("ECNF_ALLOW_SYNTHETIC_QM9", "1")
        train, _, _ = load_qm9(path=tmp_path)
        assert train.positions.shape == (8, 19, 3)
        # "0" / empty do NOT opt in.
        monkeypatch.setenv("ECNF_ALLOW_SYNTHETIC_QM9", "0")
        with pytest.raises(RuntimeError, match="SYNTHETIC"):
            load_qm9(path=tmp_path)

    def test_env_opt_in_requires_explicit_truthy(self, tmp_path, monkeypatch):
        """Only an explicit truthy value opts in — "false"/"no"/garbage
        must refuse, not silently consent (ADVICE r4)."""
        from ecnf_jax.targets.data import load_qm9

        self._write_standins(tmp_path)
        for bad in ("false", "no", "off", "nope"):
            monkeypatch.setenv("ECNF_ALLOW_SYNTHETIC_QM9", bad)
            with pytest.raises(RuntimeError, match="SYNTHETIC"):
                load_qm9(path=tmp_path)
        for good in ("true", "TRUE", "yes", "1"):
            monkeypatch.setenv("ECNF_ALLOW_SYNTHETIC_QM9", good)
            train, _, _ = load_qm9(path=tmp_path)
            assert train.positions.shape == (8, 19, 3)

    def test_unmarked_data_loads_freely(self, tmp_path, monkeypatch):
        """Fixture/real data without the marker is untouched by the guard."""
        from ecnf_jax.targets.data import load_qm9

        monkeypatch.delenv("ECNF_ALLOW_SYNTHETIC_QM9", raising=False)
        self._write_standins(tmp_path, with_marker=False)
        train, _, _ = load_qm9(path=tmp_path)
        assert train.positions.shape == (8, 19, 3)

    def test_stale_marker_refuses_before_download(self, tmp_path, monkeypatch):
        """A stale marker with MISSING .npy files must refuse up front —
        never trigger (and then reject) an expensive real download."""
        from ecnf_jax.targets import qm9 as qm9_mod
        from ecnf_jax.targets.data import load_qm9, SYNTHETIC_QM9_MARKER

        monkeypatch.delenv("ECNF_ALLOW_SYNTHETIC_QM9", raising=False)
        (tmp_path / SYNTHETIC_QM9_MARKER).write_text("stale marker\n")
        monkeypatch.setattr(
            qm9_mod, "qm9pos_download_and_save_data",
            lambda **kw: pytest.fail("download attempted behind a marker"),
        )
        with pytest.raises(RuntimeError, match="marker"):
            load_qm9(path=tmp_path)
