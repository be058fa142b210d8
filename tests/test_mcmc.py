"""HMC sampler tests: exactness on a Gaussian, self-consistency on DW4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ecnf_jax.targets.mcmc import run_hmc, icosahedron_with_center
from ecnf_jax.targets.energies import double_well_log_prob


class TestHMC:
    def test_gaussian_moments(self):
        """On an isotropic Gaussian target the chain must recover the
        first two moments accurately."""

        def log_prob(x):  # x: [C, N, D], standard normal per coordinate
            return -0.5 * jnp.sum(x**2, axis=(-1, -2))

        samples, acc = run_hmc(
            log_prob,
            jax.random.PRNGKey(0),
            n_samples_per_chain=100,
            n_chains=32,
            n_nodes=4,
            dim=2,
            step_size=0.3,
            n_leapfrog=8,
            burn_in=200,
            thin=5,
        )
        assert 0.4 < float(acc) <= 1.0
        flat = np.asarray(samples).reshape(-1)
        np.testing.assert_allclose(flat.mean(), 0.0, atol=0.05)
        np.testing.assert_allclose(flat.std(), 1.0, atol=0.05)

    @pytest.mark.slow
    def test_dw4_seed_consistency(self):
        """Two independent DW4 runs must produce matching energy
        distributions (the chains are sampling the same measure)."""

        def run(seed):
            s, acc = run_hmc(
                double_well_log_prob,
                jax.random.PRNGKey(seed),
                n_samples_per_chain=50,
                n_chains=32,
                n_nodes=4,
                dim=2,
                step_size=0.12,
                n_leapfrog=15,
                burn_in=800,
                thin=10,
            )
            assert float(acc) > 0.5
            return np.asarray(-double_well_log_prob(s))

        e1, e2 = run(1), run(2)
        np.testing.assert_allclose(e1.mean(), e2.mean(), atol=0.6)
        np.testing.assert_allclose(e1.std(), e2.std(), rtol=0.25)

    def test_icosahedron_geometry(self):
        x = icosahedron_with_center(4, jax.random.PRNGKey(0), noise=0.0)
        assert x.shape == (4, 13, 3)
        d = np.linalg.norm(np.asarray(x[0, 1:]) - np.asarray(x[0, 0]), axis=-1)
        np.testing.assert_allclose(d, 1.0, rtol=1e-5)  # unit circumradius

    def test_init_positions_respected(self):
        x0 = jnp.ones((8, 3, 2)) * 5.0

        def log_prob(x):
            return -0.5 * jnp.sum((x - 5.0) ** 2, axis=(-1, -2))

        samples, acc = run_hmc(
            log_prob,
            jax.random.PRNGKey(0),
            n_samples_per_chain=10,
            n_chains=8,
            n_nodes=3,
            dim=2,
            step_size=0.2,
            n_leapfrog=5,
            burn_in=50,
            thin=2,
            init_positions=x0,
        )
        # Samples hover around the target mean at 5 (started there).
        np.testing.assert_allclose(float(samples.mean()), 5.0, atol=0.3)


class TestDiagnostics:
    """Convergence statistics used to gate the regenerated datasets."""

    def _iid_chains(self, c=8, s=400, seed=0):
        return np.random.default_rng(seed).normal(size=(c, s))

    def test_split_rhat_iid_near_one(self):
        from ecnf_jax.targets.diagnostics import split_rhat

        assert abs(split_rhat(self._iid_chains()) - 1.0) < 0.02

    def test_split_rhat_detects_disagreeing_chains(self):
        from ecnf_jax.targets.diagnostics import split_rhat

        x = self._iid_chains()
        x[0] += 5.0  # one chain stuck in a different mode
        assert split_rhat(x) > 1.2

    def test_split_rhat_detects_nonstationarity(self):
        from ecnf_jax.targets.diagnostics import split_rhat

        # Every chain drifts identically: between-half variance blows up
        # even though the chains agree with each other.
        x = self._iid_chains() + np.linspace(0, 6, 400)[None, :]
        assert split_rhat(x) > 1.2

    def test_bulk_ess_iid_close_to_n(self):
        from ecnf_jax.targets.diagnostics import bulk_ess

        x = self._iid_chains(c=8, s=500)
        ess = bulk_ess(x)
        assert 0.5 * x.size < ess < 1.6 * x.size

    def test_bulk_ess_correlated_much_smaller(self):
        from ecnf_jax.targets.diagnostics import bulk_ess

        rng = np.random.default_rng(1)
        c, s, rho = 8, 800, 0.97
        x = np.zeros((c, s))
        x[:, 0] = rng.normal(size=c)
        for t in range(1, s):
            x[:, t] = rho * x[:, t - 1] + np.sqrt(1 - rho**2) * rng.normal(size=c)
        assert bulk_ess(x) < 0.15 * x.size

    def test_mean_pairwise_distance(self):
        from ecnf_jax.targets.diagnostics import mean_pairwise_distance

        # Unit square: 4 sides of 1 + 2 diagonals of sqrt(2), mean over 6.
        square = np.array(
            [[[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]]]
        )
        expect = (4 * 1.0 + 2 * np.sqrt(2.0)) / 6.0
        np.testing.assert_allclose(mean_pairwise_distance(square), [expect])

    def test_mcmc_diagnostics_report(self):
        from ecnf_jax.targets.diagnostics import mcmc_diagnostics

        rng = np.random.default_rng(2)
        data = rng.normal(size=(8 * 100, 4, 2))
        rep = mcmc_diagnostics(
            data, n_chains=8, log_prob_fn=lambda x: -np.asarray(x**2).sum((-1, -2))
        )
        for k in ("rhat_energy", "rhat_dist", "ess_energy", "ess_dist"):
            assert k in rep and np.isfinite(rep[k])
        assert rep["rhat_energy"] < 1.05

    def test_generation_gate_rejects_stuck_chains(self):
        from ecnf_jax.targets.data import _gate_on_mixing

        rng = np.random.default_rng(3)
        data = rng.normal(size=(8 * 100, 4, 2))
        data[:100] += 7.0  # first chain far away
        with pytest.raises(AssertionError, match="did not converge"):
            _gate_on_mixing(
                "TEST", data, n_chains=8,
                log_prob_fn=lambda x: -np.asarray(x**2).sum((-1, -2)),
            )
