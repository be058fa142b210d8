"""Data-fidelity study for the HMC-regenerated DW4/LJ13 datasets.

Produces the evidence BASELINE.md cites for replacing the reference's
en_flows blobs (`/root/reference/ecnf/targets/data.py:37-38,61-62`) with
regenerated samples:

1. Convergence diagnostics (split-R̂, bulk ESS, per-chain energy trace
   spread) of the SHIPPED `data/{dw4,lj13}_generated.npy` blobs.
2. Multi-seed agreement: re-run the generation config with independent
   seeds; compare mean energy / mean pairwise distance across seeds and
   the L1 distance between normalized pairwise-distance histograms.
3. A longer LJ13 "gold" run (4x burn-in, 2x thinning) compared with the
   default config — evidence the default is already equilibrated.

Run (CPU is fine, ~minutes):
    JAX_PLATFORMS=cpu python scripts/mcmc_fidelity_study.py
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import numpy as np

from ecnf_jax.targets.diagnostics import (
    mcmc_diagnostics,
    mean_pairwise_distance,
)
from ecnf_jax.targets.energies import double_well_log_prob, lennard_jones_log_prob
from ecnf_jax.targets.mcmc import run_hmc, icosahedron_with_center

REPO = Path(__file__).resolve().parent.parent
N_CHAINS = 64


def hist_l1(a: np.ndarray, b: np.ndarray, bins=60, lo=0.0, hi=4.0) -> float:
    """L1 distance between normalized histograms of two samples."""
    ha, _ = np.histogram(a, bins=bins, range=(lo, hi), density=True)
    hb, _ = np.histogram(b, bins=bins, range=(lo, hi), density=True)
    width = (hi - lo) / bins
    return float(np.abs(ha - hb).sum() * width)


def run_dw4(seed: int) -> np.ndarray:
    samples, acc = run_hmc(
        double_well_log_prob,
        jax.random.PRNGKey(seed),
        n_samples_per_chain=200, n_chains=N_CHAINS, n_nodes=4, dim=2,
        step_size=0.12, n_leapfrog=15, burn_in=2000, thin=20, init_scale=1.0,
    )
    print(f"  dw4 seed={seed}: acceptance {float(acc):.3f}")
    return np.asarray(samples, dtype=np.float64)


def run_lj13(seed: int, burn_in=6000, thin=20) -> np.ndarray:
    key_init, key_run = jax.random.split(jax.random.PRNGKey(seed))
    x0 = icosahedron_with_center(N_CHAINS, key_init, noise=0.03)
    samples, acc = run_hmc(
        lennard_jones_log_prob,
        key_run,
        n_samples_per_chain=120, n_chains=N_CHAINS, n_nodes=13, dim=3,
        step_size=0.012, n_leapfrog=40, burn_in=burn_in, thin=thin,
        init_positions=x0,
    )
    print(f"  lj13 seed={seed} burn={burn_in} thin={thin}: acceptance {float(acc):.3f}")
    return np.asarray(samples, dtype=np.float64)


def summarize(name: str, data: np.ndarray, log_prob_fn) -> dict:
    rep = mcmc_diagnostics(data, n_chains=N_CHAINS, log_prob_fn=log_prob_fn)
    # Per-chain mean-energy spread: max |chain mean - global mean| in units
    # of the cross-chain standard error (an outlier-chain detector).
    by_chain = data.reshape(N_CHAINS, -1, *data.shape[1:])
    e_chain = np.array([-np.asarray(log_prob_fn(c)).mean() for c in by_chain])
    spread = np.abs(e_chain - e_chain.mean()) / max(e_chain.std(ddof=1), 1e-12)
    rep["max_chain_energy_z"] = float(spread.max())
    print(f"  {name}: " + ", ".join(f"{k}={v:.4g}" for k, v in sorted(rep.items())))
    return rep


def cross_seed(name: str, runs: dict, log_prob_fn) -> None:
    seeds = sorted(runs)
    print(f"  {name} cross-seed agreement:")
    stats = {}
    for s in seeds:
        d = runs[s]
        stats[s] = {
            "mean_energy": float(-np.asarray(log_prob_fn(d)).mean()),
            "mean_dist": float(mean_pairwise_distance(d).mean()),
        }
        print(f"    seed {s}: mean energy {stats[s]['mean_energy']:.4f}, "
              f"mean dist {stats[s]['mean_dist']:.4f}")
    base = seeds[0]
    d_base = mean_pairwise_distance(runs[base]).ravel()
    # Flatten to per-pair distances for the histogram comparison.
    for s in seeds[1:]:
        l1 = hist_l1(
            _all_pair_distances(runs[base]), _all_pair_distances(runs[s])
        )
        de = abs(stats[s]["mean_energy"] - stats[base]["mean_energy"])
        print(f"    seed {s} vs {base}: |d mean energy|={de:.4f}, "
              f"pairwise-distance hist L1={l1:.4f}")


def _all_pair_distances(x: np.ndarray) -> np.ndarray:
    diff = x[:, :, None, :] - x[:, None, :, :]
    dist = np.sqrt((diff**2).sum(-1))
    n = x.shape[1]
    iu = np.triu_indices(n, k=1)
    return dist[:, iu[0], iu[1]].ravel()


def main() -> None:
    t0 = time.time()

    print("== shipped blobs ==")
    dw4_shipped = np.load(REPO / "data/dw4_generated.npy")
    lj13_shipped = np.load(REPO / "data/lj13_generated.npy")
    summarize("dw4 shipped", dw4_shipped, double_well_log_prob)
    summarize("lj13 shipped", lj13_shipped, lennard_jones_log_prob)

    print("== DW4 multi-seed ==")
    dw4_runs = {2023: dw4_shipped}
    for seed in (7, 1234):
        d = run_dw4(seed)
        summarize(f"dw4 seed {seed}", d, double_well_log_prob)
        dw4_runs[seed] = d
    cross_seed("dw4", dw4_runs, double_well_log_prob)

    print("== LJ13 multi-seed ==")
    lj13_runs = {13: lj13_shipped}
    for seed in (7, 1234):
        d = run_lj13(seed)
        summarize(f"lj13 seed {seed}", d, lennard_jones_log_prob)
        lj13_runs[seed] = d
    cross_seed("lj13", lj13_runs, lennard_jones_log_prob)

    print("== LJ13 gold (4x burn-in, 2x thin) vs default ==")
    gold = run_lj13(99, burn_in=24000, thin=40)
    summarize("lj13 gold", gold, lennard_jones_log_prob)
    l1 = hist_l1(_all_pair_distances(lj13_shipped), _all_pair_distances(gold))
    de = abs(
        float(-np.asarray(lennard_jones_log_prob(gold)).mean())
        - float(-np.asarray(lennard_jones_log_prob(lj13_shipped)).mean())
    )
    print(f"  gold vs shipped: |d mean energy|={de:.4f}, hist L1={l1:.4f}")

    print(f"total {time.time() - t0:.0f}s")


if __name__ == "__main__":
    main()
