"""Quality metrics with MC error bars (VERDICT r4 weak #2 / next-step 3).

BASELINE.md's quality numbers are single-seed point estimates, and they
visibly need uncertainty: LJ13 forward ESS read 9e-4 in one run and
6.9e-5 in a rerun of the SAME config; DW4 forward ESS moved 0.217->0.282.
"Matching NLL within MC error" is unfalsifiable until MC error is
measured.  This script quantifies, for a trained DW4/LJ13 checkpoint:

1. **Point-sampling (MC) error** — bootstrap CIs over the finite test set
   for mean test NLL and forward ESS, and over the finite model-sample
   set for reverse ESS.  This answers "how much would the number move
   with a different draw of the same size from the same distributions?"
   Forward ESS on heavy-tailed weights is expected to be the wide one:
   it is dominated by the largest |log_w| outliers.
2. **Eval-seed spread** — reverse-ESS across K independent model-sample
   seeds (test NLL and forward ESS are deterministic given the test set
   under exact-trace adaptive eval: no Hutchinson probes, no model
   samples — the eval key only seeds model draws).

Train-seed variance is the third axis, measured separately by retraining
(`scripts/seed_sweep.sh`) and evaluating each final checkpoint with this
same harness.

Reference eval semantics: `ecnf/utils/evaluation.py:10-22` (forward ESS),
`setup_training.py:166-185` (reverse ESS over model samples),
`:190-218` (test NLL).

Usage (on the GPU):
  python scripts/quality_error_bars.py dw4  runs/dw4_seed0/model_checkpoints
  python scripts/quality_error_bars.py lj13 runs/lj13_r4/model_checkpoints \
      --rv-samples 10000 --json measurements/r5/lj13_errbars.json
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))



import jax
import jax.numpy as jnp
import numpy as np

from ecnf_jax.cnf.build import build_cnf
from ecnf_jax.cnf.sampling import SolveConfig, get_log_prob, sample_and_log_prob_cnf
from ecnf_jax.targets.data import load_aldp, load_dw4, load_lj13
from ecnf_jax.targets.energies import double_well_log_prob, lennard_jones_log_prob
from ecnf_jax.training.checkpoints import get_latest_checkpoint, restore_checkpoint
from ecnf_jax.training.optim import build_optimizer
from ecnf_jax.training.state import init_training_state

# Shipped reference configs (`examples/configs/{dw4,lj13}.yaml`).
TARGETS = {
    "dw4": dict(
        n_nodes=4, dim=2, sigma_min=0.01, base_scale=1.0,
        n_blocks=3, mlp_units=(128, 128, 128), hidden=64, t_emb=8,
        load=lambda: load_dw4(1000), test_size=1000,
        log_prob=lambda flat: double_well_log_prob(flat.reshape(-1, 4, 2)),
        n_iter=200, batch=64, train_size=1000,
    ),
    "lj13": dict(
        n_nodes=13, dim=3, sigma_min=0.01, base_scale=1.0,
        n_blocks=3, mlp_units=(128, 128, 128), hidden=64, t_emb=8,
        load=lambda: load_lj13(1000), test_size=1000,
        log_prob=lambda flat: lennard_jones_log_prob(flat.reshape(-1, 13, 3)),
        n_iter=400, batch=64, train_size=1000,
    ),
    # ALDP has no tractable energy: NLL only (Hutchinson K=1 matching the
    # soak eval, `examples/configs/aldp_soak.yaml`), evaluated on the
    # DISJOINT last-400-frame split with the EMA parameters (the reference
    # swaps EMA in for the final eval, `setup_training.py:229-230`).
    # Hutchinson makes per-point log_q stochastic, so the harness also
    # reports the mean-NLL spread across 5 probe keys.
    "aldp": dict(
        n_nodes=22, dim=3, sigma_min=1e-6, base_scale=0.2,
        n_blocks=3, mlp_units=(64, 64), hidden=32, t_emb=8,
        load=lambda: load_aldp(
            train_path="data/aldp_500K_train_mini.h5",
            test_path="data/aldp_500K_train_mini.h5",
            train_n_points=1600, test_n_points=400, test_skip_n=1600,
        ),
        test_size=400, log_prob=None, n_iter=4000, batch=256,
        train_size=1600, n_features=22, approx=True, use_ema=True,
        peak_lr=2e-4, warmup=50,
    ),
}


def np_forward_ess(log_w: np.ndarray) -> float:
    """Numpy twin of `calculate_forward_ess` (log-domain, finite-masked)."""
    log_w = log_w[np.isfinite(log_w)]
    n = len(log_w)
    if n == 0:
        return float("nan")
    mx, mn = log_w.max(), (-log_w).max()
    log_z_inv = np.log(np.exp(-log_w - mn).sum()) + mn - np.log(n)
    log_z_p_over_q = np.log(np.exp(log_w - mx).sum()) + mx - np.log(n)
    return float(np.exp(-log_z_inv - log_z_p_over_q))


def np_reverse_ess(log_w: np.ndarray) -> float:
    """Numpy twin of `calculate_reverse_ess` (non-finite -> zero weight)."""
    n = len(log_w)
    log_w = np.where(np.isfinite(log_w), log_w, -np.inf)
    w = np.exp(log_w - log_w.max())
    p = w / w.sum()
    return float(1.0 / (p ** 2).sum() / n)


def bootstrap_ci(values: np.ndarray, stat_fn, n_boot: int, seed: int = 0,
                 alpha: float = 0.05):
    """Percentile bootstrap CI of `stat_fn` over axis-0 resamples."""
    rng = np.random.default_rng(seed)
    n = len(values)
    stats = np.array([
        stat_fn(values[rng.integers(0, n, size=n)]) for _ in range(n_boot)
    ])
    stats = stats[np.isfinite(stats)]
    lo, hi = np.percentile(stats, [100 * alpha / 2, 100 * (1 - alpha / 2)])
    return float(lo), float(hi), float(np.std(stats))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("target", choices=list(TARGETS))
    ap.add_argument("ckpt_dir")
    ap.add_argument("--eval-seeds", type=int, default=5)
    ap.add_argument("--rv-samples", type=int, default=2000)
    ap.add_argument("--rv-chunk", type=int, default=500,
                    help="model samples per device program")
    ap.add_argument("--nll-chunk", type=int, default=250)
    ap.add_argument("--n-boot", type=int, default=2000)
    ap.add_argument("--method", default="dopri5", choices=["dopri5", "rk4"])
    ap.add_argument("--fixed-step", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    t = TARGETS[args.target]
    cfg = SolveConfig(method=args.method,
                      use_fixed_step_size=args.fixed_step)

    train, valid, test = t["load"]()
    pos = test.positions[: t["test_size"]]
    pos = pos - pos.mean(axis=1, keepdims=True)
    test_flat = jnp.asarray(pos.reshape(len(pos), -1))
    feats = jnp.asarray(
        test.features[: t["test_size"]].reshape(len(pos), -1))

    cnf = build_cnf(
        n_frames=t["n_nodes"], dim=t["dim"], sigma_min=t["sigma_min"],
        base_scale=t["base_scale"], n_blocks_egnn=t["n_blocks"],
        mlp_units=t["mlp_units"], n_invariant_feat_hidden=t["hidden"],
        time_embedding_dim=t["t_emb"], n_features=t.get("n_features", 1),
        compute_dtype="bfloat16",
    )
    # Optimizer state must match the trainer's structure for restore
    # (schedule on, per the shipped configs).
    n_batches = t["train_size"] // t["batch"]
    optimizer = build_optimizer(
        1e-4, use_schedule=True, peak_lr=t.get("peak_lr", 1e-4),
        end_lr=0.0, n_iter_warmup=t.get("warmup", 10),
        n_iter_total=t["n_iter"] * n_batches,
    )
    state0 = init_training_state(
        cnf, optimizer, jax.random.PRNGKey(0), test_flat[:2], feats[:2],
        use_ema=t.get("use_ema", False),
    )
    latest = get_latest_checkpoint(args.ckpt_dir)
    assert latest, f"no checkpoint in {args.ckpt_dir}"
    print(f"restoring {latest}", flush=True)
    state = restore_checkpoint(latest, state0)
    # EMA-trained targets are evaluated at the EMA parameters, matching the
    # reference's final-iteration eval swap (`setup_training.py:229-230`).
    params = state.ema_params if t.get("use_ema") else state.params

    # ---- test NLL + forward ESS (deterministic: exact trace) ----
    nll_chunk = args.nll_chunk
    assert t["test_size"] % nll_chunk == 0

    approx = bool(t.get("approx", False))
    nll_fn = jax.jit(lambda x, f, k: get_log_prob(
        cnf, params, x, k, f, cfg=cfg, approx=approx))
    # Exact trace: one key (log_q deterministic).  Hutchinson (ALDP): the
    # per-point log_q is stochastic in the probe key, so run K keys and
    # report the mean-NLL spread across them alongside the point bootstrap.
    n_nll_keys = args.eval_seeds if approx else 1
    per_key_log_q = []
    t0 = time.perf_counter()
    for ki in range(n_nll_keys):
        key = jax.random.PRNGKey(ki)
        log_qs = []
        for i in range(0, t["test_size"], nll_chunk):
            log_q, _, _ = nll_fn(test_flat[i:i + nll_chunk],
                                 feats[i:i + nll_chunk], key)
            log_qs.append(np.asarray(jax.device_get(log_q), dtype=np.float64))
        per_key_log_q.append(np.concatenate(log_qs))
    log_q = per_key_log_q[0]
    print(f"NLL pass ({n_nll_keys} key(s)): {time.perf_counter() - t0:.1f}s "
          f"({np.isfinite(log_q).sum()}/{len(log_q)} finite)", flush=True)

    nll_mean = float(np.mean(log_q[np.isfinite(log_q)]))
    nll_lo, nll_hi, nll_sd = bootstrap_ci(
        log_q[np.isfinite(log_q)], np.mean, args.n_boot)
    nll_per_key = [float(np.mean(q[np.isfinite(q)])) for q in per_key_log_q]

    if t["log_prob"] is None:
        out = {
            "target": args.target,
            "checkpoint": latest,
            "method": args.method,
            "eval_params": "ema" if t.get("use_ema") else "raw",
            "nll_estimator": "hutchinson_k1" if approx else "exact",
            "n_test": int(t["test_size"]),
            "n_finite_log_q": int(np.isfinite(log_q).sum()),
            "test_log_lik": {
                "mean": round(nll_mean, 4),
                "ci95": [round(nll_lo, 4), round(nll_hi, 4)],
                "boot_sd": round(nll_sd, 5),
                "per_probe_key": [round(v, 4) for v in nll_per_key],
                "probe_key_sd": round(float(np.std(nll_per_key, ddof=1)), 5)
                if len(nll_per_key) > 1 else None,
            },
            "n_boot": args.n_boot,
        }
        print(json.dumps(out, indent=2), flush=True)
        if args.json:
            Path(args.json).parent.mkdir(parents=True, exist_ok=True)
            Path(args.json).write_text(json.dumps(out, indent=2) + "\n")
        return

    log_p = np.asarray(jax.device_get(t["log_prob"](test_flat)),
                       dtype=np.float64)
    log_w_fwd = log_p - log_q

    fess = np_forward_ess(log_w_fwd)
    fess_lo, fess_hi, fess_sd = bootstrap_ci(
        log_w_fwd, np_forward_ess, args.n_boot)

    # ---- reverse ESS: K eval seeds x bootstrap within seed 0 ----
    rv_chunk = args.rv_chunk
    assert args.rv_samples % rv_chunk == 0
    feats_rv = feats[:1].repeat(rv_chunk, 0)
    rv_fn = jax.jit(lambda k: sample_and_log_prob_cnf(
        cnf, params, k, rv_chunk, features=feats_rv, cfg=cfg))
    rv_ess_per_seed = []
    log_w_rev_seed0 = None
    t0 = time.perf_counter()
    for s in range(args.eval_seeds):
        keys = jax.random.split(jax.random.PRNGKey(1000 + s),
                                args.rv_samples // rv_chunk)
        lws = []
        for k in keys:
            samples, log_q_model = rv_fn(k)
            lp = t["log_prob"](samples)
            lws.append(np.asarray(jax.device_get(lp - log_q_model),
                                  dtype=np.float64))
        lw = np.concatenate(lws)
        rv_ess_per_seed.append(np_reverse_ess(lw))
        if s == 0:
            log_w_rev_seed0 = lw
    print(f"reverse-ESS pass ({args.eval_seeds} seeds x "
          f"{args.rv_samples}): {time.perf_counter() - t0:.1f}s", flush=True)
    rv_lo, rv_hi, rv_sd = bootstrap_ci(
        log_w_rev_seed0, np_reverse_ess, args.n_boot)

    rv_arr = np.array(rv_ess_per_seed)
    out = {
        "target": args.target,
        "checkpoint": latest,
        "method": args.method,
        "fixed_step": bool(args.fixed_step),
        "n_test": int(t["test_size"]),
        "n_finite_log_q": int(np.isfinite(log_q).sum()),
        "test_log_lik": {
            "mean": round(nll_mean, 4),
            "ci95": [round(nll_lo, 4), round(nll_hi, 4)],
            "boot_sd": round(nll_sd, 5),
        },
        "forward_ess": {
            "point": round(fess, 6),
            "ci95": [round(fess_lo, 6), round(fess_hi, 6)],
            "boot_sd": round(fess_sd, 6),
        },
        "reverse_ess": {
            "per_seed": [round(v, 6) for v in rv_ess_per_seed],
            "seed_mean": round(float(rv_arr.mean()), 6),
            "seed_sd": round(float(rv_arr.std(ddof=1)), 6),
            "within_seed_ci95": [round(rv_lo, 6), round(rv_hi, 6)],
            "n_model_samples": int(args.rv_samples),
        },
        "n_boot": args.n_boot,
    }
    print(json.dumps(out, indent=2), flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=2) + "\n")


if __name__ == "__main__":
    main()
