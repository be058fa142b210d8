"""QM9-flagship-scale stepper study: rk4 vs dopri5 on the Hutchinson eval path.

The LJ13/DW4 studies (`method_accuracy_study.py`, docs/PERF.md) showed
rk4 @ 0.05 matches fixed Dopri5 @ 0.05 per-point and costs 4/6 of the
field evaluations.  This repeats the question at the flagship scale
(19 atoms, D=57, 5-block [256]x4 EGNN, bf16) on the path the reference
actually uses for QM9 — approximate log-prob
(`/root/reference/examples/config/qm9.yaml: eval_exact_log_prob: false`,
Hutchinson `sample_and_log_prob.py:55,69-78`) — with K=4 probes:

  1. probe-identical agreement: `get_log_prob(approx, K=4)` under the
     SAME key for rk4 @ 0.05 vs dopri5 @ 0.05 — the per-point difference
     isolates the stepper, not the estimator noise;
  2. exact-trace deviation from the adaptive ground truth (tol 1e-5) on
     a smaller batch, as in the DW4 study;
  3. throughput: `sample_and_log_prob_cnf` (hutch K=4) rate at batch 64,
     rk4 vs dopri5.

Weights: the latest checkpoint under runs/qm9_soak_g64 (pass another dir
as argv[1]); falls back to random init (printed) if none exists — the
stepper-agreement question is still meaningful there, the field is just
untrained.

Usage: python scripts/qm9_stepper_study.py [ckpt_dir] 
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

from ecnf_jax.cnf.build import build_cnf
from ecnf_jax.cnf.sampling import SolveConfig, get_log_prob, sample_and_log_prob_cnf
from ecnf_jax.training.checkpoints import get_latest_checkpoint, restore_checkpoint
from ecnf_jax.training.optim import build_optimizer
from ecnf_jax.training.state import init_training_state

CKPT_DIR = sys.argv[1] if len(sys.argv) > 1 else "runs/qm9_soak_g64/model_checkpoints"
N_AGREE = 128   # probe-identical hutch-agreement batch
N_EXACT = 32    # exact-trace ground-truth batch (D=57 columns each)
N_RATE = 64     # throughput batch (bench suite setting)
REPS = 5
# Flagship net shape (examples/configs/qm9.yaml); shrink for CPU smokes.
N_BLOCKS = 5
MLP_UNITS = (256, 256, 256, 256)


def main():
    data = np.load(Path(__file__).resolve().parent.parent / "data/qm9pos_test.npy")
    data = data.reshape(data.shape[0], -1)[: max(N_AGREE, N_EXACT)]
    pos = data.reshape(-1, 19, 3)
    pos = pos - pos.mean(axis=1, keepdims=True)
    x = jnp.asarray(pos.reshape(pos.shape[0], -1), dtype=jnp.float32)
    feats = jnp.zeros((x.shape[0], 19), dtype=jnp.int32)

    cnf = build_cnf(
        n_frames=19, dim=3, sigma_min=1e-6, base_scale=2.0,
        n_blocks_egnn=N_BLOCKS, mlp_units=MLP_UNITS,
        n_invariant_feat_hidden=32, time_embedding_dim=8, n_features=1,
        compute_dtype="bfloat16",
    )
    opt = build_optimizer(
        1e-4, use_schedule=True, peak_lr=1e-4, end_lr=0.0,
        n_iter_warmup=10, n_iter_total=16000 * 25,
    )
    state0 = init_training_state(
        cnf, opt, jax.random.PRNGKey(0), x[:2], feats[:2], use_ema=True
    )
    latest = get_latest_checkpoint(CKPT_DIR) if Path(CKPT_DIR).is_dir() else None
    if latest:
        print("weights: restoring", latest)
        params = restore_checkpoint(latest, state0).params
    else:
        print(f"weights: no checkpoint under {CKPT_DIR} — RANDOM INIT")
        params = state0.params

    fixed = lambda method: SolveConfig(
        use_fixed_step_size=True, step_size=0.05, method=method,
        hutchinson_probes=4, structured_tangent=True,
    )

    # 1. Probe-identical hutch-K4 agreement, rk4 vs dopri5 (same key).
    key = jax.random.PRNGKey(7)
    hutch = {}
    for method in ("dopri5", "rk4"):
        lp = jax.jit(
            lambda xb, m=method: get_log_prob(
                cnf, params, xb, key, feats[:N_AGREE], approx=True, cfg=fixed(m)
            )[0]
        )(x[:N_AGREE])
        hutch[method] = np.asarray(jax.block_until_ready(lp))
        print(f"hutch4 {method:>7} @0.05: mean log_p {hutch[method].mean():.4f}")
    d = np.abs(hutch["rk4"] - hutch["dopri5"])
    print(
        f"hutch4 probe-identical |rk4 - dopri5|: mean {d.mean():.3e} "
        f"max {d.max():.3e}  (mean-NLL delta "
        f"{abs(hutch['rk4'].mean() - hutch['dopri5'].mean()):.3e})"
    )

    # 2. Exact-trace deviation from the adaptive ground truth.
    exact = {}
    for name, cfg in {
        "adaptive": SolveConfig(structured_tangent=True),
        "dopri5@0.05": SolveConfig(
            use_fixed_step_size=True, step_size=0.05, structured_tangent=True
        ),
        "rk4@0.05": SolveConfig(
            use_fixed_step_size=True, step_size=0.05, method="rk4",
            structured_tangent=True,
        ),
    }.items():
        lp = jax.jit(
            lambda xb, c=cfg: get_log_prob(
                cnf, params, xb, key, feats[:N_EXACT], cfg=c
            )[0]
        )(x[:N_EXACT])
        exact[name] = np.asarray(jax.block_until_ready(lp))
        tag = ""
        if name != "adaptive":
            dev = np.abs(exact[name] - exact["adaptive"])
            tag = f"  |d vs adaptive| mean {dev.mean():.3e} max {dev.max():.3e}"
        print(f"exact {name:>12}: mean log_p {exact[name].mean():.4f}{tag}")

    # 3. Throughput at the bench-suite setting (hutch4, batch 64).
    feats_r = jnp.zeros((N_RATE, 19), dtype=jnp.int32)
    for method in ("dopri5", "rk4"):
        run = jax.jit(
            lambda k, m=method: sample_and_log_prob_cnf(
                cnf, params, k, N_RATE, features=feats_r, approx=True,
                cfg=fixed(m),
            )
        )
        out = run(jax.random.PRNGKey(1))
        jax.block_until_ready(out)
        times = []
        for i in range(REPS):
            t0 = time.perf_counter()
            out = run(jax.random.PRNGKey(2 + i))
            jax.block_until_ready(out)
            times.append(time.perf_counter() - t0)
        rate = N_RATE / min(times)
        print(f"rate hutch4 {method:>7} @0.05 batch {N_RATE}: "
              f"{rate:.1f} samples/s ({min(times) * 1e3:.1f} ms)")


if __name__ == "__main__":
    main()
