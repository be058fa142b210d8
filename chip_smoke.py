"""Smoke test of the main path on one NVIDIA GPU, checked against a plain
float32 reference on the same card.

    python chip_smoke.py           # one card: phases device .. compare
    python chip_smoke.py --multi   # four cards: the data-parallel phase only

Phases (one card), each printing one line of its own figures:

1. ``device``  — refuse anything but a GPU; print the card, JAX, XLA_FLAGS.
2. ``train``   — `examples/configs/qm9.yaml` (19 atoms, 5 EGNN blocks of
   [256]x4, bf16 MLPs, EMA, batch 256, microbatch 4) through
   `load_config` / `setup_training` / `run_training` on seeded synthetic
   positions: two dispatches, a checkpoint, then a resume for one more.
3. ``sample_exact`` — LJ13 width (13 particles, 3 blocks of [128]x3),
   `sample_and_log_prob_cnf` with the exact trace on the hand tangent,
   fixed-step rk4 at 0.05, batch 48, in bf16 and in f32.
4. ``sample_hutch`` — QM9 width, Hutchinson K=4, fixed-step dopri5, batch
   64; plus one adaptive Dopri5 `get_log_prob` at batch 16.
5. ``compare`` — each timed path against the reference: float32 MLPs under
   ``jax.default_matmul_precision("highest")``, `jax.linearize` for the
   trace (``structured_tangent=False``), same ``x0`` and steps.

``--multi`` runs the sharded QM9 update and the sharded exact-trace eval on
a 4-card mesh against the same computation on one card, and restores a
4-card checkpoint onto 2 cards.

The sampling phases scale the random phi_x output heads up (``HEAD_SCALE``)
so that the field, and with it the trace, is O(1) as in a trained model:
at initialization the head's 0.001 variance scaling leaves the field near
zero, and every comparison would pass trivially.  (At QM9 width a scale
of 100 makes the fixed-step solve diverge, hence the smaller one there.)

The last stdout line is one JSON object: ``{"ok": true, "device": {...}}``.
Any failure raises (non-zero exit, no JSON line).
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from dataclasses import dataclass
from functools import partial
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
RUN_DIR = REPO / "runs" / "chip_smoke"
HEAD_SCALE = {"lj13": 100.0, "qm9": 30.0}  # phi_x head scale (see above)

# Tolerances on relative errors, each with its reason (PERF.md lists them):
TOL = {
    # float32 MLP dots at default precision run in TF32 (10-bit mantissa).
    "tf32": 1e-2,
    # bf16 MLP compute (8-bit mantissa) against the f32 reference.
    "bf16": 5e-2,
    # Same math, same precision: only the summation order differs.
    "order": 1e-4,
    # Equivariance of the timed field: geometry runs at HIGHEST, so only
    # rounding of the rotated invariants inside the MLPs remains.
    "equiv_tf32": 5e-3,
    "equiv_bf16": 3e-2,
    # bf16 gradients against f32: each edge's cotangent is rounded to bf16
    # before the sum over B*N^2 edges, and the bias gradients are small
    # differences of large sums (0.27 relative L2 measured on the CPU at
    # batch 64) — a sanity bound, not a precision claim.
    "bf16_grad": 5e-1,
    # block_until_ready against device_get timing of the same call.
    "sync": 2e-2,
}


@dataclass(frozen=True)
class Sizes:
    """Widths and batches of the phases (the real ones by default; the CPU
    rehearsal shrinks them)."""

    lj13: tuple = (13, 3, (128, 128, 128), 64)  # nodes, blocks, units, hidden
    qm9: tuple = (19, 5, (256, 256, 256, 256), 32)
    lj13_batch: int = 48
    hutch_batch: int = 64
    adaptive_batch: int = 16
    train_batch: int = 256
    reps: int = 5


def log(name: str, **figures) -> None:
    print(f"{name}: " + " ".join(f"{k}={v}" for k, v in figures.items()), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def rel(a, b, scale=None) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    s = np.max(np.abs(b)) if scale is None else scale
    return float(np.max(np.abs(a - b)) / max(s, 1e-30))


def check(errors: dict) -> str:
    """Format ``name=err/tol`` pairs and fail on any error above its tol."""
    bad = {k: v for k, v in errors.items() if not v[0] <= TOL[v[1]]}
    text = " ".join(f"{k}={v[0]:.3e}/{TOL[v[1]]:.0e}({v[1]})" for k, v in errors.items())
    if bad:
        raise AssertionError(f"errors above tolerance: {text}")
    return text


def timed(fn, *args, reps: int):
    """Compile + first call, then ``reps`` block_until_ready-timed calls."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    t1 = time.perf_counter()
    out = jax.block_until_ready(compiled(*args))
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t)
    return compiled, out, t1 - t0, times


def build(width, compute_dtype, n_features=1, sigma_min=0.01, base_scale=1.0):
    from ecnf_jax.cnf.build import build_cnf

    n, blocks, units, hidden = width
    return build_cnf(
        n_frames=n, dim=3, sigma_min=sigma_min, base_scale=base_scale,
        n_blocks_egnn=blocks, mlp_units=units, n_invariant_feat_hidden=hidden,
        time_embedding_dim=8, n_features=n_features, compute_dtype=compute_dtype,
    )


def init_params(cnf, n, seed, head_scale=None):
    """Random params from ``seed``; ``head_scale`` multiplies each block's
    phi_x output kernel."""
    import jax
    import jax.numpy as jnp

    params = cnf.init(
        jax.random.PRNGKey(seed), jnp.zeros((2, n * 3)), jnp.zeros(2),
        jnp.zeros((2, n), jnp.int32),
    )
    if head_scale:
        egnn = params["params"]["EGNN_0"]
        for name, block in egnn.items():
            if name.startswith("EGCL_"):
                block["Dense_0"]["kernel"] = block["Dense_0"]["kernel"] * head_scale
    return params


def require_finite(name, *arrays):
    import jax.numpy as jnp

    for a in arrays:
        if not bool(jnp.all(jnp.isfinite(a))):
            raise AssertionError(f"{name}: non-finite output")


def qm9_positions(n_samples: int, seed: int):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n_samples, 19, 3)).astype(np.float32) * 1.5
    return pos - pos.mean(axis=1, keepdims=True)


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------


def phase_device(expected_count: int):
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke needs a GPU; JAX found {dev.platform!r}")
    if len(jax.devices()) < expected_count:
        raise SystemExit(f"need {expected_count} GPUs, found {len(jax.devices())}")
    log("device", kind=repr(dev.device_kind), count=len(jax.devices()),
        jax=jax.__version__, xla_flags=repr(os.environ.get("XLA_FLAGS", "")))
    print(f"card: {card_line()}", flush=True)


def _ensure_qm9_data():
    import importlib.util

    if not (REPO / "data" / "qm9pos_train.npy").exists():
        spec = importlib.util.spec_from_file_location(
            "make_synthetic_qm9", REPO / "scripts" / "make_synthetic_qm9.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.main(str(REPO / "data"))


def phase_train():
    import jax

    from ecnf_jax.targets.data import load_qm9
    from ecnf_jax.training.config import load_config
    from ecnf_jax.training.loop import run_training
    from ecnf_jax.training.setup import setup_training

    _ensure_qm9_data()
    shutil.rmtree(RUN_DIR, ignore_errors=True)

    def load_dataset(train_size, test_size):
        train, _, test = load_qm9(train_set_size=train_size, allow_synthetic=True)
        return train, test[:test_size]

    def configure(n_iter, resume):
        return load_config(
            str(REPO / "examples" / "configs" / "qm9.yaml"),
            overrides=[
                f"training.n_training_iter={n_iter}",
                "training.eval_plots=false",
                f"training.save_dir={RUN_DIR}",
                f"training.resume={'true' if resume else 'false'}",
            ],
        )

    t0 = time.perf_counter()
    tc = setup_training(configure(2, False), load_dataset)
    logger, state = run_training(tc)
    first_s = time.perf_counter() - t0
    losses = [float(x) for x in logger.history["loss"]]

    # Steady state: the compiled one-epoch program again, timed.
    t = time.perf_counter()
    state, infos = tc.update_state(state)
    jax.block_until_ready(state)
    epoch_s = time.perf_counter() - t
    steps = int(np.asarray(infos["loss"]).shape[0])

    t0 = time.perf_counter()
    logger2, _ = run_training(setup_training(configure(3, True), load_dataset))
    resume_s = time.perf_counter() - t0
    resumed = [float(x) for x in logger2.history["loss"]]
    ckpts2 = sorted(os.listdir(RUN_DIR / "model_checkpoints"))
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    if not (np.all(np.isfinite(losses)) and np.all(np.isfinite(resumed))):
        raise AssertionError(f"non-finite training loss: {losses} {resumed}")
    if not resumed or ckpts2[-1] != "state_00000002":
        raise AssertionError(f"resume did not run one more dispatch: {ckpts2}")
    log("train", steps_per_dispatch=steps, losses_first_last=(losses[0], losses[-1]),
        n_losses=len(losses), resumed_losses_first_last=(resumed[0], resumed[-1]),
        checkpoints=ckpts2, steps_per_s=round(steps / epoch_s, 3),
        first_run_s=round(first_s, 1), resume_run_s=round(resume_s, 1),
        peak_bytes_in_use=peak)


def phase_sample_exact(sizes: Sizes, results: dict):
    import jax

    from ecnf_jax.cnf.sampling import SolveConfig, sample_and_log_prob_cnf

    n = sizes.lj13[0]
    B = sizes.lj13_batch
    cfg = SolveConfig(use_fixed_step_size=True, step_size=0.05, method="rk4")
    feats = jax.numpy.zeros((B, n), jax.numpy.int32)
    key = jax.random.PRNGKey(1)
    figures = {}
    for dtype in ("bfloat16", None):
        cnf = build(sizes.lj13, dtype)
        params = init_params(cnf, n, seed=0, head_scale=HEAD_SCALE["lj13"])
        fn = lambda p, k: sample_and_log_prob_cnf(  # noqa: E731
            cnf, p, k, B, features=feats, cfg=cfg)
        compiled, out, compile_s, times = timed(fn, params, key, reps=sizes.reps)
        name = "bf16" if dtype else "f32"
        require_finite(f"sample_exact[{name}]", *out)
        results[f"lj13_{name}"] = (cnf, params, out)
        figures[f"{name}_compile_s"] = round(compile_s, 1)
        figures[f"{name}_best_ms"] = round(min(times) * 1e3, 2)
        figures[f"{name}_samples_per_s"] = round(B / min(times), 1)
        if dtype is None:
            # One-time check that block_until_ready covers execution: the
            # same call timed to a device_get of its result.
            bur, dg = [], []
            for _ in range(2 * sizes.reps):
                t = time.perf_counter()
                jax.block_until_ready(compiled(params, key))
                t1 = time.perf_counter()
                jax.device_get(compiled(params, key))
                bur.append(t1 - t)
                dg.append(time.perf_counter() - t1)
            gap = abs(min(bur) - min(dg)) / min(dg)
            figures["bur_vs_device_get"] = check({"sync_gap": (gap, "sync")})
    results["lj13_setup"] = (feats, key, cfg, B)
    log("sample_exact", batch=B, **figures)


def phase_sample_hutch(sizes: Sizes, results: dict):
    import jax
    import jax.numpy as jnp

    from ecnf_jax.cnf.sampling import SolveConfig, get_log_prob, sample_and_log_prob_cnf

    n = sizes.qm9[0]
    B = sizes.hutch_batch
    cfg = SolveConfig(use_fixed_step_size=True, step_size=0.05, method="dopri5",
                      hutchinson_probes=4)
    cnf = build(sizes.qm9, "bfloat16", sigma_min=1e-6, base_scale=2.0)
    params = init_params(cnf, n, seed=2, head_scale=HEAD_SCALE["qm9"])
    feats = jnp.zeros((B, n), jnp.int32)
    key = jax.random.PRNGKey(3)
    fn = lambda p, k: sample_and_log_prob_cnf(  # noqa: E731
        cnf, p, k, B, features=feats, approx=True, cfg=cfg)
    _, out, compile_s, times = timed(fn, params, key, reps=sizes.reps)
    require_finite("sample_hutch", *out)
    results["hutch"] = (cnf, params, out, feats, key, cfg, B)

    Ba = sizes.adaptive_batch
    x = jnp.asarray(qm9_positions(Ba, seed=4).reshape(Ba, -1))
    acfg = SolveConfig(hutchinson_probes=4)  # adaptive Dopri5, rtol=atol=1e-5
    afn = lambda p, xb, k: get_log_prob(  # noqa: E731
        cnf, p, xb, k, jnp.zeros((Ba, n), jnp.int32), approx=True, cfg=acfg,
        return_stats=True)
    _, aout, acompile_s, atimes = timed(afn, params, x, key, reps=2)
    require_finite("sample_hutch[adaptive]", aout[0])
    stats = aout[3]
    results["adaptive"] = (x, acfg, aout)
    log("sample_hutch", batch=B, compile_s=round(compile_s, 1),
        best_ms=round(min(times) * 1e3, 2), samples_per_s=round(B / min(times), 1),
        adaptive_batch=Ba, adaptive_compile_s=round(acompile_s, 1),
        adaptive_best_ms=round(min(atimes) * 1e3, 2),
        adaptive_steps=int(stats.num_steps), adaptive_attempts=int(stats.num_attempts))


def phase_compare(sizes: Sizes, results: dict):
    import jax
    import jax.numpy as jnp

    from ecnf_jax.cnf.loss import flow_matching_loss_fn
    from ecnf_jax.cnf.sampling import SolveConfig, get_log_prob, sample_and_log_prob_cnf
    from ecnf_jax.ops.divergence import value_and_exact_divergence
    from ecnf_jax.utils.test_utils import random_rotation_matrix

    highest = partial(jax.default_matmul_precision, "highest")
    errors = {}

    # 1. Phase 3 samples and log-densities, f32 and bf16, against the f32
    #    linearize reference (same key -> same x0, same rk4 steps).
    feats, key, cfg, B = results["lj13_setup"]
    ref_cnf = build(sizes.lj13, None)
    _, params, _ = results["lj13_f32"]
    ref_cfg = SolveConfig(use_fixed_step_size=True, step_size=0.05, method="rk4",
                          structured_tangent=False)
    with highest():
        x_ref, lq_ref = jax.jit(lambda p, k: sample_and_log_prob_cnf(
            ref_cnf, p, k, B, features=feats, cfg=ref_cfg))(params, key)
        x0, lpb = jax.jit(lambda k: ref_cnf.sample_and_log_prob_base(
            jax.random.split(k)[0], (B,)))(key)
    delta_scale = float(jnp.max(jnp.abs(lpb - lq_ref)))
    move_scale = float(jnp.max(jnp.abs(x_ref - x0)))
    for name, tol in (("f32", "tf32"), ("bf16", "bf16")):
        x1, lq = results[f"lj13_{name}"][2]
        errors[f"lj13_{name}_logq"] = (rel(lq, lq_ref, delta_scale), tol)
        errors[f"lj13_{name}_x1"] = (rel(x1, x_ref, move_scale), tol)

    # 2. Hand tangent divergence vs jax.linearize at the same precision, at
    #    one state of the LJ13 solve.
    t = jnp.full((B,), 0.5)
    basis, off = ref_cnf.exact_trace_plan(params)
    with highest():
        _, div_hand = jax.jit(lambda p, xx: ref_cnf.tangent_value_and_div(
            p, xx, t, feats, basis, trace_offset=off))(params, x_ref)
        _, div_lin = jax.jit(lambda p, xx: value_and_exact_divergence(
            lambda xb: ref_cnf.apply(p, xb, t, feats), xx, basis=basis,
            trace_offset=off))(params, x_ref)
    errors["tangent_vs_linearize"] = (rel(div_hand, div_lin), "order")

    # 3. Phase 4: Hutchinson K=4 fixed dopri5 (same probes) and adaptive.
    cnf, hparams, (hx1, hlq), hfeats, hkey, hcfg, HB = results["hutch"]
    href_cnf = build(sizes.qm9, None, sigma_min=1e-6, base_scale=2.0)
    href_cfg = SolveConfig(use_fixed_step_size=True, step_size=0.05, method="dopri5",
                           hutchinson_probes=4, structured_tangent=False)
    with highest():
        hx_ref, hlq_ref = jax.jit(lambda p, k: sample_and_log_prob_cnf(
            href_cnf, p, k, HB, features=hfeats, approx=True, cfg=href_cfg))(hparams, hkey)
        hx0, hlpb = jax.jit(lambda k: href_cnf.sample_and_log_prob_base(
            jax.random.split(k)[0], (HB,)))(hkey)
    errors["qm9_hutch_logq"] = (
        rel(hlq, hlq_ref, float(jnp.max(jnp.abs(hlpb - hlq_ref)))), "bf16")
    errors["qm9_hutch_x1"] = (
        rel(hx1, hx_ref, float(jnp.max(jnp.abs(hx_ref - hx0)))), "bf16")
    x, acfg, (alp, albase, adelta, _) = results["adaptive"]
    n = sizes.qm9[0]
    aref_cfg = SolveConfig(hutchinson_probes=4, structured_tangent=False)
    with highest():
        alp_ref, _, adelta_ref, astats_ref = jax.jit(lambda p, xb, k: get_log_prob(
            href_cnf, p, xb, k, jnp.zeros((xb.shape[0], n), jnp.int32), approx=True,
            cfg=aref_cfg, return_stats=True))(hparams, x, hkey)
    errors["qm9_adaptive_logp"] = (
        rel(alp, alp_ref, float(jnp.max(jnp.abs(adelta_ref)))), "bf16")

    # 4. Loss and gradient of one QM9 update step (flow-matching loss and
    #    its gradient at batch 256): the timed bf16 step against the same
    #    step under highest, the f32 step at default precision (TF32)
    #    against highest, and bf16 against the f32 reference.
    qcnf = build(sizes.qm9, "bfloat16", sigma_min=1e-6, base_scale=2.0)
    qparams = init_params(qcnf, n, seed=5)
    TB = sizes.train_batch
    xd = jnp.asarray(qm9_positions(TB, seed=6).reshape(TB, -1))
    fd = jnp.zeros((TB, n), jnp.int32)
    lkey = jax.random.PRNGKey(7)

    def loss_and_grad(c, precision=None):
        fn = jax.jit(lambda p: jax.value_and_grad(
            flow_matching_loss_fn, argnums=1, has_aux=True)(c, p, xd, lkey, fd))
        with jax.default_matmul_precision(precision):
            (loss, _), grads = fn(qparams)
        flat = jnp.concatenate([a.ravel() for a in jax.tree_util.tree_leaves(grads)])
        return float(loss), flat

    def grad_errors(name, got, want, tol, grad_tol=None):
        errors[f"{name}_loss"] = (abs(got[0] - want[0]) / abs(want[0]), tol)
        errors[f"{name}_grad_l2"] = (
            float(jnp.linalg.norm(got[1] - want[1]) / jnp.linalg.norm(want[1])),
            grad_tol or tol)

    bf16_step = loss_and_grad(qcnf)
    f32_ref = loss_and_grad(href_cnf, "highest")
    grad_errors("qm9_step_bf16_vs_highest", bf16_step, loss_and_grad(qcnf, "highest"), "tf32")
    grad_errors("qm9_step_f32_vs_highest", loss_and_grad(href_cnf), f32_ref, "tf32")
    grad_errors("qm9_step_bf16_vs_f32", bf16_step, f32_ref, "bf16", "bf16_grad")

    # 5. Equivariance on the card: f(R x + s) = R f(x) - s for the timed
    #    field (QM9 width), f32 at default precision and bf16.
    R = random_rotation_matrix(jax.random.PRNGKey(8), 3)
    s = jnp.array([3.0, -2.0, 1.0])
    xe = jnp.asarray(qm9_positions(HB, seed=9))
    te = jnp.linspace(0.05, 0.95, HB)
    for name, dtype, tol in (("f32", None, "equiv_tf32"), ("bf16", "bfloat16", "equiv_bf16")):
        ecnf = build(sizes.qm9, dtype, sigma_min=1e-6, base_scale=2.0)
        f = jax.jit(lambda p, xx: ecnf.apply(p, xx.reshape(HB, -1), te, hfeats))
        out = f(hparams, xe).reshape(HB, n, 3)
        out_moved = f(hparams, xe @ R.T + s).reshape(HB, n, 3)
        errors[f"equivariance_{name}"] = (rel(out_moved, out @ R.T - s), tol)

    log("compare", errors=check(errors),
        adaptive_steps_ref=int(astats_ref.num_steps))


def phase_multi(sizes: Sizes):
    """Data parallelism on four cards against one card."""
    import jax
    import jax.numpy as jnp

    from ecnf_jax.cnf.sampling import SolveConfig, get_log_prob
    from ecnf_jax.parallel.mesh import data_sharded, get_mesh, replicated
    from ecnf_jax.training.checkpoints import restore_checkpoint, save_checkpoint
    from ecnf_jax.training.optim import build_optimizer
    from ecnf_jax.training.state import init_training_state, make_update_fn

    devs = jax.devices()[:4]
    meshes = {k: get_mesh(devs[:k]) for k in (1, 2, 4)}
    n = sizes.qm9[0]
    TB = sizes.train_batch
    cnf = build(sizes.qm9, "bfloat16", sigma_min=1e-6, base_scale=2.0)
    opt = build_optimizer(1e-4, use_schedule=False)
    xd = qm9_positions(2 * TB, seed=11).reshape(2 * TB, -1)
    fd = np.zeros((TB, n), np.int32)
    state0 = jax.device_get(init_training_state(
        cnf, opt, jax.random.PRNGKey(12), jnp.asarray(xd[:2]),
        jnp.asarray(fd[:2]), use_ema=True))

    compiled = {}

    def step(k, state, batch):
        """One mb4 update on the k-card mesh (compiled once per k)."""
        mesh = meshes[k]
        args = (jax.device_put(state, replicated(mesh)),
                jax.device_put(batch, data_sharded(mesh)),
                jax.device_put(fd, data_sharded(mesh)))
        if k not in compiled:
            upd = make_update_fn(cnf, opt, use_ema=True, mesh=mesh, microbatch=4)
            compiled[k] = upd.lower(*args).compile()
        t = time.perf_counter()
        new_state, info = jax.block_until_ready(compiled[k](*args))
        return new_state, info, time.perf_counter() - t

    errors, figures = {}, {}
    s4, i4, _ = step(4, state0, xd[:TB])
    s1, i1, _ = step(1, state0, xd[:TB])
    for key in ("loss", "grad_norm", "update_norm"):
        errors[f"update_{key}"] = (rel(i4[key], i1[key]), "bf16")
    errors["update_params"] = (rel(
        jnp.concatenate([a.ravel() for a in jax.tree_util.tree_leaves(s4.params)]),
        jnp.concatenate([a.ravel() for a in jax.tree_util.tree_leaves(s1.params)])),
        "bf16")

    # Where the microbatch chunks run (training/state.py reshapes the
    # sharded batch [B] -> [k, B/k]): the collectives XLA inserted, and the
    # step time on 4 cards against 1.
    hlo = compiled[4].as_text()
    figures["collectives_mb4"] = {
        op: hlo.count(f" {op}(") + hlo.count(f" {op}-start(")
        for op in ("all-reduce", "all-gather", "all-to-all", "collective-permute",
                   "reduce-scatter")
    }
    for k in (4, 1):
        times = [step(k, state0, xd[:TB])[2] for _ in range(sizes.reps)]
        figures[f"step_ms_{k}card"] = round(min(times) * 1e3, 2)

    # Sharded exact-trace eval (rk4 fixed step) on 4 cards vs 1 card.
    EB = sizes.hutch_batch
    xe = qm9_positions(EB, seed=13).reshape(EB, -1)
    fe = np.zeros((EB, n), np.int32)
    cfg = SolveConfig(use_fixed_step_size=True, step_size=0.05, method="rk4")
    lps = {}
    for k in (4, 1):
        mesh = meshes[k]
        ev = jax.jit(
            partial(get_log_prob, cnf, approx=False, cfg=cfg),
            in_shardings=(replicated(mesh), data_sharded(mesh), replicated(mesh),
                          data_sharded(mesh)),
            out_shardings=replicated(mesh))
        lps[k] = ev(jax.device_put(s1.params, replicated(mesh)), xe,
                    jax.random.PRNGKey(14), fe)
    errors["eval_logp"] = (rel(lps[4][0], lps[1][0], float(np.max(np.abs(lps[1][2])))),
                           "bf16")

    # Checkpoint on 4 cards, restore onto 2, continue one step on each.
    ckpt_dir = RUN_DIR / "multi"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    path = save_checkpoint(str(ckpt_dir), 1, s4)
    target = jax.device_put(jax.tree_util.tree_map(np.zeros_like, state0),
                            replicated(meshes[2]))
    restored = restore_checkpoint(path, target)
    same = all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(
        jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(s4)))
    if not same:
        raise AssertionError("4->2 restore changed the state")
    _, i2, _ = step(2, jax.device_get(restored), xd[TB:])
    _, i4b, _ = step(4, jax.device_get(s4), xd[TB:])
    errors["resume_4to2_loss"] = (rel(i2["loss"], i4b["loss"]), "bf16")
    log("multi", errors=check(errors), **figures)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--multi", action="store_true",
                        help="run the 4-card data-parallel phase only")
    args = parser.parse_args()
    count = 4 if args.multi else 1
    # Fail before touching the card when the repo's package is not beside us.
    sys.path.insert(0, str(REPO))
    import ecnf_jax  # noqa: F401
    import jax

    phase_device(count)

    sizes = Sizes()
    if args.multi:
        phase_multi(sizes)
    else:
        phase_train()
        results = {}
        phase_sample_exact(sizes, results)
        phase_sample_hutch(sizes, results)
        phase_compare(sizes, results)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
