"""Benchmark suite: LJ13 + QM9-scale headline numbers, one JSON line.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "extras"}.

Headline (`metric`/`value`): LJ13 flow samples *with* exact log-density —
the reference's most expensive inference path
(`ecnf/cnf/sample_and_log_prob.py:97-149`: Dopri5 + D-column exact trace
per stage) — run with fixed-step RK4 on the reference's 0.05 grid (equal
per-point accuracy to fixed Dopri5 at this grid on a trained model,
`scripts/method_accuracy_study.py`, PERF.md).

`extras` tracks, in the same JSON line:
  - `lj13_dopri5_reference_stepper`: the same task with the reference's
    own fixed-step Dopri5 — the PARITY number to quote when comparing
    against the reference stepper-for-stepper.
  - `qm9_sample_logprob_hutch4`: flagship-scale (19 atoms, D=57, 5-block
    [256]x4 EGNN) sampling with Hutchinson log-density (K=4 probes; the
    reference evaluates QM9 with approximate log-prob,
    `examples/config/qm9.yaml: eval_exact_log_prob: false`, fixed at K=1
    `sample_and_log_prob.py:55` — K=4 is this framework's recommended
    batch-mean setting, PERF.md estimator study).
  - `qm9_train_step`: flagship-scale training steps/s (batch 256, EMA,
    bf16), timed as a 100-step on-device `lax.scan` of the real update —
    the whole-epoch-jit path used by `training/setup.py`.

Timing: every rep is host wall-clock around a call that ends in
`jax.block_until_ready`; compilation is reported apart as cold start.
Measurements need a GPU: on any other platform a cell fails (and, in
suite mode, records an ``error``), it never falls back to the CPU.

vs_baseline: the reference cannot run here (diffrax/distrax absent, no
network), so baselines are this same program measured on a 2-core host CPU
(JAX_PLATFORMS=cpu python bench.py), per task and per stepper, at the
current defaults (rk4/batch 48, dopri5/batch 48) — historical figures kept
only so the ratio stays defined.  Override the headline baseline with
ECNF_BENCH_BASELINE.

Env knobs: ECNF_BENCH_TASK=suite|lj13_sample_logprob|qm9_sample_logprob|
qm9_train_step, ECNF_BENCH_EXTRAS=0 (headline only),
ECNF_BENCH_{BATCH,REPS,DTYPE,METHOD,TRACE_CHUNK,TANGENT,BASELINE}.
"""
import json
import os
import sys
import time

import jax
import jax.numpy as jnp

from ecnf_jax.utils.compile_cache import enable_persistent_compilation_cache

enable_persistent_compilation_cache()

# Host-CPU baselines for vs_baseline: the identical programs on a 2-core
# host CPU (JAX_PLATFORMS=cpu, bf16, best rep).  Keyed by (task, method) so
# the ratio always compares like with like.  Every entry is FLOP-audited
# against the jaxpr count (`ops/flops.py`): rate x TFLOP/run stays under
# that host's ~0.15 TFLOP/s matmul ceiling.
CPU_BASELINES = {
    ("lj13", "rk4"): 0.53,      # samples/s; 12.8 TF/run -> 0.141 TF/s OK
    ("lj13", "dopri5"): 0.36,   # samples/s; 19.4 TF/run -> 0.145 TF/s OK
    ("qm9_hutch4", "dopri5"): 0.15,  # samples/s; 66.4 TF/run (2026-08-21)
    ("qm9_hutch4", "rk4"): 0.25,     # samples/s; 43.9 TF/run (2026-08-21)
    # steps/s, batch 256, in the mb4 form (one-shot on that CPU: 0.028)
    ("qm9_train_step", ""): 0.04,
}

BATCH = int(os.environ.get("ECNF_BENCH_BATCH", "48"))
REPS = int(os.environ.get("ECNF_BENCH_REPS", "5"))
# The EGNN MLP stack runs in bf16 by default (geometry, aggregation and
# the ODE state stay f32).  Set ECNF_BENCH_DTYPE=float32 for the full-f32
# variant.
COMPUTE_DTYPE = os.environ.get("ECNF_BENCH_DTYPE", "bfloat16")
if COMPUTE_DTYPE in ("float32", "f32", ""):
    COMPUTE_DTYPE = None
TRACE_CHUNK = int(os.environ.get("ECNF_BENCH_TRACE_CHUNK", "0")) or None
# Hand-linearized trace (ops/tangent.py; default on).  Set =0 for
# jax.linearize.
TANGENT = os.environ.get("ECNF_BENCH_TANGENT", "1") not in ("", "0")
# Fixed-step method for the headline: rk4 (default; 4 instead of 6 field
# evals/step at equal log-density accuracy on the 0.05 grid) or dopri5
# (the reference's fixed-step stepper).
METHOD = os.environ.get("ECNF_BENCH_METHOD", "rk4")
TASK = os.environ.get("ECNF_BENCH_TASK", "suite")
EXTRAS = os.environ.get("ECNF_BENCH_EXTRAS", "1") not in ("", "0")

_BASELINE_ENV = os.environ.get("ECNF_BENCH_BASELINE")

# Side-channel per-benchmark details (run-to-run spread, MFU), keyed by the
# metric name each task reports under.  `main()` merges these into the JSON
# so drifts are classifiable as noise vs regression.  Tasks that are
# monkeypatched in tests simply leave no entry.
DETAILS = {}

# Cold-start (trace/compile/first-run) seconds per task, merged into DETAILS
# by `_record_details`.  The FIRST program traced in a process additionally
# pays one-time eager/init costs (import side effects, abstract-eval cache
# warmup) that land entirely on its trace number, so it is flagged.
_COLD_START = {}
_FIRST_TRACE_SEEN = [False]


def _note_cold_start(name: str, trace_s: float, compile_s: float,
                     first_run_s: float) -> None:
    entry = {
        "trace_s": round(trace_s, 2),
        "compile_s": round(compile_s, 2),
        "first_run_s": round(first_run_s, 2),
    }
    if not _FIRST_TRACE_SEEN[0]:
        entry["trace_includes_process_init"] = True
        _FIRST_TRACE_SEEN[0] = True
    _COLD_START[name] = entry


def _record_details(name: str, times, batch_per_run: float, flop_count=None):
    """Store spread (+ MFU when the FLOP count is while-free) for `name`."""
    from ecnf_jax.ops.flops import mfu

    n_dev = jax.device_count()
    rates = sorted((batch_per_run / t / n_dev for t in times), reverse=True)
    det = {
        "spread_min": round(rates[-1], 2),
        "spread_median": round(rates[len(rates) // 2], 2),
        "reps": len(rates),
    }
    if name in _COLD_START:
        det["cold_start"] = _COLD_START[name]
    if flop_count is not None:
        u = mfu(flop_count, min(times), jax.devices()[0].device_kind,
                n_devices=n_dev)
        if u is not None:
            if u > 1.05:
                # A computed utilization above chip peak means the timed
                # sync did not cover execution — fail loudly rather than
                # record garbage.
                raise RuntimeError(
                    f"{name}: computed MFU {u:.2f} exceeds chip peak — "
                    "invalid timing (the sync did not cover execution)")
            det["mfu"] = round(u, 4)
        if flop_count.has_while:
            # Adaptive solves trace a ONE-trip while body; the real run
            # executes an unknown trip count, so a plain "tflops" key would
            # massively understate the work.  Name it so no
            # consumer mistakes it for a full-run count (mfu is already
            # suppressed by `mfu()` in this case).
            det["tflops_one_trip"] = round(flop_count.total / 1e12, 3)
        else:
            det["tflops"] = round(flop_count.total / 1e12, 3)
    try:  # device-memory telemetry where the backend exposes it.
        # NOTE: the allocator's peak is PROCESS-lifetime (it cannot be
        # reset), so in suite mode this is the max over this and all
        # earlier benchmarks in the process — named accordingly so it
        # cannot be misread as a per-benchmark footprint.
        stats = jax.local_devices()[0].memory_stats()
        if stats is None:
            # Say so explicitly so a missing number is distinguishable
            # from "not measured".
            det["peak_hbm_process_gb"] = "unavailable(memory_stats=None)"
        else:
            peak = stats.get("peak_bytes_in_use")
            if peak:
                det["peak_hbm_process_gb"] = round(peak / 2**30, 3)
    except Exception:
        pass
    DETAILS[name] = det


def _count_flops(fn, *args):
    """Abstract-trace FLOP count; never let accounting kill a benchmark."""
    try:
        from ecnf_jax.ops.flops import count_fn_flops

        return count_fn_flops(fn, *args)
    except Exception as e:  # pragma: no cover - diagnostic only
        print(f"flop count failed: {e}", file=sys.stderr)
        return None


def _require_gpu() -> None:
    """Measurements run on the GPU only; no CPU fallback."""
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise RuntimeError(f"bench cells need a GPU; JAX found {platform!r}")


def _baseline(task: str, method: str):
    if task == "lj13" and _BASELINE_ENV:
        return float(_BASELINE_ENV)
    return CPU_BASELINES.get((task, method))


def _vs(per_chip: float, baseline) -> float:
    # vs_baseline must stay a number for the driver; 0.0 = "no baseline".
    return round(per_chip / baseline, 2) if baseline else 0.0


def _sharded_solve_rate(cnf, n_nodes: int, batch: int, cfg, approx: bool,
                        reps: int, label: str, detail_name: str = None) -> float:
    """samples/s/chip for a mesh-sharded `sample_and_log_prob_cnf` solve."""
    _require_gpu()
    from ecnf_jax.cnf.sampling import sample_and_log_prob_cnf
    from ecnf_jax.parallel.mesh import (
        get_mesh, data_sharded, replicated, pad_to_multiple,
    )

    feats = jnp.zeros((2, n_nodes), dtype=jnp.int32)
    x0 = jnp.zeros((2, n_nodes * 3))
    params = cnf.init(jax.random.PRNGKey(0), x0, jnp.zeros(2), feats)

    # Shard the batch over all chips (same GSPMD pattern as the training
    # eval paths): on 1 chip this is a no-op; on a multi-chip host the
    # solve parallelizes over the data axis instead of idling N-1 chips.
    mesh = get_mesh()
    padded = pad_to_multiple(batch, int(mesh.devices.size))
    if padded != batch:
        print(f"{label}: batch {batch} -> {padded} (rounded up to the mesh)",
              file=sys.stderr)
        batch = padded
    feats_b = jax.device_put(
        jnp.zeros((batch, n_nodes), dtype=jnp.int32), data_sharded(mesh)
    )

    # Params enter as a runtime ARGUMENT, never a closure constant:
    # captured params become XLA constants that XLA then constant-folds at
    # compile time (production semantics: params change per step).
    def run(p, key, feats_):
        return sample_and_log_prob_cnf(
            cnf, p, key, batch, features=feats_, approx=approx, cfg=cfg
        )

    run_jit = jax.jit(
        run,
        in_shardings=(replicated(mesh), replicated(mesh), data_sharded(mesh)),
        out_shardings=replicated(mesh),
    )

    t0 = time.perf_counter()
    lowered = run_jit.lower(params, jax.random.PRNGKey(1), feats_b)
    params = jax.device_put(params, replicated(mesh))  # once, not per call
    t1 = time.perf_counter()
    compiled = lowered.compile()
    t2 = time.perf_counter()
    call = lambda k, f: compiled(params, k, f)
    out = call(jax.random.PRNGKey(1), feats_b)
    jax.block_until_ready(out)
    t3 = time.perf_counter()
    print(f"{label}: trace {t1 - t0:.2f}s compile {t2 - t1:.2f}s "
          f"first run {t3 - t2:.2f}s", file=sys.stderr)
    if detail_name:
        _note_cold_start(detail_name, t1 - t0, t2 - t1, t3 - t2)

    keys = [jax.random.PRNGKey(2 + i) for i in range(reps)]  # not timed
    times = []
    for i in range(reps):
        t0 = time.perf_counter()
        out = call(keys[i], feats_b)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    best = min(times)
    per_chip = batch / best / jax.device_count()
    if detail_name:
        count = _count_flops(run, params, jax.random.PRNGKey(1), feats_b)
        _record_details(detail_name, times, batch, count)
    print(
        f"{label}: device={jax.devices()[0].device_kind} batch={batch} "
        f"best={best * 1e3:.1f}ms -> {per_chip:.1f} samples/s/chip "
        f"({jax.device_count()} chip(s))",
        file=sys.stderr,
    )
    return per_chip


def _lj13_cnf():
    from ecnf_jax.cnf.build import build_cnf

    return build_cnf(
        n_frames=13, dim=3, sigma_min=0.01, base_scale=1.0,
        n_blocks_egnn=3, mlp_units=(128, 128, 128),
        n_invariant_feat_hidden=64, time_embedding_dim=8, n_features=1,
        compute_dtype=COMPUTE_DTYPE,
    )


def _qm9_cnf():
    # The flagship config (`examples/configs/qm9.yaml`): 19 padded atoms,
    # D=57, 5 blocks x [256]^4, hidden 32, sigma_min 1e-6, base_scale 2.
    from ecnf_jax.cnf.build import build_cnf

    return build_cnf(
        n_frames=19, dim=3, sigma_min=1e-6, base_scale=2.0,
        n_blocks_egnn=5, mlp_units=(256, 256, 256, 256),
        n_invariant_feat_hidden=32, time_embedding_dim=8, n_features=1,
        compute_dtype=COMPUTE_DTYPE,
    )


def _solve_cfg(method: str, hutchinson_probes: int = 1):
    from ecnf_jax.cnf.sampling import SolveConfig

    return SolveConfig(
        use_fixed_step_size=True,
        step_size=0.05,
        trace_column_chunk=TRACE_CHUNK,
        structured_tangent=TANGENT,
        method=method,
        hutchinson_probes=hutchinson_probes,
    )


def bench_lj13(method: str, reps: int) -> float:
    return _sharded_solve_rate(
        _lj13_cnf(), n_nodes=13, batch=BATCH, cfg=_solve_cfg(method),
        approx=False, reps=reps, label=f"lj13[{method}]",
        detail_name=f"lj13_{method}",
    )


def bench_qm9_sample_logprob(reps: int, method: str = "dopri5") -> float:
    # K=4 Hutchinson — the flagship eval path (`qm9.yaml:
    # eval_exact_log_prob: false`).  method="dopri5" is the reference
    # stepper (the parity number); "rk4" takes 4 instead of 6 field
    # evaluations per step and is *closer* to the adaptive ground truth than
    # fixed dopri5 on a trained model (`scripts/qm9_stepper_study.py`).
    return _sharded_solve_rate(
        _qm9_cnf(), n_nodes=19, batch=64,
        cfg=_solve_cfg(method, hutchinson_probes=4),
        approx=True, reps=reps, label=f"qm9[hutch4,{method}]",
        detail_name=f"qm9_hutch4_{method}",
    )


def bench_qm9_train_step(reps: int = 3, n_steps: int = 100) -> float:
    """Flagship train-step steps/s via a 100-step on-device scan.

    Mirrors the whole-epoch-jit path (`training/setup.py`); one 100-step
    program per rep keeps the per-dispatch host latency out of the rate.
    """
    _require_gpu()
    import numpy as np

    from ecnf_jax.training.optim import build_optimizer
    from ecnf_jax.training.state import init_training_state, make_update_fn

    n_nodes, batch = 19, 256
    # Micro-batched gradient (grad = mean of k chunk grads, identical
    # update math), as `examples/configs/qm9.yaml` ships it.  =1 for the
    # one-shot reference-RNG-stream form.
    microbatch = int(os.environ.get("ECNF_BENCH_MICROBATCH", "4"))
    cnf = _qm9_cnf()
    opt = build_optimizer(1e-4, use_schedule=False)
    rng = np.random.default_rng(0)
    data = jnp.asarray(
        rng.normal(size=(n_steps, batch, n_nodes * 3)).astype(np.float32)
    )
    feats = jnp.zeros((batch, n_nodes), dtype=jnp.int32)
    state = init_training_state(
        cnf, opt, jax.random.PRNGKey(0), data[0, :2], feats[:2],
        use_ema=True,
    )
    update = make_update_fn(cnf, opt, use_ema=True, microbatch=microbatch)

    def run(st, xs):
        def body(s, xb):
            s2, info = update(s, xb, feats)
            return s2, info["loss"]
        st, losses = jax.lax.scan(body, st, xs)
        return st, losses[-1]

    count = _count_flops(run, state, data)  # abstract, pre-donation
    run_jit = jax.jit(run, donate_argnums=(0,))
    # Commit the inputs to the accelerator BEFORE lowering: jit reads the
    # committed device of its arguments, so lowering against host-resident
    # arrays would bake host shardings into the executable.  Donation also
    # needs committed inputs.
    state, data, feats = jax.device_put((state, data, feats), jax.devices()[0])
    t_trace = time.perf_counter()
    lowered = run_jit.lower(state, data)
    t_trace = time.perf_counter() - t_trace
    t0 = time.perf_counter()
    compiled = lowered.compile()
    t1 = time.perf_counter()
    state, loss = compiled(state, data)
    jax.block_until_ready((state, loss))
    t2 = time.perf_counter()
    first_loss = float(loss)
    assert np.isfinite(first_loss), "qm9_train: non-finite first loss"
    print(f"qm9_train: trace {t_trace:.2f}s compile {t1 - t0:.2f}s "
          f"first run {t2 - t1:.2f}s", file=sys.stderr)
    _note_cold_start("qm9_train_step", t_trace, t1 - t0, t2 - t1)

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        state, loss = compiled(state, data)
        jax.block_until_ready((state, loss))
        times.append(time.perf_counter() - t0)
        if not np.isfinite(float(loss)):
            raise RuntimeError("qm9_train: non-finite loss — invalid measurement")
    best = min(times)
    steps_s = n_steps / best / jax.device_count()
    _record_details("qm9_train_step", times, n_steps, count)
    DETAILS.setdefault("qm9_train_step", {})["microbatch"] = microbatch
    print(
        f"qm9_train: batch={batch} microbatch={microbatch} "
        f"{best / n_steps * 1e3:.2f} ms/step -> "
        f"{steps_s:.1f} steps/s/chip",
        file=sys.stderr,
    )
    return steps_s


def _with_details(rec: dict, name: str) -> dict:
    """Merge the measured spread/MFU side-channel for `name` into `rec`."""
    rec.update(DETAILS.get(name, {}))
    return rec


def main() -> None:
    if TASK == "qm9_train_step":
        v = bench_qm9_train_step(reps=max(REPS, 3))
        print(json.dumps(_with_details({
            "metric": "qm9_train_step", "value": round(v, 1),
            "unit": "steps/s/chip",
            "vs_baseline": _vs(v, _baseline("qm9_train_step", "")),
        }, "qm9_train_step")))
        return
    if TASK == "qm9_sample_logprob":
        method = METHOD if METHOD in ("rk4", "dopri5") else "dopri5"
        v = bench_qm9_sample_logprob(reps=REPS, method=method)
        print(json.dumps(_with_details({
            "metric": "qm9_sample_logprob_hutch4", "value": round(v, 2),
            "unit": "samples/s/chip",
            "vs_baseline": _vs(v, _baseline("qm9_hutch4", method)),
        }, f"qm9_hutch4_{method}")))
        return
    if TASK == "lj13_sample_logprob" or not EXTRAS:
        v = bench_lj13(METHOD, reps=REPS)
        print(json.dumps(_with_details({
            "metric": "lj13_sample_with_exact_logprob", "value": round(v, 2),
            "unit": "samples/s/chip",
            "vs_baseline": _vs(v, _baseline("lj13", METHOD)),
        }, f"lj13_{METHOD}")))
        return

    # Default: the full suite, one JSON line.
    headline = bench_lj13(METHOD, reps=REPS)
    extras = {}
    parity_method = "dopri5" if METHOD == "rk4" else "rk4"

    def _run_extra(key: str, fn, detail_name: str, unit: str, task: str,
                   method: str, digits: int = 2) -> None:
        # A failed extra MUST stay visible in the JSON, with a
        # machine-readable reason, rather than silently vanish.
        try:
            v = fn()
            extras[key] = _with_details({
                "value": round(v, digits), "unit": unit,
                "vs_baseline": _vs(v, _baseline(task, method)),
            }, detail_name)
        except Exception as e:
            print(f"{key} extra failed: {e}", file=sys.stderr)
            extras[key] = {"error": f"{type(e).__name__}: {e}"[:500]}

    _run_extra(
        "lj13_dopri5_reference_stepper" if parity_method == "dopri5"
        else "lj13_rk4",
        lambda: bench_lj13(parity_method, reps=3),
        f"lj13_{parity_method}", "samples/s/chip", "lj13", parity_method,
    )
    _run_extra(
        "qm9_sample_logprob_hutch4",
        lambda: bench_qm9_sample_logprob(reps=3),
        "qm9_hutch4_dopri5", "samples/s/chip", "qm9_hutch4", "dopri5",
    )
    _run_extra(
        "qm9_sample_logprob_hutch4_rk4",
        lambda: bench_qm9_sample_logprob(reps=3, method="rk4"),
        "qm9_hutch4_rk4", "samples/s/chip", "qm9_hutch4", "rk4",
    )
    _run_extra(
        "qm9_train_step",
        lambda: bench_qm9_train_step(reps=3),
        "qm9_train_step", "steps/s/chip", "qm9_train_step", "", digits=1,
    )

    print(json.dumps(_with_details({
        "metric": "lj13_sample_with_exact_logprob",
        "value": round(headline, 2),
        "unit": "samples/s/chip",
        "vs_baseline": _vs(headline, _baseline("lj13", METHOD)),
        "extras": extras,
    }, f"lj13_{METHOD}")))


if __name__ == "__main__":
    main()
