"""Time and trace one exact-trace ODE stage on the GPU.

One stage is one evaluation of the augmented field (value + exact trace)
that `cnf/sampling.py` integrates: at LJ13 width (13 particles, 3 blocks of
[128]x3, batch 48) and QM9 width (19 atoms, 5 blocks of [256]x4, batch 64),
bf16 and f32 MLPs, with the hand tangent (``structured_tangent=True``) and
with `jax.linearize` (``False``).  For the hand tangent in bf16 it also
traces the stage with `jax.profiler` and sums the device time of the
edge-tangent chain (ops under the ``edge_tangent`` named scope of
`ops/tangent.py`), against the stage's device time and against the chain's
roofline (FLOPs and bytes computed from the shapes below).

    python scripts/stage_trace.py [out.json]

Needs a GPU; prints one JSON line per configuration and writes them all
to ``out.json`` (default ``chiprun_out/stage_trace.json``).  The script
turns XLA's CUDA-graph command buffers off, so that the profiler sees each
kernel rather than one ``command_buffer`` event per program; its stage
times are therefore those of plain kernel launches.
"""
import glob
import json
import os
import re
import shutil
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_gpu_enable_command_buffer="
).strip()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ecnf_jax.cnf.sampling import SolveConfig, _augmented_field  # noqa: E402

PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3 (data sheet)
PEAK_FLOPS = {"bfloat16": 989e12, None: 495e12}  # bf16 / TF32 dense

CELLS = {
    "lj13": dict(width=(13, 3, (128, 128, 128), 64), batch=48, sigma_min=0.01, base_scale=1.0),
    "qm9": dict(width=(19, 5, (256, 256, 256, 256), 32), batch=64, sigma_min=1e-6, base_scale=2.0),
}


def edge_chain_cost(width, batch, dtype):
    """FLOPs and bytes of the edge-tangent chain for all columns and blocks.

    Per block and column, on M = B*N^2 edge rows: (L-1) phi_e tail and L
    phi_x matmuls [M, U] x [U, U], two [M, U] x [U, 1] heads; each [U, U]
    layer reads its input and its silu' scale and writes its output.
    """
    n, blocks, units, _ = width
    L, U = len(units), units[0]
    K = (n - 1) * 3  # zero-CoM trace columns
    M = batch * n * n
    item = 2 if dtype else 4
    flops = K * blocks * (2 * M * U * U * (2 * L - 1) + 2 * 2 * M * U)
    bytes_ = K * blocks * ((2 * L - 1) * 3 * M * U * item + 2 * M * U * item)
    return flops, bytes_


def op_names(hlo_text):
    """Map each HLO instruction name to the op_names it stands for: its own
    metadata, or for a fusion the metadata of every instruction in the
    fused computation it calls."""
    own, calls, comp_ops, comp = {}, {}, {}, None
    for line in hlo_text.splitlines():
        head = re.match(r"^(?:ENTRY )?%?([\w.\-]+) .*\{$", line)
        if head and " = " not in line:
            comp = head.group(1)
            continue
        m = re.match(r"^\s*(?:ROOT )?%?([\w.\-]+) = ", line)
        if not m:
            continue
        name = m.group(1)
        meta = re.search(r'op_name="([^"]*)"', line)
        if meta:
            own[name] = meta.group(1)
            comp_ops.setdefault(comp, []).append(meta.group(1))
        called = re.search(r"calls=%?([\w.\-]+)", line)
        if called:
            calls[name] = called.group(1)
    out = {k: [v] for k, v in own.items()}
    for name, comp in calls.items():
        out[name] = comp_ops.get(comp) or out.get(name, [])
    return out


def device_times(trace_dir, names, n_calls):
    """Per call: stage device ns, edge_tangent device ns (a fused kernel is
    split by the share of its ops under the scope), and the top kernels."""
    path = glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True)[0]
    data = jax.profiler.ProfileData.from_file(path)
    total = edge = 0.0
    per_op = {}
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                op = dict(ev.stats).get("hlo_op")
                if op is None:
                    continue
                ops = names.get(op, [])
                share = sum("edge_tangent" in o for o in ops) / len(ops) if ops else 0.0
                total += ev.duration_ns
                edge += share * ev.duration_ns
                per_op[op] = per_op.get(op, 0.0) + ev.duration_ns
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:8]
    top = [(op, ns / n_calls / 1e6, (names.get(op) or ["?"])[0][-60:]) for op, ns in top]
    return total / n_calls, edge / n_calls, top


def measure(name, dtype, structured, trace):
    cell = CELLS[name]
    n, B = cell["width"][0], cell["batch"]
    cnf = cs.build(cell["width"], dtype, sigma_min=cell["sigma_min"],
                   base_scale=cell["base_scale"])
    params = cs.init_params(cnf, n, seed=0, head_scale=cs.HEAD_SCALE[name])
    feats = jnp.zeros((B, n), jnp.int32)
    cfg = SolveConfig(use_fixed_step_size=True, method="rk4",
                      structured_tangent=structured)
    y = jnp.concatenate(
        [jax.random.normal(jax.random.PRNGKey(1), (B, n * 3)), jnp.zeros((B, 1))], -1)

    t = jnp.full((B,), 0.5)

    def stage(p, yy):
        return _augmented_field(cnf, p, feats, False, None, cfg)(t, yy)

    compiled, _, compile_s, times = cs.timed(stage, params, y, reps=20)
    rec = dict(cell=name, dtype=dtype or "float32", structured_tangent=structured,
               batch=B, compile_s=round(compile_s, 2),
               stage_ms_min=min(times) * 1e3,
               stage_ms_median=sorted(times)[len(times) // 2] * 1e3)
    if trace:
        tdir = tempfile.mkdtemp()
        try:
            with jax.profiler.trace(tdir):
                for _ in range(5):
                    jax.block_until_ready(compiled(params, y))
            total_ns, edge_ns, top = device_times(tdir, op_names(compiled.as_text()), 5)
        finally:
            shutil.rmtree(tdir, ignore_errors=True)
        flops, bytes_ = edge_chain_cost(cell["width"], B, dtype)
        floor_s = max(flops / PEAK_FLOPS[dtype], bytes_ / PEAK_BYTES_S)
        rec.update(
            stage_device_ms=total_ns / 1e6, edge_tangent_device_ms=edge_ns / 1e6,
            edge_share_of_stage=edge_ns / total_ns if total_ns else None,
            edge_gflop=flops / 1e9, edge_gbyte=bytes_ / 1e9,
            edge_roofline_ms=floor_s * 1e3,
            edge_roofline_bound="memory" if bytes_ / PEAK_BYTES_S > flops / PEAK_FLOPS[dtype] else "compute",
            edge_roofline_share=(floor_s * 1e9 / edge_ns) if edge_ns else None,
            top_kernels_ms=top,
        )
    return rec


def reference_rates():
    """What a large plain bf16 matmul and a large copy reach on this card."""
    a = jnp.ones((8192, 8192), jnp.bfloat16)
    _, _, _, t_mm = cs.timed(lambda x: x @ x, a, reps=10)
    big = jnp.ones((256 * 2**20,), jnp.float32)  # 1 GiB
    _, _, _, t_cp = cs.timed(lambda x: x * 1.0001, big, reps=10)
    return dict(matmul_bf16_tflops=2 * 8192**3 / min(t_mm) / 1e12,
                copy_gbytes_per_s=2 * big.nbytes / min(t_cp) / 1e9)


def main():
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("stage_trace needs a GPU")
    out = Path(sys.argv[1]) if len(sys.argv) > 1 else REPO / "chiprun_out" / "stage_trace.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    records = [{"card": cs.card_line(), "kind": jax.devices()[0].device_kind,
                "time": time.strftime("%Y-%m-%dT%H:%M:%S"), **reference_rates()}]
    print(json.dumps(records[0]), flush=True)
    for name in CELLS:
        for dtype in ("bfloat16", None):
            for structured in (True, False):
                rec = measure(name, dtype, structured, trace=structured)
                print(json.dumps(rec), flush=True)
                records.append(rec)
    out.write_text(json.dumps(records, indent=1))


if __name__ == "__main__":
    main()
