"""Analytic FLOP counting by jaxpr traversal, for MFU reporting.

Counts matmul (``dot_general``) FLOPs of a traced function by walking its
jaxpr, recursing into control-flow bodies (``scan`` multiplied by its
static length, ``cond`` as the max over branches, ``pjit``/``remat``/
``custom_jvp``/``custom_vjp`` inlined).  ``while_loop`` trip counts are
data-dependent, so the body is counted ONCE and the result is flagged
``has_while`` — callers either scale by a known/measured trip count or
skip MFU for adaptive paths.

FLOPs are split by matmul operand dtype (bf16 vs everything-else-as-f32)
so utilization can be computed against a mixed-precision roofline:

    mfu = (flops_bf16 / peak_bf16 + flops_f32 / peak_f32) / seconds

This counts only matmul work (dot_general / conv); elementwise FLOPs are
ignored, which *understates* utilization slightly — fine for a
regression-tracking metric (the EGNN paths are matmul-dominated).  Used by
``bench.py``; the reference has no FLOP accounting anywhere
(`ecnf/` — the only timing is wall-clock in
`examples/load_checkpoint_measure_sampling_time.py:101-119`).
"""
from dataclasses import dataclass
from math import prod

import jax
import jax.numpy as jnp
from jax._src import core as jax_core


@dataclass
class FlopCount:
    bf16: float = 0.0
    f32: float = 0.0
    has_while: bool = False

    @property
    def total(self) -> float:
        return self.bf16 + self.f32

    def __add__(self, other: "FlopCount") -> "FlopCount":
        return FlopCount(
            self.bf16 + other.bf16,
            self.f32 + other.f32,
            self.has_while or other.has_while,
        )

    def scaled(self, k: float) -> "FlopCount":
        return FlopCount(self.bf16 * k, self.f32 * k, self.has_while)


# Peak dense matmul throughput per device, FLOP/s, keyed by the exact
# `device_kind` string JAX reports.  NVIDIA H100 SXM data sheet (700 W):
# 989 TFLOP/s bf16 on the tensor cores; float32 dots at JAX's default
# precision run in TF32, whose peak is 495 TFLOP/s.  (Dots pinned to
# Precision.HIGHEST — the small geometry einsums — run at the 67 TFLOP/s
# non-tensor-core f32 rate; they are a negligible share of the count.)  A
# device not listed gets no MFU rather than an assumed peak.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "f32": 495e12},
}


def _dot_general_flops(eqn) -> FlopCount:
    (lc, rc), (lb, _rb) = eqn.params["dimension_numbers"]
    lhs, rhs = eqn.invars[0].aval, eqn.invars[1].aval
    batch = prod(lhs.shape[i] for i in lb)
    contract = prod(lhs.shape[i] for i in lc)
    m = prod(
        lhs.shape[i] for i in range(len(lhs.shape)) if i not in lc and i not in lb
    )
    rc_rb = set(rc) | set(_rb)
    n = prod(rhs.shape[i] for i in range(len(rhs.shape)) if i not in rc_rb)
    flops = 2.0 * batch * m * n * contract
    is_bf16 = lhs.dtype == jnp.bfloat16 and rhs.dtype == jnp.bfloat16
    return FlopCount(bf16=flops if is_bf16 else 0.0, f32=0.0 if is_bf16 else flops)


def _conv_flops(eqn) -> FlopCount:
    # 2 * output_elements * (input_channels/groups) * kernel_spatial_size.
    lhs, rhs = eqn.invars[0].aval, eqn.invars[1].aval
    out = eqn.outvars[0].aval
    dn = eqn.params["dimension_numbers"]
    groups = eqn.params.get("feature_group_count", 1)
    kernel_spatial = prod(rhs.shape[i] for i in dn.rhs_spec[2:])
    in_feat = lhs.shape[dn.lhs_spec[1]]
    flops = 2.0 * prod(out.shape) * (in_feat / groups) * kernel_spatial
    is_bf16 = lhs.dtype == jnp.bfloat16 and rhs.dtype == jnp.bfloat16
    return FlopCount(bf16=flops if is_bf16 else 0.0, f32=0.0 if is_bf16 else flops)


def _maybe_jaxpr(x):
    if isinstance(x, jax_core.ClosedJaxpr):
        return x.jaxpr
    if isinstance(x, jax_core.Jaxpr):
        return x
    return None


def count_jaxpr_flops(jaxpr) -> FlopCount:
    """Sum matmul/conv FLOPs over a (Closed)Jaxpr, recursively."""
    j = _maybe_jaxpr(jaxpr)
    if j is None:
        raise TypeError(f"not a jaxpr: {type(jaxpr)}")
    total = FlopCount()
    for eqn in j.eqns:
        name = eqn.primitive.name
        if name == "dot_general":
            total = total + _dot_general_flops(eqn)
        elif name == "conv_general_dilated":
            total = total + _conv_flops(eqn)
        elif name == "scan":
            body = count_jaxpr_flops(eqn.params["jaxpr"])
            total = total + body.scaled(eqn.params["length"])
        elif name == "while":
            body = count_jaxpr_flops(eqn.params["body_jaxpr"])
            cond = count_jaxpr_flops(eqn.params["cond_jaxpr"])
            one_trip = body + cond
            one_trip.has_while = True
            total = total + one_trip
        elif name == "cond":
            branches = [count_jaxpr_flops(b) for b in eqn.params["branches"]]
            worst = max(branches, key=lambda c: c.total)
            total = total + worst
        else:
            # Generic recursion into any jaxpr-valued params (pjit, remat,
            # custom_jvp/vjp call_jaxpr, closed_call, ...).
            for v in eqn.params.values():
                sub = _maybe_jaxpr(v)
                if sub is not None:
                    total = total + count_jaxpr_flops(sub)
    return total


def count_fn_flops(fn, *args, **kwargs) -> FlopCount:
    """Trace ``fn`` (abstractly, no execution/compile) and count its FLOPs."""
    jaxpr = jax.make_jaxpr(fn)(*args, **kwargs)
    return count_jaxpr_flops(jaxpr)


def mfu(count: FlopCount, seconds: float, device_kind: str, n_devices: int = 1):
    """Model FLOP utilization in [0, 1] against the mixed-precision roofline.

    Returns ``None`` when the device has no peak entry (e.g. host CPU) or
    the count contains an unscaled ``while`` body (adaptive solves).
    """
    peaks = PEAKS.get(device_kind)
    if peaks is None or count.has_while or seconds <= 0:
        return None
    denom = (count.bf16 / peaks["bf16"] + count.f32 / peaks["f32"])
    return denom / (seconds * n_devices)
