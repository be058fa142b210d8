"""Hand-linearized EGNN trace: one residual-capturing primal, K explicit
tangent columns.

This module replaces `jax.linearize` on the EGNN field (reference math
`ecnf/nets/egnn.py:49-190`) for exact-trace and Hutchinson ODE solves:

- the primal runs ONCE per ODE stage, storing exactly the residuals the
  tangent needs (silu'(z) scale factors, ``m_ij``, gate) — shared by all K
  trace columns;
- each column's tangent is propagated by explicit algebra (geometry and
  node-level parts vectorized over ``[K, B, ...]``; edge-level chains in
  `_edge_tangent_math`, vmapped over the columns).

It is plain JAX; XLA hands the ``[K*B*N^2, U] x [U, U]`` edge-tangent
matmuls to its GEMM libraries.  Selected by
`SolveConfig(structured_tangent=True)` (the default); `structured_tangent=
False` falls back to `jax.linearize` and is the reference it is tested
against.

Scope: the plain-MLP EGNN (every shipped config; ``stable_mlp`` falls back
to `jax.linearize`).  Forward + trace only — this path serves ODE log-prob
solves, which are never differentiated.
"""
from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# The geometry, aggregation and trace contractions are tiny and must not
# run in TF32 (a float32 matmul's default on Hopper): the Gram-identity
# distances cancel catastrophically under a 10-bit mantissa.
HIGHEST = jax.lax.Precision.HIGHEST


def _silu(x):
    return x * jax.nn.sigmoid(x)


def _dsilu(x):
    """d/dx silu(x) = sigmoid(x) * (1 + x * (1 - sigmoid(x)))."""
    s = jax.nn.sigmoid(x)
    return s * (1.0 + x * (1.0 - s))


# ---------------------------------------------------------------------------
# Weight extraction (param tree -> per-block struct)
# ---------------------------------------------------------------------------


class BlockWeights(NamedTuple):
    """One EGNN block's weights, in tangent-propagation form.

    All entries keep their stored (f32) dtype; casting to the compute dtype
    happens at use, mirroring `models/mlp.py` (params f32, compute bf16).
    """

    cd_h: jax.Array  # time-ConcatDense kernel rows for h      [H, H]
    e_s: jax.Array  # phi_e first-layer sender rows            [H, U]
    e_r: jax.Array  # phi_e first-layer receiver rows          [H, U]
    e_l: jax.Array  # phi_e first-layer length row             [1, U]
    e_tail: Tuple[jax.Array, ...]  # phi_e Dense kernels       (L-1) x [U, U]
    x_tail: Tuple[jax.Array, ...]  # phi_x Dense kernels        L x [U, U]
    x_out: jax.Array  # phi_x output Dense(1) kernel           [U, 1]
    g_out: jax.Array  # gate Dense(1) kernel                   [U, 1]
    h_m: jax.Array  # phi_h first-layer m_i rows               [U, U]
    h_h: jax.Array  # phi_h first-layer h rows                 [H, U]
    h_tail: Tuple[jax.Array, ...]  # phi_h Dense kernels       (L-1) x [U, U]
    h_out: jax.Array  # phi_h final Dense(H) kernel            [U, H]


def _mlp_layer_params(p, n_layers):
    keys = [k for k in p if k.startswith("ConcatDense")] + sorted(
        (k for k in p if k.startswith("Dense")), key=lambda s: int(s.split("_")[-1])
    )
    assert len(keys) == n_layers, (sorted(p), n_layers)
    return [p[k] for k in keys]


def block_weights(egnn_params, i: int, mlp_units: Sequence[int], h_width: int):
    """Extract block ``i``'s kernels from the ``EGNN_0`` param subtree.

    Biases are irrelevant to tangents (constants) and are not extracted.
    Layout mirrors the parameter names of `ecnf_jax/models/egnn.py` and
    `mlp.py`.
    """
    L = len(mlp_units)
    U = mlp_units[0]
    cd = egnn_params[f"ConcatDense_{i}"]["kernel"]
    egcl = egnn_params[f"EGCL_{i}"]
    e_layers = _mlp_layer_params(egcl["MLP_0"], L)
    k0 = e_layers[0]["kernel"]
    x_layers = _mlp_layer_params(egcl["MLP_1"], L)
    h_layers = _mlp_layer_params(egcl["MLP_2"], L + 1)
    kh = h_layers[0]["kernel"]
    return BlockWeights(
        cd_h=cd[:h_width],
        e_s=k0[:h_width],
        e_r=k0[h_width : 2 * h_width],
        e_l=k0[2 * h_width :],
        e_tail=tuple(l["kernel"] for l in e_layers[1:]),
        x_tail=tuple(l["kernel"] for l in x_layers),
        x_out=egcl["Dense_0"]["kernel"],
        g_out=egcl["Dense_1"]["kernel"],
        h_m=kh[:U],
        h_h=kh[U:],
        h_tail=tuple(l["kernel"] for l in h_layers[1:-1]),
        h_out=h_layers[-1]["kernel"],
    )


# ---------------------------------------------------------------------------
# Primal forward with tangent residuals
# ---------------------------------------------------------------------------


class BlockResiduals(NamedTuple):
    """Per-block primal quantities consumed by the tangent pass."""

    vec: jax.Array  # block input coordinates                 [B, N, D] f32
    l2: jax.Array  # squared distances (clamped)              [B, N, N] f32
    active: jax.Array  # clamp-inactive mask (raw > 0)        [B, N, N] bool
    lengths: jax.Array  # safe distances                      [B, N, N] f32
    phi: jax.Array  # phi_x output, f32                       [B, N, N]
    w: jax.Array  # masked coordinate weights                 [B, N, N] f32
    d_e: Tuple[jax.Array, ...]  # phi_e silu' scales    L x [B, N, N, U] cd
    d_x: Tuple[jax.Array, ...]  # phi_x silu' scales    L x [B, N, N, U] cd
    m: jax.Array  # edge messages m_ij                        [B, N, N, U] cd
    g: jax.Array  # gate                                      [B, N, N] cd
    gd: jax.Array  # gate derivative g*(1-g)                  [B, N, N] cd
    d_h: Tuple[jax.Array, ...]  # phi_h silu' scales    L x [B, N, U] cd


def _edge_mask(N: int, dtype) -> jax.Array:
    rows = jax.lax.broadcasted_iota(jnp.int32, (N, N), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (N, N), 1)
    return (rows != cols).astype(dtype)


def egnn_forward_residuals(
    params,
    pos: jax.Array,
    h0: jax.Array,
    temb: jax.Array,
    n_blocks: int,
    mlp_units: Sequence[int],
    compute_dtype,
    normalization_constant: float = 1.0,
):
    """EGNN torso forward (same math as `models/egnn.py`, incl. bf16 casts),
    returning the output field and the per-block tangent residuals.

    Args:
        params: the ``EGNN_0`` param subtree.
        pos: ``[B, N, D]`` positions.  h0: ``[B, N, H]`` embedded features.
        temb: ``[B, T]`` time embedding.
        compute_dtype: MLP compute dtype (``jnp.bfloat16`` or f32).

    Returns:
        ``(out [B, N, D] f32, residuals: list[BlockResiduals], weights)``.
    """
    cd = compute_dtype
    B, N, D = pos.shape
    H = h0.shape[-1]
    C = normalization_constant
    mask = _edge_mask(N, pos.dtype)

    pos_mean = jnp.mean(pos, axis=-2, keepdims=True)
    vec = pos - pos_mean
    initial_vec = vec
    h = h0
    residuals = []
    weights = [block_weights(params, i, mlp_units, H) for i in range(n_blocks)]

    for i, wt in enumerate(weights):
        blk = params[f"EGCL_{i}"]
        cdp = params[f"ConcatDense_{i}"]
        # Time conditioning: ConcatDense([h, temb]) in cd, cast back to f32.
        h = (
            jnp.dot(h.astype(cd), cdp["kernel"][:H].astype(cd))
            + jnp.dot(temb.astype(cd), cdp["kernel"][H:].astype(cd))[:, None, :]
            + cdp["bias"].astype(cd)
        ).astype(pos.dtype)

        # Geometry (f32 at HIGHEST precision, as in `models/egnn.py`): Gram
        # identity, clamp, safe lengths.
        gram = jnp.einsum("bnd,bmd->bnm", vec, vec, precision=HIGHEST)
        r2 = jnp.diagonal(gram, axis1=-2, axis2=-1)
        raw = r2[:, :, None] + r2[:, None, :] - 2.0 * gram
        active = raw > 0
        l2 = jnp.maximum(raw, 0.0)
        lengths = jnp.where(l2 == 0, 1.0, l2) ** 0.5

        e_layers = _mlp_layer_params(blk["MLP_0"], len(mlp_units))
        x_layers = _mlp_layer_params(blk["MLP_1"], len(mlp_units))
        h_layers = _mlp_layer_params(blk["MLP_2"], len(mlp_units) + 1)

        # phi_e: fused first layer + tail; keep silu' of each pre-activation.
        hb = h.astype(cd)
        z = (
            jnp.dot(hb, wt.e_s.astype(cd))[:, None, :, :]
            + jnp.dot(hb, wt.e_r.astype(cd))[:, :, None, :]
            + l2[..., None].astype(cd) * wt.e_l.astype(cd)
            + e_layers[0]["bias"].astype(cd)
        )
        d_e = [_dsilu(z)]
        a = _silu(z)
        for l in e_layers[1:]:
            z = jnp.dot(a, l["kernel"].astype(cd)) + l["bias"].astype(cd)
            d_e.append(_dsilu(z))
            a = _silu(z)
        m = a  # [B, N, N, U] cd

        # phi_x torso (+ silu' scales) and output Dense(1).
        d_x = []
        a = m
        for l in x_layers:
            z = jnp.dot(a, l["kernel"].astype(cd)) + l["bias"].astype(cd)
            d_x.append(_dsilu(z))
            a = _silu(z)
        phi = (
            jnp.dot(a, wt.x_out.astype(cd)) + blk["Dense_0"]["bias"].astype(cd)
        )[..., 0].astype(pos.dtype)

        w = phi * mask / (C + lengths)
        shifts = jnp.sum(w, axis=2)[:, :, None] * vec - jnp.einsum(
            "bij,bjd->bid", w, vec, precision=HIGHEST
        )
        vec_out = vec + shifts / (N - 1)

        # Gate + gated aggregation.
        zg = (jnp.dot(m, wt.g_out.astype(cd)) + blk["Dense_1"]["bias"].astype(cd))[
            ..., 0
        ]
        g = jax.nn.sigmoid(zg)
        gd = g * (1.0 - g)
        m_i = jnp.sum(
            (m * g[..., None]).astype(pos.dtype) * mask[None, :, :, None], axis=2
        ) / jnp.sqrt(jnp.asarray(N - 1, pos.dtype))

        # phi_h: fused first layer over [m_i, h] + tail + final Dense(H).
        z = (
            jnp.dot(m_i.astype(cd), wt.h_m.astype(cd))
            + jnp.dot(hb, wt.h_h.astype(cd))
            + h_layers[0]["bias"].astype(cd)
        )
        d_h = [_dsilu(z)]
        a = _silu(z)
        for l in h_layers[1:-1]:
            z = jnp.dot(a, l["kernel"].astype(cd)) + l["bias"].astype(cd)
            d_h.append(_dsilu(z))
            a = _silu(z)
        h_out = (
            jnp.dot(a, wt.h_out.astype(cd)) + h_layers[-1]["bias"].astype(cd)
        ).astype(h.dtype)

        residuals.append(
            BlockResiduals(
                vec=vec, l2=l2, active=active, lengths=lengths, phi=phi, w=w,
                d_e=tuple(d_e), d_x=tuple(d_x), m=m, g=g, gd=gd, d_h=tuple(d_h),
            )
        )
        h = h_out + h
        vec = vec_out

    vec = vec - initial_vec
    vec = vec - pos_mean
    out = vec * params["final_scaling"]
    return out, residuals, weights


# ---------------------------------------------------------------------------
# Edge-level tangent chain
# ---------------------------------------------------------------------------


def _edge_tangent_math(
    a_t, b_t, l2_t, d_e, d_x, m, g, gd, e_l, e_tail, x_tail, x_out, g_out,
    mask, cd,
):
    """Tangent of the EGCL edge path for ONE column (batched over samples).

    Inputs:
        a_t, b_t: ``[B', N, U]`` cd — first-layer sender/receiver tangents.
        l2_t: ``[B', N, N]`` f32 — squared-distance tangent.
        d_e, d_x: per-layer silu' scales ``[B', N, N, U]`` cd.
        m: ``[B', N, N, U]`` cd; g, gd: ``[B', N, N, 1]`` cd primals.
        e_l/x_out/g_out: weight rows/cols; e_tail/x_tail: [U, U] kernels.
        mask: ``[N, N]`` f32 off-diagonal mask.

    Returns:
        ``(phi_t [B', N, N] f32, mi_t [B', N, U] f32)``.
    """
    N = mask.shape[0]
    f32 = jnp.float32
    Bp = l2_t.shape[0]
    U = a_t.shape[-1]
    M = Bp * N * N

    # Edge matmuls run flattened to [M, U] with f32 accumulation; casts
    # back to the compute dtype happen after the reshape.
    def mm(x4, k):  # [Bp, N, N, U] @ [U, V] -> [Bp, N, N, V] f32 accum
        out = jnp.dot(
            x4.reshape(M, -1), k.astype(cd), preferred_element_type=f32
        )
        return out.reshape(Bp, N, N, -1)

    z_t = (
        a_t[:, None, :, :]
        + b_t[:, :, None, :]
        + l2_t[..., None].astype(cd) * e_l.astype(cd)[0]
    )
    t = d_e[0] * z_t
    for d, k in zip(d_e[1:], e_tail):
        t = d * mm(t, k).astype(cd)
    m_t = t  # tangent of m_ij, [Bp, N, N, U] cd

    p = m_t
    for d, k in zip(d_x, x_tail):
        p = d * mm(p, k).astype(cd)
    phi_t = mm(p, x_out)[..., 0]  # [Bp, N, N] f32

    g_t = gd * mm(m_t, g_out).astype(cd)  # [Bp, N, N, 1]
    mi_t = jnp.sum(
        (m_t * g + m * g_t).astype(f32) * mask[None, :, :, None],
        axis=2,
    ) / np.sqrt(N - 1)
    return phi_t, mi_t


def _edge_tangent(a_t, b_t, l2_t, res, wt, cd):
    """`_edge_tangent_math` vmapped over the column axis (named scope
    ``edge_tangent``, which the stage trace reads)."""
    N = res.l2.shape[-1]
    mask = _edge_mask(N, jnp.float32)
    fn = lambda a, b, l: _edge_tangent_math(
        a, b, l, res.d_e, res.d_x, res.m.astype(cd),
        res.g.astype(cd)[..., None], res.gd.astype(cd)[..., None],
        wt.e_l, wt.e_tail, wt.x_tail, wt.x_out, wt.g_out, mask, cd,
    )
    with jax.named_scope("edge_tangent"):
        return jax.vmap(fn)(a_t, b_t, l2_t)


# ---------------------------------------------------------------------------
# Full tangent pass (all K columns) and the public trace entry point
# ---------------------------------------------------------------------------


def _block_tangent(
    vec_t, h_t, res: BlockResiduals, wt: BlockWeights, cd,
    normalization_constant: float,
):
    """Propagate K tangent columns through one EGNN block.

    vec_t: ``[K, B, N, D]`` f32; h_t: ``[K, B, N, H]`` f32 (pre-time-CD).
    """
    K, B, N, D = vec_t.shape
    C = normalization_constant
    vec = res.vec
    mask = _edge_mask(N, jnp.float32)

    # Time-CD tangent (temb is constant): h'_t = cast(h_t) @ W_h, back to f32.
    hcd_t = jnp.dot(h_t.astype(cd), wt.cd_h.astype(cd)).astype(jnp.float32)

    # First-layer node tangents (cd) and geometry tangent (f32).
    hb_t = hcd_t.astype(cd)
    a_t = jnp.dot(hb_t, wt.e_s.astype(cd))
    b_t = jnp.dot(hb_t, wt.e_r.astype(cd))
    gram_t = jnp.einsum("kbnd,bmd->kbnm", vec_t, vec, precision=HIGHEST)
    gram_t = gram_t + jnp.swapaxes(gram_t, -1, -2)
    r2_t = 2.0 * jnp.sum(vec * vec_t, axis=-1)
    raw_t = r2_t[..., :, None] + r2_t[..., None, :] - 2.0 * gram_t
    l2_t = jnp.where(res.active, raw_t, 0.0)

    phi_t, mi_t = _edge_tangent(a_t, b_t, l2_t, res, wt, cd)

    # Coordinate-update tangent: w = phi * mask / (C + len).
    den = C + res.lengths
    len_t = jnp.where(res.l2 == 0, 0.0, 0.5 * l2_t / res.lengths)
    w_t = mask * (phi_t * den - res.phi * len_t) / (den * den)
    shifts_t = (
        jnp.sum(w_t, axis=-1)[..., None] * vec
        + jnp.sum(res.w, axis=-1)[..., None] * vec_t
        - jnp.einsum("kbij,bjd->kbid", w_t, vec, precision=HIGHEST)
        - jnp.einsum("bij,kbjd->kbid", res.w, vec_t, precision=HIGHEST)
    )
    vec_t_out = vec_t + shifts_t / (N - 1)

    # phi_h tangent (node-level): fused first layer over [m_i, h'].
    t = res.d_h[0] * (
        jnp.dot(mi_t.astype(cd), wt.h_m.astype(cd))
        + jnp.dot(hb_t, wt.h_h.astype(cd))
    )
    for d, k in zip(res.d_h[1:], wt.h_tail):
        t = d * jnp.dot(t, k.astype(cd))
    h_mlp_t = jnp.dot(t, wt.h_out.astype(cd)).astype(jnp.float32)
    h_t_out = h_mlp_t + hcd_t
    return vec_t_out, h_t_out


def egnn_value_and_trace(
    variables,
    x: jax.Array,
    t: jax.Array,
    features: jax.Array,
    basis: jax.Array,
    n_nodes: int,
    dim: int,
    n_blocks: int,
    mlp_units: Sequence[int],
    time_embedding_dim: int,
    compute_dtype: Optional[str] = None,
    trace_offset=None,
) -> Tuple[jax.Array, jax.Array]:
    """Field value + restricted exact trace via the hand-written tangent pass.

    Drop-in for the exact-divergence branch of the augmented ODE field
    (`cnf/sampling.py`): returns ``(f(x) [B, D],
    sum_k u_k^T J u_k (+ trace_offset) [B])``.  Two basis forms:

    - ``[K, D]``: batch-shared rows (the exact-trace path; orthonormal
      zero-CoM basis or identity columns).
    - ``[K, B, D]``: per-sample directions — Hutchinson probes
      (reference semantics `ecnf/cnf/sample_and_log_prob.py:75-77`,
      ``div ~= eps . (J eps)``); the caller averages over K.

    Both are exact for *arbitrary* (not necessarily zero-CoM) directions:
    the seed is the zero-CoM projection and the translation component is
    reconstructed analytically in the epilogue (the EGNN is translation-
    structured, `cnf/build.py: exact_trace_plan`).  Same math as
    `jax.linearize` over the EGNN (reference
    `ecnf/cnf/sample_and_log_prob.py:64-66`), restructured as documented
    at module top.
    """
    from ecnf_jax.ops.numerics import timestep_embedding

    p = variables["params"]
    cd = jnp.dtype(compute_dtype) if compute_dtype else jnp.float32
    B = x.shape[0]
    K = basis.shape[0]
    per_sample = basis.ndim == 3
    pos = jnp.reshape(x, (B, n_nodes, dim))
    feats = jnp.reshape(features, (B, n_nodes)).astype(jnp.int32)
    h0 = jnp.take(p["Embed_0"]["embedding"], feats, axis=0)
    temb = timestep_embedding(t, time_embedding_dim)

    out, residuals, weights = egnn_forward_residuals(
        p["EGNN_0"], pos, h0, temb, n_blocks, mlp_units, cd
    )
    value = jnp.reshape(out, (B, n_nodes * dim))

    # Tangent seeds: the zero-CoM projection of each direction (the torso
    # acts on centred coordinates; translations are handled in the epilogue).
    if per_sample:
        e = jnp.reshape(basis.astype(jnp.float32), (K, B, n_nodes, dim))
        e_mean = jnp.mean(e, axis=2, keepdims=True)
        vec_t = e - e_mean
    else:
        e = jnp.reshape(basis.astype(jnp.float32), (K, n_nodes, dim))
        e_mean = jnp.mean(e, axis=1, keepdims=True)[:, None, :, :]
        e = e[:, None, :, :]  # [K, 1, N, D], broadcasts against batch
        vec_t = jnp.broadcast_to(e - e_mean, (K, B, n_nodes, dim))
    h_t = jnp.zeros((K, B, n_nodes, h0.shape[-1]), jnp.float32)

    for res, wt in zip(residuals, weights):
        vec_t, h_t = _block_tangent(
            vec_t, h_t, res, wt, cd, 1.0
        )

    # Epilogue tangent: (vec_T - seed - translation) * final_scaling, i.e.
    # J e = fs * (V'(Px) Pe - Pe - e_mean); both e shapes broadcast.
    out_t = (vec_t - (e - e_mean) - e_mean) * p["EGNN_0"]["final_scaling"]
    div = jnp.einsum(
        "kbnd,kbnd->b", out_t, jnp.broadcast_to(e, out_t.shape),
        precision=HIGHEST,
    )
    if trace_offset is not None:
        div = div + jnp.asarray(trace_offset, div.dtype)
    return value, div
