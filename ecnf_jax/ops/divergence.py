"""Divergence (Jacobian trace) estimators for batched vector fields.

The reference computes the exact divergence per sample via D reverse-mode
VJPs against the identity (`ecnf/cnf/sample_and_log_prob.py:64-66`) and a
single-probe Hutchinson estimate via one VJP (`:75-77`), each wrapped in a
per-sample vmap.  Here both are formulated directly on the *batched* field
``f: [B, D] -> [B, D]`` so every pass is a full-batch network evaluation on
matmul-sized work:

- exact: the per-sample Jacobian is block-diagonal across the batch (the
  network acts sample-wise), so a JVP with basis vector ``e_d`` broadcast
  over the batch yields column ``d`` of every sample's Jacobian at once.
  D forward-mode passes total — same FLOP count as the reference but batched,
  and forward mode avoids storing residuals. Columns can be chunked (scan of
  vmapped chunks) to bound memory, and — on a mesh — sharded across chips.
- hutchinson: one JVP with a fixed Rademacher/Gaussian probe per sample,
  ``div ≈ eps . (J eps)``.
"""
from typing import Callable, Optional

import jax
import jax.numpy as jnp

BatchedField = Callable[[jax.Array], jax.Array]  # [B, D] -> [B, D]


def value_and_exact_divergence(
    f: BatchedField,
    x: jax.Array,
    column_chunk: Optional[int] = None,
    basis: Optional[jax.Array] = None,
    trace_offset: Optional[jax.Array] = None,
) -> "tuple[jax.Array, jax.Array]":
    """Field value and exact per-sample divergence in one linearization.

    The ODE's augmented state needs both ``f(x)`` and ``div f(x)`` at every
    stage; computing them through a single `jax.linearize` shares the primal
    pass (the reference evaluates the field and its D VJPs separately per
    sample, `sample_and_log_prob.py:64-66`).

    Args:
        f: batched field; must act independently per batch element.
        x: ``[B, D]`` evaluation points.
        column_chunk: if set, process Jacobian columns in chunks of this size
            via `lax.scan` (bounds peak memory to ``chunk`` forward passes).
        basis: optional ``[K, D]`` orthonormal rows restricting the trace:
            the returned divergence is ``sum_k u_k^T J u_k (+ trace_offset)``.
            With ``K < D`` this is cheaper than the full trace — use when the
            complement's contribution is known analytically (see
            `cnf/build.py`: the EGNN's translation directions are exact
            eigenvectors, so only the 36 zero-CoM columns need JVPs).
            ``None`` = identity basis = full exact trace.
        trace_offset: analytic contribution of the complement of
            ``span(basis)`` (scalar, may depend on params).

    Returns:
        ``(f(x) [B, D], divergence [B])``.
    """
    B, D = x.shape
    if basis is None:
        basis = jnp.eye(D, dtype=x.dtype)
    else:
        basis = basis.astype(x.dtype)
    K = basis.shape[0]

    # Linearize once: the primal (with all its nonlinear activations) is
    # computed a single time; each Jacobian column is then one application
    # of the linear map — ~2x cheaper than re-running jvp per column.
    value, jvp_lin = jax.linearize(f, x)

    def col(e):  # e: [D] -> diag contribution u^T J u, [B]
        jv = jvp_lin(jnp.broadcast_to(e, (B, D)))
        # jv[b, :] = J_b @ e ; the diagonal contribution is e . (J_b @ e).
        return jnp.sum(jv * e[None, :], axis=-1)

    if column_chunk is None or column_chunk >= K:
        div = jnp.sum(jax.vmap(col)(basis), axis=0)
    else:
        # Pad K up to a multiple of the chunk so scan sees a static shape.
        n_chunks = -(-K // column_chunk)
        pad = n_chunks * column_chunk - K
        basis_p = jnp.concatenate([basis, jnp.zeros((pad, D), x.dtype)], axis=0)
        basis_p = basis_p.reshape(n_chunks, column_chunk, D)

        def scan_body(acc, es):
            return acc + jnp.sum(jax.vmap(col)(es), axis=0), None

        div, _ = jax.lax.scan(scan_body, jnp.zeros((B,), x.dtype), basis_p)

    if trace_offset is not None:
        div = div + jnp.asarray(trace_offset, x.dtype)
    return value, div


def exact_divergence(
    f: BatchedField, x: jax.Array, column_chunk: Optional[int] = None
) -> jax.Array:
    """Exact per-sample divergence (see `value_and_exact_divergence`)."""
    return value_and_exact_divergence(f, x, column_chunk)[1]


def zero_com_trace_basis(n_nodes: int, dim: int) -> jax.Array:
    """Orthonormal basis of the zero-centre-of-mass hyperplane, flattened.

    Returns ``[(n_nodes-1)*dim, n_nodes*dim]`` rows ``u_{k,d}`` built from the
    Helmert basis of the zero-sum subspace of R^{n_nodes}:
    ``u_{k,d}[i*dim + j] = w_k[i] * delta_{jd}`` — orthonormal, each with zero
    per-dimension node sum, together with the ``dim`` uniform-translation
    directions completing an orthonormal basis of R^{n_nodes*dim}.

    Used to split the exact Jacobian trace of a translation-structured field
    (EGNN with output recentring, `models/egnn.py:204-208`) into JVP columns
    on this basis plus an analytic translation term (`cnf/build.py`).
    """
    import numpy as np

    w = np.zeros((n_nodes - 1, n_nodes))
    for k in range(1, n_nodes):
        norm = 1.0 / np.sqrt(k * (k + 1.0))
        w[k - 1, :k] = norm
        w[k - 1, k] = -k * norm
    basis = np.einsum("kn,dj->kdnj", w, np.eye(dim))  # [K, dim, N, dim]
    return jnp.asarray(
        basis.reshape((n_nodes - 1) * dim, n_nodes * dim), dtype=jnp.float32
    )


def sharded_value_and_exact_divergence(
    f: BatchedField,
    x: jax.Array,
    mesh,
    axis_name: str = "data",
    batch_axis: Optional[str] = None,
    basis: Optional[jax.Array] = None,
    trace_offset: Optional[jax.Array] = None,
) -> "tuple[jax.Array, jax.Array]":
    """Exact divergence with the D Jacobian columns sharded across a mesh.

    The workload's analogue of sequence parallelism (SURVEY §5): the eval
    batch axis is the usual sharding axis, but for *small-batch* scoring
    (single-molecule log-prob, latency-sensitive serving) the D tangent
    columns are the bigger axis — e.g. D=57 for QM9 vs a batch of 1.  Here
    every device linearizes the field once on its batch shard and runs
    only its ``D / n_devices`` basis columns; one ``psum`` produces the
    full trace.

    On a 2-D ``(batch_axis, axis_name)`` mesh both axes shard at once:
    each device holds ``B / n_batch`` samples x ``D / n_trace`` columns.

    Args:
        f: batched field; must act independently per batch element.
        x: ``[B, D]`` evaluation points (sharded along ``batch_axis`` if
            given, else replicated).
        mesh: the `jax.sharding.Mesh` to shard over.
        axis_name: mesh axis carrying the trace columns (reuses the data
            axis on the standard 1-D mesh).
        batch_axis: optional mesh axis carrying the batch.

    Returns:
        ``(f(x) [B, D], divergence [B])``, sharded along ``batch_axis``.
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    B, D = x.shape
    n = mesh.shape[axis_name]
    if basis is None:
        basis = jnp.eye(D, dtype=x.dtype)
    else:
        basis = basis.astype(x.dtype)
    n_pad = (-basis.shape[0]) % n
    # Padded rows are zero vectors: their JVP contributes 0 to the trace.
    basis = jnp.concatenate([basis, jnp.zeros((n_pad, D), x.dtype)], axis=0)

    def local(x_loc, basis_local):
        Bl = x_loc.shape[0]
        value, jvp_lin = jax.linearize(f, x_loc)

        def col(e):
            jv = jvp_lin(jnp.broadcast_to(e, (Bl, D)))
            return jnp.sum(jv * e[None, :], axis=-1)

        partial = jnp.sum(jax.vmap(col)(basis_local), axis=0)
        return value, jax.lax.psum(partial, axis_name)

    value, div = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(batch_axis), P(axis_name)),
        out_specs=(P(batch_axis), P(batch_axis)),
        check_vma=False,
    )(x, basis)
    if trace_offset is not None:
        div = div + jnp.asarray(trace_offset, x.dtype)
    return value, div


def value_and_hutchinson_divergence(
    f: BatchedField, x: jax.Array, eps: jax.Array
) -> "tuple[jax.Array, jax.Array]":
    """Field value and Hutchinson trace estimate with a fixed probe.

    ``div ≈ eps . (J eps)`` per sample — equal in expectation (over
    ``eps ~ N(0, I)``) to the exact trace.  The reference uses a single
    fixed probe drawn once per datapoint (`sample_and_log_prob.py:55,75-77`);
    pass that probe as ``eps``.

    Args:
        x: ``[B, D]``.
        eps: ``[B, D]`` probe vectors.

    Returns:
        ``(f(x) [B, D], divergence estimate [B])``.
    """
    value, jv = jax.jvp(f, (x,), (eps,))
    return value, jnp.sum(jv * eps, axis=-1)


def hutchinson_divergence(f: BatchedField, x: jax.Array, eps: jax.Array) -> jax.Array:
    """Hutchinson trace estimate (see `value_and_hutchinson_divergence`)."""
    return value_and_hutchinson_divergence(f, x, eps)[1]


def value_and_multi_probe_hutchinson(
    f: BatchedField, x: jax.Array, eps: jax.Array
) -> "tuple[jax.Array, jax.Array]":
    """Hutchinson estimate averaged over K probes (variance / K).

    Beyond-reference capability: the reference is fixed at one probe
    (`sample_and_log_prob.py:55`); multiple probes interpolate between the
    1-pass estimate and the D-pass exact trace.  Uses one linearize, so the
    primal is shared across probes.

    Args:
        x: ``[B, D]``.
        eps: ``[K, B, D]`` probe vectors.

    Returns:
        ``(f(x) [B, D], divergence estimate [B])``.
    """
    value, jvp_lin = jax.linearize(f, x)
    ests = jax.vmap(lambda e: jnp.sum(jvp_lin(e) * e, axis=-1))(eps)  # [K, B]
    return value, jnp.mean(ests, axis=0)


def value_and_hutchpp_divergence(
    f: BatchedField, x: jax.Array, sketch: jax.Array, probes: jax.Array
) -> "tuple[jax.Array, jax.Array]":
    """Hutch++ trace estimate (Meyer, Musco, Musco & Woodruff 2021),
    non-symmetric form.

    Per sample: ``Q = qr(J S)`` from sketch directions ``S``; then

        tr(J) = tr(Qᵀ J Q) + E_ε[ gᵀ J g ],   g = (I − QQᵀ) ε

    — exact decomposition (the cross terms ``tr(P J (I−P))`` vanish for
    any orthogonal projector ``P = QQᵀ``), so the estimator is unbiased
    for ANY Jacobian; the stochastic part only sees the spectrum outside
    the sketched subspace, which is where the variance reduction over
    plain Hutchinson comes from when the spectrum decays.  Beyond-
    reference capability (the reference is fixed at one plain probe,
    `ecnf/cnf/sample_and_log_prob.py:55`).

    Cost: ``2·M1 + M2`` Jacobian-vector products on a shared linearize
    primal, plus a batched thin QR ([B, D, M1], negligible at these D).

    Args:
        x: ``[B, D]``.
        sketch: ``[M1, B, D]`` sketch directions (Gaussian).
        probes: ``[M2, B, D]`` residual probes (Gaussian).

    Returns:
        ``(f(x) [B, D], divergence estimate [B])``.
    """
    value, jvp_lin = jax.linearize(f, x)
    y = jax.vmap(jvp_lin)(sketch)  # [M1, B, D] = J s_k
    q, _ = jnp.linalg.qr(jnp.transpose(y, (1, 2, 0)))  # [B, D, M1], thin
    qk = jnp.transpose(q, (2, 0, 1))  # [M1, B, D]
    jq = jax.vmap(jvp_lin)(qk)
    t_sketch = jnp.einsum("kbd,kbd->b", jq, qk)  # tr(Qᵀ J Q)
    if probes.shape[0] == 0:
        # Pure-sketch estimate: exact iff the sketch spans the Jacobian's
        # range (low-rank J); otherwise it drops tr((I-P) J (I-P)).
        return value, t_sketch
    # g_j = eps_j - Q (Qᵀ eps_j), then mean_j gᵀ J g.
    qte = jnp.einsum("bdk,jbd->jbk", q, probes)
    g = probes - jnp.einsum("bdk,jbk->jbd", q, qte)
    jg = jax.vmap(jvp_lin)(g)
    t_resid = jnp.mean(jnp.einsum("jbd,jbd->jb", jg, g), axis=0)
    return value, t_sketch + t_resid
