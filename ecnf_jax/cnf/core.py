"""Flow-matching CNF core: conditional OT path and the CNF container.

Parity with the reference's `ecnf/cnf/core.py:35-49` but batched-first:
the conditional path operates directly on ``[B, D]`` batches (the reference
defines it per-sample and vmaps at the call site, `ecnf/cnf/loss.py:25`).
"""
from typing import Any, Callable, NamedTuple, Optional, Tuple

import jax

# Batched vector-field apply: (params, x[B,D], t[B], features[B,F]?) -> [B,D]
VectorFieldApply = Callable[..., jax.Array]


def optimal_transport_conditional_vf(
    x0: jax.Array, x1: jax.Array, t: jax.Array, sigma_min: float
) -> Tuple[jax.Array, jax.Array]:
    """Conditional OT (rectified) probability path, batched.

    ``x_t = (1 - (1 - sigma_min) t) x0 + t x1``
    ``u_t = x1 - (1 - sigma_min) x0``

    Parity: reference `ecnf/cnf/core.py:35-39`.

    Args:
        x0: ``[B, D]`` base samples.
        x1: ``[B, D]`` data samples.
        t: ``[B]`` times in [0, 1].

    Returns:
        ``(x_t, u_t)`` both ``[B, D]``.
    """
    t_ = t[..., None]
    x_t = (1.0 - (1.0 - sigma_min) * t_) * x0 + t_ * x1
    u_t = x1 - (1.0 - sigma_min) * x0
    return x_t, u_t


class FlowMatchingCNF(NamedTuple):
    """All callables defining a flow-matching CNF (batched interfaces).

    Parity: reference `ecnf/cnf/core.py:42-49`, with batched signatures:

    - ``init(key, x[B,D], t[B], features?) -> params``
    - ``apply(params, x[B,D], t[B], features?) -> [B,D]``
    - ``sample_base(key, batch_shape) -> [*batch_shape, D]``
    - ``get_x_t_and_conditional_u_t(x0, x1, t) -> (x_t, u_t)``
    - ``log_prob_base(x[...,D]) -> [...]``
    - ``sample_and_log_prob_base(key, batch_shape) -> (x, log_p)``

    ``exact_trace_plan`` is an optional structural shortcut for the exact
    Jacobian trace (no reference analogue): ``params -> (basis [K, D],
    trace_offset [])`` such that ``trace(J) = sum_k u_k^T J u_k +
    trace_offset`` exactly, with ``K < D`` orthonormal rows.  For the EGNN
    field the ``dim`` uniform-translation directions are exact eigenvectors
    with eigenvalue ``-final_scaling`` (the torso is translation-invariant;
    only the output recentring depends on the mean, `models/egnn.py:178,205`),
    so only the ``(N-1)*dim`` zero-CoM columns need JVPs.  Used by default on
    exact-trace solves; disable via ``SolveConfig(use_exact_trace_plan=False)``.

    ``tangent_value_and_div`` is an optional hand-linearized trace fast path
    (no reference analogue; see `ops/tangent.py`):
    ``(params, x, t, features, basis, trace_offset) -> (v [B, D], div [B])``
    — same math as `jax.linearize` but with a single residual-capturing
    primal shared by all trace columns (default on exact and Hutchinson
    solves via ``SolveConfig(structured_tangent)``).
    """

    init: Callable[..., Any]
    apply: VectorFieldApply
    sample_base: Callable[..., jax.Array]
    get_x_t_and_conditional_u_t: Callable[
        [jax.Array, jax.Array, jax.Array], Tuple[jax.Array, jax.Array]
    ]
    log_prob_base: Callable[[jax.Array], jax.Array]
    sample_and_log_prob_base: Callable[..., Tuple[jax.Array, jax.Array]]
    exact_trace_plan: Optional[Callable[[Any], Tuple[jax.Array, jax.Array]]] = None
    tangent_value_and_div: Optional[
        Callable[..., Tuple[jax.Array, jax.Array]]
    ] = None
