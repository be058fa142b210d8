"""CNF sampling and exact / Hutchinson log-density — batched ODE solves.

Behavioral parity with the reference's `ecnf/cnf/sample_and_log_prob.py`
(`sample_cnf :11-38`, `get_log_prob :41-94`, `sample_and_log_prob_cnf
:97-149`), re-designed for batched solves:

- One batched ODE solve per call (the reference vmaps per-sample diffrax
  solves); every RK stage is a full-batch network evaluation.
- The divergence rides in the state as an extra column (``[B, D+1]``), so
  the adaptive controller's error norm covers the joint (x, logdet) state —
  same as diffrax over the reference's tuple state.
- Exact trace = D forward-mode JVP columns of the *batched* field
  (`ecnf_jax/ops/divergence.py`), optionally chunked; Hutchinson uses one
  fixed Gaussian probe per sample, drawn once per call (the reference's
  single fixed-eps semantics, `sample_and_log_prob.py:55,75-77`).

Known reference quirk (not reproduced): its fixed-step `sample_and_log_prob`
branch passes ``y0=x0`` without the log-det slot
(`sample_and_log_prob.py:140`) and would crash; here the fixed-step path
carries the augmented state correctly.
"""
from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ecnf_jax.cnf.core import FlowMatchingCNF
from ecnf_jax.ops.ode import odeint, ODEStats
from ecnf_jax.ops.divergence import (
    sharded_value_and_exact_divergence,
    value_and_exact_divergence,
    value_and_hutchinson_divergence,
    value_and_multi_probe_hutchinson,
    value_and_hutchpp_divergence,
)


@dataclass(frozen=True)
class SolveConfig:
    """ODE-solve settings (static / hashable, safe as a jit constant).

    Defaults match the reference's diffrax calls
    (`sample_and_log_prob.py:14-16,36`): Dopri5, rtol=atol=1e-5, dtmin=1e-5
    adaptive, or fixed step 0.05.
    """

    use_fixed_step_size: bool = False
    rtol: float = 1e-5
    atol: float = 1e-5
    dtmin: float = 1e-5
    step_size: float = 0.05
    max_steps: int = 4096
    # Fixed-step method: "dopri5" (reference parity) or "rk4" (4 instead of
    # 6 field evaluations per step, one order lower accuracy; adaptive
    # solves ignore this).  Accuracy on a trained model: PERF.md.
    method: str = "dopri5"
    trace_column_chunk: Optional[int] = None
    # Hutchinson probes for approximate log-prob (reference is fixed at 1,
    # `sample_and_log_prob.py:55`; >1 reduces estimator variance by 1/K).
    hutchinson_probes: int = 1
    # Hutch++ (ops/divergence.py): when > 0, the approximate divergence
    # sketches the Jacobian's dominant subspace with this many directions
    # (per sample, per stage) and runs `hutchinson_probes` plain probes on
    # the residual only.  Cost: 2*sketch + probes JVPs per stage.
    hutchpp_sketch: int = 0
    # Use the CNF's structural exact-trace shortcut when available
    # (`FlowMatchingCNF.exact_trace_plan`): JVP only the zero-CoM basis
    # columns and add the analytic translation term.  Mathematically exact
    # (tested); disable to force the identity-basis full trace.
    use_exact_trace_plan: bool = True
    # Hand-linearized trace (`FlowMatchingCNF.tangent_value_and_div`,
    # `ops/tangent.py`): same math as `jax.linearize`, one residual-capturing
    # primal shared by all columns.  Used automatically on plain solves when
    # the CNF supports it; set False to force `jax.linearize`.
    structured_tangent: bool = True


def _solve(func, y0, t0, t1, cfg: SolveConfig) -> Tuple[jax.Array, ODEStats]:
    return odeint(
        func,
        y0,
        t0,
        t1,
        use_fixed_step_size=cfg.use_fixed_step_size,
        rtol=cfg.rtol,
        atol=cfg.atol,
        dtmin=cfg.dtmin,
        step_size=cfg.step_size,
        max_steps=cfg.max_steps,
        method=cfg.method,
    )


def sample_cnf(
    cnf: FlowMatchingCNF,
    params,
    key: jax.Array,
    batch_size: int,
    features: Optional[jax.Array] = None,
    cfg: SolveConfig = SolveConfig(),
) -> jax.Array:
    """Draw ``[batch_size, D]`` flow samples by integrating t: 0 -> 1.

    Parity: reference `sample_cnf` (`sample_and_log_prob.py:11-38`), batched.
    """

    def func(t, y):
        return cnf.apply(params, y, t, features)

    x0 = cnf.sample_base(key, (batch_size,))
    x1, _ = _solve(func, x0, 0.0, 1.0, cfg)
    return x1


def _draw_probes(key, B: int, D: int, cfg: SolveConfig):
    """One fixed Gaussian probe per sample (reference semantics),
    ``[K, B, D]`` probes when ``cfg.hutchinson_probes > 1``, or a
    ``(sketch, probes)`` pair for Hutch++."""
    if cfg.hutchpp_sketch > 0:
        k1, k2 = jax.random.split(key)
        return (
            jax.random.normal(k1, (cfg.hutchpp_sketch, B, D)),
            jax.random.normal(k2, (cfg.hutchinson_probes, B, D)),
        )
    if cfg.hutchinson_probes > 1:
        return jax.random.normal(key, (cfg.hutchinson_probes, B, D))
    return jax.random.normal(key, (B, D))


def _augmented_field(
    cnf, params, features, approx: bool, eps, cfg: SolveConfig, trace_mesh=None
):
    """Vector field on the ``[B, D+1]`` (x, logdet) augmented state.

    ``trace_mesh``: optional `Mesh` — shard the exact-trace Jacobian
    columns across its data axis (for small-batch scoring where the batch
    axis is too short to fill the mesh).
    """

    basis = offset = None
    if not approx and cfg.use_exact_trace_plan and cnf.exact_trace_plan is not None:
        basis, offset = cnf.exact_trace_plan(params)

    # Hand-linearized tangent (same math as jax.linearize, one residual-
    # capturing primal shared by all columns; `ops/tangent.py`).
    # Serves both the exact trace (batch-shared basis columns) and the
    # Hutchinson estimate (per-sample probe directions).
    if (
        cfg.structured_tangent
        and cnf.tangent_value_and_div is not None
        and trace_mesh is None
        and cfg.trace_column_chunk is None
        and not (approx and cfg.hutchpp_sketch > 0)  # Hutch++ needs Jv vectors
    ):

        def func(t, y):
            x = y[:, :-1]
            if approx:
                b = eps if eps.ndim == 3 else eps[None]  # [K, B, D]
            else:
                b = basis
                if b is None:
                    b = jnp.eye(x.shape[-1], dtype=x.dtype)
            v, div = cnf.tangent_value_and_div(
                params, x, jnp.broadcast_to(t, (x.shape[0],)), features,
                b, trace_offset=None if approx else offset,
            )
            if approx and eps.ndim == 3:
                div = div / eps.shape[0]  # mean over the K probes
            return jnp.concatenate([v, div[:, None]], axis=-1)

        return func

    def func(t, y):
        x = y[:, :-1]

        def f_x(xb):
            return cnf.apply(params, xb, t, features)

        if approx:
            if isinstance(eps, tuple):
                v, div = value_and_hutchpp_divergence(f_x, x, *eps)
            elif eps.ndim == 3:
                v, div = value_and_multi_probe_hutchinson(f_x, x, eps)
            else:
                v, div = value_and_hutchinson_divergence(f_x, x, eps)
        elif trace_mesh is not None:
            v, div = sharded_value_and_exact_divergence(
                f_x, x, trace_mesh, basis=basis, trace_offset=offset
            )
        else:
            v, div = value_and_exact_divergence(
                f_x, x, column_chunk=cfg.trace_column_chunk,
                basis=basis, trace_offset=offset,
            )
        return jnp.concatenate([v, div[:, None]], axis=-1)

    return func


def get_log_prob(
    cnf: FlowMatchingCNF,
    params,
    x: jax.Array,
    key: jax.Array,
    features: Optional[jax.Array] = None,
    approx: bool = False,
    cfg: SolveConfig = SolveConfig(),
    return_stats: bool = False,
    trace_mesh=None,
):
    """Log-density of ``[B, D]`` data points by integrating t: 1 -> 0.

    Returns ``(log_p, log_prob_base, delta_log_lik)``, each ``[B]``
    (plus `ODEStats` when ``return_stats``).
    Parity: reference `get_log_prob` (`sample_and_log_prob.py:41-94`):
    ``log_p = log_prob_base(x0) + delta`` with ``delta`` the accumulated
    divergence along the reverse solve.

    ``trace_mesh``: optional `Mesh` — shard exact-trace Jacobian columns
    across devices instead of the batch (for B << n_devices scoring).
    """
    B, D = x.shape
    eps = _draw_probes(key, B, D, cfg) if approx else None
    func = _augmented_field(cnf, params, features, approx, eps, cfg, trace_mesh)
    y0 = jnp.concatenate([x, jnp.zeros((B, 1), x.dtype)], axis=-1)
    y1, stats = _solve(func, y0, 1.0, 0.0, cfg)
    x0, delta_log_lik = y1[:, :-1], y1[:, -1]
    log_prob_base = cnf.log_prob_base(x0)
    log_p = log_prob_base + delta_log_lik
    if return_stats:
        return log_p, log_prob_base, delta_log_lik, stats
    return log_p, log_prob_base, delta_log_lik


def sample_and_log_prob_cnf(
    cnf: FlowMatchingCNF,
    params,
    key: jax.Array,
    batch_size: int,
    features: Optional[jax.Array] = None,
    approx: bool = False,
    cfg: SolveConfig = SolveConfig(),
) -> Tuple[jax.Array, jax.Array]:
    """Sample and exactly score ``[batch_size, D]`` points in one forward solve.

    Returns ``(x1, log_q)``.  Parity: reference `sample_and_log_prob_cnf`
    (`sample_and_log_prob.py:97-149`): ``log_q = log_prob_base(x0) - delta``.
    """
    key_base, key_eps = jax.random.split(key)
    x0, log_prob_base = cnf.sample_and_log_prob_base(key_base, (batch_size,))
    B, D = x0.shape
    eps = _draw_probes(key_eps, B, D, cfg) if approx else None
    func = _augmented_field(cnf, params, features, approx, eps, cfg)
    y0 = jnp.concatenate([x0, jnp.zeros((B, 1), x0.dtype)], axis=-1)
    y1, _ = _solve(func, y0, 0.0, 1.0, cfg)
    x1, delta_log_lik = y1[:, :-1], y1[:, -1]
    log_q = log_prob_base - delta_log_lik
    return x1, log_q
