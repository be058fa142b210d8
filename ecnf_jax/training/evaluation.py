"""Evaluation engine: padded-mask batching, forward/reverse ESS.

Parity with the reference's `ecnf/utils/evaluation.py` (`calculate_forward_ess
:10-22`, `setup_padded_reshaped_data :25-50`, `eval_fn :59-115`) and the
reverse-ESS computation in `setup_training.py:166-185`.  The batched scan and
mask-weighted aggregation compose with batch sharding so masked means stay
exact across devices/hosts.
"""
from typing import Any, Callable, Optional, Tuple, Union

import jax
import jax.numpy as jnp

from ecnf_jax.ops.numerics import get_leading_axis_tree

Data = Any
Mask = jax.Array


def calculate_forward_ess(log_w: jax.Array, mask: jax.Array) -> dict:
    """Forward effective sample size from log importance weights.

    ``log_w = log p(x) - log q(x)`` for ``x ~ p``.  Log-domain computation
    with non-finite weights masked (reference `evaluation.py:10-22`) — a
    diverged or budget-exhausted ODE sample yields a NaN log-density
    (`ops/ode.py`) and must not poison the aggregate.
    """
    mask = mask * jnp.isfinite(log_w).astype(mask.dtype)
    log_w = jnp.where(mask, log_w, jnp.zeros_like(log_w))
    log_z_inv = jax.nn.logsumexp(-log_w, b=mask) - jnp.log(jnp.sum(mask))
    log_z_expectation_p_over_q = jax.nn.logsumexp(log_w, b=mask) - jnp.log(
        jnp.sum(mask)
    )
    log_forward_ess = -log_z_inv - log_z_expectation_p_over_q
    return {"forward_ess": jnp.exp(log_forward_ess)}


def calculate_reverse_ess(log_w: jax.Array) -> jax.Array:
    """Normalized reverse ESS: ``1 / sum(softmax(log_w)^2) / n``.

    Parity: reference `setup_training.py:182`, hardened: non-finite
    log-weights (NaN-frozen diverged samples, `ops/ode.py`) get zero
    weight instead of poisoning the softmax.
    """
    log_w = jnp.where(jnp.isfinite(log_w), log_w, -jnp.inf)
    return 1.0 / jnp.sum(jax.nn.softmax(log_w) ** 2) / log_w.shape[0]


def setup_padded_reshaped_data(
    data: Data, interval_length: int, reshape_axis: int = 1
) -> Tuple[Data, jax.Array]:
    """Pad axis 0 to a multiple of ``interval_length`` and reshape into
    batches, returning a validity mask.

    ``reshape_axis=1`` -> ``[n_batches, interval_length, ...]`` (minibatch
    scan); ``reshape_axis=0`` -> ``[interval_length, n_batches, ...]``
    (device-leading layout).  Parity: reference `evaluation.py:25-50`.
    """
    size = jax.tree_util.tree_leaves(data)[0].shape[0]
    padding = (interval_length - size % interval_length) % interval_length
    padded_size = size + padding
    data_padded = jax.tree_util.tree_map(
        lambda x: jnp.concatenate(
            [x, jnp.zeros((padding, *x.shape[1:]), dtype=x.dtype)], axis=0
        ),
        data,
    )
    mask = jnp.zeros(padded_size, dtype=jnp.int32).at[jnp.arange(size)].set(1)

    if reshape_axis == 0:
        reshape = lambda x: jnp.reshape(
            x, (interval_length, padded_size // interval_length, *x.shape[1:])
        )
    else:
        assert reshape_axis == 1
        reshape = lambda x: jnp.reshape(
            x, (padded_size // interval_length, interval_length, *x.shape[1:])
        )
    data_reshaped, mask = jax.tree_util.tree_map(reshape, (data_padded, mask))
    return data_reshaped, mask


def eval_fn(
    x: Data,
    key: jax.Array,
    eval_on_test_batch_fn: Optional[
        Callable[..., Union[Tuple[Any, dict], dict]]
    ] = None,
    eval_batch_free_fn: Optional[Callable[..., dict]] = None,
    batch_size: Optional[int] = None,
    mask: Optional[Mask] = None,
    use_scan: bool = False,
    scan_chunk: Optional[int] = None,
    eval_on_test_chunk_fn: Optional[Callable[..., Any]] = None,
) -> Tuple[dict, Optional[Any], Optional[Mask]]:
    """Run a per-batch eval fn over padded test data and aggregate with
    per-batch mask weighting; optionally run a batch-free eval.

    Parity: reference `evaluation.py:59-115` (including the further-data
    path that flattens per-item extras, e.g. forward log-weights), with one
    deliberate change: the batch loop defaults to a *host loop over a
    per-batch jit* instead of the reference's `lax.scan`.  A scan fuses the
    whole eval (dozens of adaptive ODE solves) into a single multi-minute
    device program — which runtime watchdogs kill and which gives no
    progress signal.  The middle ground: ``scan_chunk=G`` with
    ``eval_on_test_chunk_fn`` scans
    G batches per device dispatch — same per-batch keys and outputs,
    bounded program length.  The chunk fn has signature
    ``(x_chunk, keys[G], mask_chunk) -> stacked per-batch outputs`` and
    MUST be a once-constructed jit taking any changing state (params,
    opt state) as runtime *arguments* — a fresh `jax.jit` closing over
    concrete arrays would retrace and recompile the whole G-batch program
    at every eval (see `training/setup.py:_eval_data_chunk` for the
    canonical construction).  With ``scan_chunk`` set but no chunk fn,
    the host loop is used.  ``use_scan=True`` keeps the reference's
    single-program variant.
    """
    info = {}
    key1, key2 = jax.random.split(key)
    further_info, flat_mask = None, None

    n_points = get_leading_axis_tree(x)[0]
    if mask is None:
        mask = jnp.ones(n_points, dtype=jnp.int32)

    if eval_on_test_batch_fn is not None:

        def scan_fn(carry, xs):
            x_batch, m_batch, k = xs
            out = eval_on_test_batch_fn(x_batch, key=k, mask=m_batch)
            return None, out

        (x_batched, mask_batched), mask_new = setup_padded_reshaped_data(
            (x, mask), interval_length=batch_size, reshape_axis=1
        )
        mask_batched = mask_batched * mask_new

        n_batches = get_leading_axis_tree(x_batched)[0]
        keys = jax.random.split(key1, n_batches)
        if use_scan:
            _, batched_info = jax.lax.scan(
                scan_fn, None, (x_batched, mask_batched, keys)
            )
        elif (
            eval_on_test_chunk_fn is not None
            and scan_chunk is not None
            and min(scan_chunk, n_batches) > 1
        ):
            G = min(int(scan_chunk), n_batches)
            pieces = []
            full = (n_batches // G) * G
            for start in range(0, full, G):
                x_g, m_g, k_g = jax.tree_util.tree_map(
                    lambda v: v[start:start + G],
                    (x_batched, mask_batched, keys),
                )
                pieces.append(eval_on_test_chunk_fn(x_g, k_g, m_g))
            for i in range(full, n_batches):  # remainder: per-batch dispatch
                out_i = scan_fn(
                    None,
                    jax.tree_util.tree_map(
                        lambda v: v[i], (x_batched, mask_batched, keys)
                    ),
                )[1]
                pieces.append(
                    jax.tree_util.tree_map(lambda v: jnp.asarray(v)[None], out_i)
                )
            batched_info = jax.tree_util.tree_map(
                lambda *leaves: jnp.concatenate(leaves, axis=0), *pieces
            )
        else:
            outs = [
                scan_fn(
                    None,
                    jax.tree_util.tree_map(lambda v: v[i], (x_batched, mask_batched, keys)),
                )[1]
                for i in range(n_batches)
            ]
            batched_info = jax.tree_util.tree_map(
                lambda *leaves: jnp.stack(leaves), *outs
            )

        per_batch_weighting = jnp.sum(mask_batched, axis=-1) / jnp.sum(
            jnp.sum(mask_batched, axis=-1)
        )
        if isinstance(batched_info, dict):
            info.update(
                jax.tree_util.tree_map(
                    lambda v: jnp.sum(per_batch_weighting * v), batched_info
                )
            )
        else:
            further, per_batch = batched_info
            info.update(
                jax.tree_util.tree_map(
                    lambda v: jnp.sum(per_batch_weighting * v), per_batch
                )
            )
            flat_mask, further_info = jax.tree_util.tree_map(
                lambda v: v.reshape(v.shape[0] * v.shape[1], *v.shape[2:]),
                (mask_batched, further),
            )

    if eval_batch_free_fn is not None:
        info.update(eval_batch_free_fn(key=key2))

    return info, further_info, flat_mask
