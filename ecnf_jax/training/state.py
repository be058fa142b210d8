"""Training state and the (sharded) flow-matching update step.

Parity with the reference's `ecnf/cnf/gradient_step.py:13-53`
(`TrainingState`, `flow_matching_update_fn`: grad of the FM loss, optax
update, optional EMA, grad/update norms) with two deliberate changes:

- EMA off is represented by ``ema_params=None`` (an empty pytree), not the
  reference's ``jnp.array(None)`` sentinel (`setup_training.py:137`,
  `gradient_step.py:46`) — same observable behavior, no dtype hack.
- The step is built against a ``jax.sharding.Mesh``: parameters/opt state
  replicated, batch sharded over the ``data`` axis.  XLA inserts the
  gradient all-reduce; the identical step runs on one device when the mesh
  has one device.
"""
from typing import Any, Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from ecnf_jax.cnf.core import FlowMatchingCNF
from ecnf_jax.cnf.loss import flow_matching_loss_fn
from ecnf_jax.parallel.mesh import data_sharded, replicated


class TrainingState(NamedTuple):
    params: Any
    opt_state: optax.OptState
    key: jax.Array
    ema_params: Optional[Any] = None


def init_training_state(
    cnf: FlowMatchingCNF,
    optimizer: optax.GradientTransformation,
    key: jax.Array,
    example_x: jax.Array,
    example_features: Optional[jax.Array] = None,
    use_ema: bool = False,
) -> TrainingState:
    """Initialize params/opt state from example inputs.

    Parity: reference `setup_training.py:133-140` (init on a 2-row example
    batch with t=0).
    """
    t0 = jnp.zeros(example_x.shape[0])
    if example_features is not None:
        params = cnf.init(key, example_x, t0, example_features)
    else:
        params = cnf.init(key, example_x, t0)
    opt_state = optimizer.init(params)
    # EMA starts at a *copy* of params: the update step donates the state
    # buffers, and aliasing params/ema_params would donate them twice.
    ema_params = (
        jax.tree_util.tree_map(lambda x: x.copy(), params) if use_ema else None
    )
    return TrainingState(params=params, opt_state=opt_state, key=key, ema_params=ema_params)


def make_update_fn(
    cnf: FlowMatchingCNF,
    optimizer: optax.GradientTransformation,
    use_ema: bool = False,
    ema_beta: float = 0.999,
    mesh=None,
    microbatch: Optional[int] = None,
) -> Callable[[TrainingState, jax.Array, Optional[jax.Array]], Tuple[TrainingState, dict]]:
    """Build the jitted (and, with a mesh, GSPMD-sharded) train step.

    Returns ``update(state, x_data, features) -> (state, info)`` with info
    keys ``loss``, ``grad_norm``, ``update_norm`` (reference
    `gradient_step.py:39-44`).

    ``microbatch=k`` computes the batch gradient as the mean of ``k``
    sequential chunk gradients (identical math — grad of a mean is the
    mean of chunk grads; the per-sample RNG draws are assigned per chunk
    instead of per batch, a different but distributionally identical
    stream).  It bounds the step's activation memory to one chunk; the
    value of k on the GPU is for the ledger to decide (ROADMAP).
    """

    def _grads(state, x_data, features, subkey):
        if microbatch is None or microbatch <= 1:
            return jax.grad(flow_matching_loss_fn, argnums=1, has_aux=True)(
                cnf, state.params, x_data, subkey, features
            )
        k = microbatch
        B = x_data.shape[0]
        assert B % k == 0, f"batch {B} not divisible by microbatch {k}"
        chunks = x_data.reshape(k, B // k, *x_data.shape[1:])
        feats_c = (
            None
            if features is None
            else features.reshape(k, B // k, *features.shape[1:])
        )
        subkeys = jax.random.split(subkey, k)

        def one_chunk(gsum, inp):
            xc, fc, kc = inp
            g, info = jax.grad(
                flow_matching_loss_fn, argnums=1, has_aux=True
            )(cnf, state.params, xc, kc, fc)
            return jax.tree_util.tree_map(jnp.add, gsum, g), info["loss"]

        g0 = jax.tree_util.tree_map(
            lambda p: jnp.zeros_like(p), state.params
        )
        gsum, losses = jax.lax.scan(one_chunk, g0, (chunks, feats_c, subkeys))
        grads = jax.tree_util.tree_map(lambda g: g / k, gsum)
        return grads, {"loss": jnp.mean(losses)}

    def update(
        state: TrainingState, x_data: jax.Array, features: Optional[jax.Array]
    ) -> Tuple[TrainingState, dict]:
        key, subkey = jax.random.split(state.key)
        grads, info = _grads(state, x_data, features, subkey)
        updates, new_opt_state = optimizer.update(
            grads, state.opt_state, params=state.params
        )
        new_params = optax.apply_updates(state.params, updates)
        info = dict(info)
        info.update(
            grad_norm=optax.global_norm(grads),
            update_norm=optax.global_norm(updates),
        )
        if use_ema:
            ema_params = jax.tree_util.tree_map(
                lambda bar, new: bar * ema_beta + (1.0 - ema_beta) * new,
                state.ema_params,
                new_params,
            )
        else:
            ema_params = state.ema_params
        return (
            TrainingState(
                params=new_params, opt_state=new_opt_state, key=key, ema_params=ema_params
            ),
            info,
        )

    if mesh is None:
        return jax.jit(update)

    rep = replicated(mesh)
    data = data_sharded(mesh)
    return jax.jit(
        update,
        in_shardings=(rep, data, data),
        out_shardings=(rep, rep),
        donate_argnums=(0,),
    )
