from ecnf_jax.ops.numerics import (
    safe_norm,
    vector_rejection,
    rotate_3d,
    maybe_masked_mean,
    get_leading_axis_tree,
    timestep_embedding,
)
from ecnf_jax.ops.graph import (
    get_senders_and_receivers_fully_connected,
    dense_edge_mask,
    pairwise_difference,
)
from ecnf_jax.ops.ode import odeint, odeint_adaptive, odeint_fixed, ODEStats
from ecnf_jax.ops.divergence import (
    exact_divergence,
    hutchinson_divergence,
    sharded_value_and_exact_divergence,
    value_and_exact_divergence,
    value_and_hutchinson_divergence,
    value_and_hutchpp_divergence,
)
