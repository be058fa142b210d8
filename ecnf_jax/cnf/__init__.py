from ecnf_jax.cnf.core import FlowMatchingCNF, optimal_transport_conditional_vf
from ecnf_jax.cnf.base import ZeroCoMGaussian, DiagGaussian, remove_mean
from ecnf_jax.cnf.build import build_cnf, build_mlp_cnf, FlatEGNNField
from ecnf_jax.cnf.loss import flow_matching_loss_fn
from ecnf_jax.cnf.sampling import (
    SolveConfig,
    sample_cnf,
    get_log_prob,
    sample_and_log_prob_cnf,
)
