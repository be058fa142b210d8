from ecnf_jax.models.mlp import MLP, StableMLP, ConcatDense
from ecnf_jax.models.egnn import EGCL, EGNN
from ecnf_jax.models.vector_net import VectorNet
