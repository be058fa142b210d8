"""ecnf_jax: SE(3)-equivariant continuous normalizing flows trained by flow
matching, in plain JAX.

Built with the capabilities of the `ecnf` reference baseline (NeurIPS
2023, arXiv 2308.10364):

- ``ecnf_jax.ops``       — numerics, batched ODE engine (fixed + adaptive
  Dopri5), divergence/trace estimators, the hand-linearized EGNN trace.
- ``ecnf_jax.models``    — MLP / StableMLP / dense-edge batched EGNN vector
  fields on a small flax-free parameter-module layer.
- ``ecnf_jax.cnf``       — flow-matching CNF: OT conditional path, zero-CoM
  Gaussian base, loss, sampling / exact + Hutchinson log-prob.
- ``ecnf_jax.parallel``  — device mesh, sharded (GSPMD) train/eval steps,
  multi-host init.
- ``ecnf_jax.training``  — training state, loop harness, evaluation (ESS),
  checkpoints, loggers, typed config.
- ``ecnf_jax.targets``   — datasets (DW4 / LJ13 / QM9 / ALDP), Boltzmann
  energies, MCMC data regeneration.

Design stance (vs. the reference's per-sample + vmap + diffrax + scatter_sum
style): everything is batched-first with static shapes; graphs are dense
``[B, N, N]`` tensors (N <= 22 here, so dense masked edges turn gathers and
scatters into batched matmuls); the ODE integrator is a ``lax.while_loop``
with per-sample PI-controlled adaptive steps; training/eval steps are
written once against a ``jax.sharding.Mesh`` and run on 1 device or many
unchanged.
"""

__version__ = "0.1.0"
