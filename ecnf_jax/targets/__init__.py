from ecnf_jax.targets.data import (
    FullGraphSample,
    positional_dataset_only_to_full_graph,
    load_dw4,
    load_lj13,
    load_qm9,
    load_aldp,
)
from ecnf_jax.targets.energies import (
    double_well_energy,
    double_well_log_prob,
    lennard_jones_energy,
    lennard_jones_log_prob,
)
from ecnf_jax.targets.mcmc import run_hmc
from ecnf_jax.targets.mog import MoGTarget
from ecnf_jax.targets.qm9_extras import (
    ProcessedDataset,
    add_thermo_targets,
    get_thermo_dict,
    collate_fn,
)
