from ecnf_jax.parallel.mesh import (
    DATA_AXIS,
    TRACE_AXIS,
    get_mesh,
    get_mesh_2d,
    replicated,
    data_sharded,
    shard_batch,
    replicate,
    pad_to_multiple,
)
from ecnf_jax.parallel.distributed import (
    maybe_initialize_distributed,
    process_batch_slice,
)
