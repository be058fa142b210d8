"""Multi-host initialization and host-local data utilities.

Equivalent of "the distributed backend the reference never had"
(SURVEY §2c): `jax.distributed.initialize` for multi-host process groups;
XLA then lowers the GSPMD collectives to the backend's own (NCCL on GPUs)
— no hand-written NCCL/MPI code is needed.
"""
import os
from typing import Optional, Sequence

import jax

# Within-process re-entrancy guard that does not depend on jax internals:
# set on our own successful `jax.distributed.initialize` call and checked
# before probing `jax._src.distributed.global_state` (which fails open to
# False if those internals ever move — ADVICE r4).
_INITIALIZED = False


def _distributed_client_active() -> bool:
    """Whether `jax.distributed.initialize` has already run in this process.

    Deliberately answered WITHOUT calling `jax.process_count()` /
    `jax.devices()`: those initialize the XLA backends as a side effect,
    and once backends exist `jax.distributed.initialize` is too late — the
    exact footgun the round-3 version of this helper had (VERDICT r3).
    """
    try:
        from jax._src import distributed as _distributed

        return _distributed.global_state.client is not None
    except Exception:  # pragma: no cover - jax internals moved; fail open
        return False


def maybe_initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> bool:
    """Initialize JAX's multi-host runtime when running under a launcher.

    Call this FIRST in any entry point that may run multi-host — before
    anything touches a jax backend (`jax.devices()`, `jax.process_count()`,
    eager ops).  Explicit args win; otherwise the standard
    ``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID`` env vars
    are consulted.  With no coordinator configured this is a no-op
    (single-process run).  Re-entrant: a second call after a successful
    initialize is a no-op, checked without initializing backends.

    Returns True when `jax.distributed.initialize` was invoked.
    """
    global _INITIALIZED
    if _INITIALIZED or _distributed_client_active():
        return False
    if coordinator_address is None:
        coordinator_address = os.environ.get("COORDINATOR_ADDRESS")
    if coordinator_address is None:
        return False  # single-process run; leave backends untouched
    if num_processes is None and "NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["NUM_PROCESSES"])
    if process_id is None and "PROCESS_ID" in os.environ:
        process_id = int(os.environ["PROCESS_ID"])
    kwargs = {}
    if local_device_ids is not None:
        kwargs["local_device_ids"] = list(local_device_ids)
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            **kwargs,
        )
    except RuntimeError as e:
        # A concurrent/prior initialize (possibly outside this helper) is a
        # benign no-op, not a crash; anything else is a real failure.
        # JAX's wording: "distributed.initialize should only be called
        # once." — also match the generic phrasing for robustness.
        msg = str(e).lower()
        if "only be called once" in msg or "already initialized" in msg:
            _INITIALIZED = True
            return False
        raise
    _INITIALIZED = True
    return True


def process_batch_slice(global_batch_size: int) -> slice:
    """The slice of a global batch this host should load.

    With per-host data loading, each process reads only its shard of the
    global batch; `jax.make_array_from_process_local_data` assembles the
    global array.
    """
    n = jax.process_count()
    i = jax.process_index()
    per_host = global_batch_size // n
    return slice(i * per_host, (i + 1) * per_host)
