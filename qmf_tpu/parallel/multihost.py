"""Multi-host initialization for sharded training.

The reference's multi-machine story is its scheduler/labor TCP star
(reference distributed/): the scheduler ships the dataset and factors to
every labor over sockets. Here: every host runs the same
SPMD program; hosts rendezvous through the JAX coordination service over
the host network, each host feeds its local cards, and cross-card traffic
rides NVLink within a host. This module is the thin host-side bootstrap for
that.

Typical use (one command per host, e.g. launched by the scheduler's
labor agents):

    from qmf_tpu.parallel import multihost
    multihost.initialize(coordinator="10.0.0.1:8476",
                         num_processes=4, process_id=host_rank)
    mesh = multihost.global_mesh()
    engine = ShardedWALSEngine(cfg, mesh=mesh)
"""

from __future__ import annotations

import os
from typing import Optional

from qmf_tpu.utils.logging import log


def initialize(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the jax.distributed rendezvous (no-op for single-process runs).

    Arguments default to the standard env vars (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID) so launchers can configure hosts
    uniformly.
    """
    import jax

    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator is None:
        log.info("multihost: no coordinator configured, single-process mode")
        return
    num_processes = int(
        num_processes
        if num_processes is not None
        else os.environ.get("JAX_NUM_PROCESSES", "1")
    )
    process_id = int(
        process_id
        if process_id is not None
        else os.environ.get("JAX_PROCESS_ID", "0")
    )
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    log.info(
        "multihost: joined as process %d/%d (coordinator %s), "
        "%d local / %d global devices",
        process_id,
        num_processes,
        coordinator,
        jax.local_device_count(),
        jax.device_count(),
    )


def global_mesh(axis_name: str = "d"):
    """1-D mesh over every device across all participating hosts."""
    from qmf_tpu.parallel.mesh import make_mesh

    return make_mesh(axis_name=axis_name)


def is_coordinator() -> bool:
    import jax

    return jax.process_index() == 0
