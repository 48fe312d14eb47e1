"""Multi-host execution: jax.distributed init + global-mesh rendering.

The reference is single-process only. Here the same shard_map program from
sharding.py runs unchanged over a multi-host global mesh: every host runs
this module, paths shard over all devices globally, the light-vertex
all-gather crosses the device interconnect (and the network across
hosts), and the framebuffer psum produces the full image on every host.

Failure model (SURVEY.md section 5): fail-fast — inter-iteration state is
only (framebuffer, iteration, seed), so any failure is recovered by
re-running from the last checkpoint (checkpoint.py) with bit-identical
results thanks to the counter-based RNG.
"""

from __future__ import annotations

import jax

from .sharding import AXIS, Mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """jax.distributed.initialize wrapper; no-op on a single process."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh() -> Mesh:
    """1-D 'paths' mesh over every chip in the job (all hosts)."""
    return Mesh(jax.devices(), (AXIS,))


def is_coordinator() -> bool:
    return jax.process_index() == 0
