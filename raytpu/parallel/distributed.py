"""Multi-host (multi-process) bootstrap for raytpu.

Reference analog: the process-level "cluster init" is the OpenMP thread
probe in `raytracer/Source/raytracer.cpp:118-136` — discover how much
parallelism exists, then configure the run to use it. The JAX
equivalent is `jax.distributed.initialize()`: after it, `jax.devices()`
spans every host and the existing ('data', 'model') mesh code
(raytpu.parallel.mesh) shards over the devices of all hosts with NO
other changes — the same shard_map renderers run unmodified.

Usage (one call per process, before device work):

    from raytpu.parallel import init_distributed
    state = init_distributed()            # env/auto-detected
    state = init_distributed(             # or explicit
        coordinator_address="10.0.0.1:8476",
        num_processes=4, process_id=rank)

Resolution order for each field: explicit argument, then RAYTPU_* /
standard env (RAYTPU_COORDINATOR / JAX_COORDINATOR_ADDRESS,
RAYTPU_NUM_PROCESSES, RAYTPU_PROCESS_ID), then JAX's own auto-detection
(SLURM, OpenMPI) when the environment clearly is
multi-host, else a single-process no-op. The degenerate explicit
`num_processes=1` call DOES bring up the coordinator service locally —
the same code path a cluster run takes, exercised by tests/test_distributed.py
without a cluster.
"""

from __future__ import annotations

import dataclasses
import os
import socket

import jax

__all__ = ["DistributedState", "init_distributed", "shutdown_distributed"]


@dataclasses.dataclass(frozen=True)
class DistributedState:
    """Summary of the process's place in the (possibly 1-process) job."""

    enabled: bool            # did jax.distributed.initialize() run?
    num_processes: int
    process_id: int

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0


_STATE: DistributedState | None = None

# Env markers that indicate a real multi-host launch JAX can auto-detect.
_AUTODETECT_MARKERS = (
    "SLURM_JOB_ID",
    "OMPI_COMM_WORLD_SIZE",
)


def _free_local_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids: list[int] | None = None,
) -> DistributedState:
    """Bring up JAX's multi-process runtime (idempotent).

    Returns a :class:`DistributedState`. Call before creating meshes;
    afterwards `jax.devices()` is global and `jax.process_index()` /
    `jax.process_count()` are live. A second call returns the existing
    state unchanged.
    """
    global _STATE
    if _STATE is not None:
        return _STATE

    env = os.environ
    coordinator_address = (
        coordinator_address
        or env.get("RAYTPU_COORDINATOR")
        or env.get("JAX_COORDINATOR_ADDRESS")
    )
    if num_processes is None:
        raw = env.get("RAYTPU_NUM_PROCESSES")
        num_processes = int(raw) if raw else None
    if process_id is None:
        raw = env.get("RAYTPU_PROCESS_ID")
        process_id = int(raw) if raw else None

    auto = any(m in env for m in _AUTODETECT_MARKERS)
    # A bare coordinator address alongside auto-detect markers (e.g. a
    # SLURM/OMPI launcher exporting JAX_COORDINATOR_ADDRESS) is NOT an
    # explicit raytpu config: forcing num_processes=1 there would override
    # JAX's cluster plugins and mis-initialize the job. Only a process
    # count (or a coordinator address with no cluster markers) counts as
    # explicit.
    explicit = num_processes is not None or (
        coordinator_address is not None and not auto
    )

    if not explicit and not auto:
        # Plain single-process run (this dev image, unit tests, CI):
        # nothing to bootstrap; mesh code sees the local devices only.
        _STATE = DistributedState(enabled=False, num_processes=1,
                                  process_id=0)
        return _STATE

    if explicit:
        if num_processes is None:
            num_processes = 1
        if num_processes > 1 and process_id is None:
            # Defaulting process_id=0 here would make every process race
            # to be coordinator and hang the job — fail fast instead.
            raise ValueError(
                "init_distributed: num_processes="
                f"{num_processes} > 1 but process_id is unresolved — set "
                "RAYTPU_PROCESS_ID or pass process_id explicitly"
            )
        if process_id is None:
            process_id = 0
        if coordinator_address is None:
            if num_processes > 1:
                # Each process would invent its own port and never meet.
                raise ValueError(
                    "init_distributed: num_processes > 1 requires a "
                    "shared coordinator_address (RAYTPU_COORDINATOR)"
                )
            # Degenerate 1-process job: host the coordinator locally on a
            # free port — the full service bring-up, no cluster needed.
            coordinator_address = f"127.0.0.1:{_free_local_port()}"
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids,
        )
    else:
        # Multi-host markers present: let JAX's cluster plugins resolve
        # coordinator/rank (SLURM, OpenMPI).
        jax.distributed.initialize(local_device_ids=local_device_ids)

    _STATE = DistributedState(
        enabled=True,
        num_processes=jax.process_count(),
        process_id=jax.process_index(),
    )
    return _STATE


def shutdown_distributed() -> None:
    """Tear down the runtime (tests; long-lived drivers on exit)."""
    global _STATE
    if _STATE is not None and _STATE.enabled:
        jax.distributed.shutdown()
    _STATE = None
