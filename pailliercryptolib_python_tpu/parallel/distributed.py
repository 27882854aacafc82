"""Multi-host wiring: jax.distributed lifecycle for meshes across hosts.

The reference has no distribution layer at all — federated-learning users
pickle ciphertexts between processes (SURVEY.md §2.4).  Here multi-host
runs are first-class: every host calls :func:`initialize` before touching
devices, then :func:`pailliercryptolib_python_tpu.parallel.mesh.make_mesh`
lays hosts on the outer mesh axis and each host's devices on the inner
axis, and the sharded collectives in parallel/collective.py span both.

Single-process (and CPU-simulated) runs work without any of this; the
helpers below are no-ops when no multi-host environment is detected.

Environment contract (standard JAX coordinator bootstrap):
  PAILLIER_COORDINATOR   "host:port" of process 0
  PAILLIER_NUM_PROCESSES number of participating host processes
  PAILLIER_PROCESS_ID    this host's rank in [0, num_processes)
"""

from __future__ import annotations

import os

_initialized = False


def launch_info_from_env() -> dict | None:
    """Read the multi-host launch contract from the environment.

    Returns kwargs for jax.distributed.initialize, or None when the
    environment describes a single-process run.
    """
    coord = os.environ.get("PAILLIER_COORDINATOR")
    nproc = os.environ.get("PAILLIER_NUM_PROCESSES")
    pid = os.environ.get("PAILLIER_PROCESS_ID")
    if not (coord and nproc and pid):
        return None
    if int(nproc) <= 1:
        return None
    return {
        "coordinator_address": coord,
        "num_processes": int(nproc),
        "process_id": int(pid),
    }


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> bool:
    """Join the multi-host cluster (idempotent).

    Explicit arguments win; otherwise the PAILLIER_* env contract is
    used.  Returns True when THIS call (or a previous one) activated a
    multi-host runtime, False otherwise.

    Contract note: when jax.distributed was initialized by someone else
    (not through this function) and the PAILLIER_* env vars are absent,
    this returns False without probing the backend — probing
    jax.process_count() here would initialize the backend and foreclose
    a later jax.distributed.initialize in single-process runs.  Callers
    that bootstrap JAX themselves should size their mesh from
    jax.process_count() directly instead of relying on this return.
    """
    global _initialized
    import jax

    if _initialized:
        return jax.process_count() > 1

    if coordinator_address is None:
        info = launch_info_from_env()
        if info is None:
            # No launch contract: single-process run.  (Calling
            # jax.distributed.initialize() with no arguments would wait
            # for a coordinator that does not exist.)  NOTE: do not touch
            # jax.process_count() before this decision — any backend
            # probe forecloses jax.distributed.initialize for good.
            return False
        coordinator_address = info["coordinator_address"]
        num_processes = info["num_processes"]
        process_id = info["process_id"]

    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)
    except RuntimeError:
        # Backend already initialized: either a prior initialize (fine —
        # report the live process count) or a too-late call (surface it).
        if jax.process_count() > 1:
            _initialized = True
            return True
        raise
    _initialized = True
    return True


def shutdown() -> None:
    global _initialized
    if _initialized:
        import jax
        jax.distributed.shutdown()
        _initialized = False


def process_info() -> tuple[int, int]:
    """(process_id, process_count) of the active runtime."""
    import jax
    return jax.process_index(), jax.process_count()
