"""Multi-host initialization and mesh construction.

The reference is strictly single-process (SURVEY.md §2.4); this module is
the multi-process entry point of the framework: `initialize()` wires
jax.distributed, `make_mesh()` builds the device mesh
whose axes the rest of the framework shards over:

  * 'data'  — frame batch axis (extraction is embarrassingly parallel;
    inputs stream host-local, no collectives on the extraction path)
  * 'kf'    — keyframe axis for the SLAM backend (ba.ba_step /
    pose_graph_step reduce Schur blocks with psum/all_gather, which XLA
    hands to NCCL on GPUs)

Single-host multi-chip works with the same code (initialize() is then a
no-op); tests simulate hosts with xla_force_host_platform_device_count.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialize jax.distributed when running multi-process.

    No-ops when single-process and no coordinator is configured (so the
    same launcher script works from 1 host to N hosts). Arguments default
    to the env contract exported by parallel.launcher
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID); nothing
    else tells JAX of a cluster.
    """
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and env.get("JAX_NUM_PROCESSES"):
        num_processes = int(env["JAX_NUM_PROCESSES"])
    if process_id is None and env.get("JAX_PROCESS_ID"):
        process_id = int(env["JAX_PROCESS_ID"])
    if num_processes is None and coordinator_address is None:
        return
    # The CPU backend ships no cross-process collectives by default; gloo
    # backs them when simulating hosts with CPU devices. Harmless on GPUs
    # (the knob only affects the CPU client) and must be set before the
    # backend initializes.
    try:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:  # pragma: no cover - knob renamed/absent
        pass
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def make_mesh(axis: str = "data", devices=None) -> Mesh:
    """1-D mesh over all (global) devices — extraction data parallelism."""
    devices = np.array(jax.devices() if devices is None else devices)
    return Mesh(devices, axis_names=(axis,))


def make_slam_mesh(kf_parallel: int | None = None, devices=None) -> Mesh:
    """2-D mesh ('data', 'kf'): frames sharded over 'data', the SLAM
    backend's keyframe axis over 'kf'."""
    devices = np.array(jax.devices() if devices is None else devices)
    n = devices.size
    if kf_parallel is None:
        kf_parallel = 1
        while kf_parallel * 2 <= n and n % (kf_parallel * 2) == 0:
            kf_parallel *= 2
        kf_parallel = min(kf_parallel, n)
    if n % kf_parallel:
        raise ValueError(f"{n} devices not divisible by kf_parallel={kf_parallel}")
    return Mesh(devices.reshape(n // kf_parallel, kf_parallel), ("data", "kf"))


def local_batch_slice(global_batch: int, mesh: Mesh, axis: str = "data"):
    """(start, size) of this process's shard of the global frame batch."""
    n_shards = mesh.shape[axis]
    if global_batch % n_shards:
        raise ValueError(f"batch {global_batch} not divisible by {n_shards}")
    per = global_batch // n_shards
    idx = jax.process_index() % n_shards
    return idx * per, per
