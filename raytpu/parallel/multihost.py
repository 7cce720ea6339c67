"""Multi-process runtime: jax.distributed init + global mesh construction.

The reference is a single shared-memory process; its only 'collective' is a
future-wait barrier (reference: source/Renderer.cpp:74-77).  The multi-device
equivalent is the JAX multi-controller runtime: every process runs this same
program, ``jax.distributed.initialize`` wires the cluster, and meshes span
all global devices (SURVEY.md §5.8).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None, process_id: Optional[int] = None):
    """Initialize the multi-host runtime (no-op for single process).

    Pass ``coordinator_address`` (e.g. ``localhost:<port>``),
    ``num_processes`` and ``process_id`` explicitly: nothing in the
    environment describes the cluster.
    """
    if num_processes is not None and num_processes <= 1:
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (ValueError, RuntimeError) as e:  # already initialized / single host
        if "already initialized" not in str(e):
            raise


def pod_mesh(prim: int = 1) -> Mesh:
    """Global (px, prim) mesh over all devices of all processes, in
    ``jax.devices()`` order: consecutive devices share a ``px`` row, so the
    ``prim`` all-gather of hit records stays within a process where it can.
    The cards of one host are joined all to all by NVLink, so within a host
    the layout follows the algorithm alone.
    """
    devs = np.asarray(jax.devices())
    n = len(devs)
    assert n % prim == 0, (n, prim)
    return Mesh(devs.reshape(n // prim, prim), axis_names=("px", "prim"))


def is_primary() -> bool:
    return jax.process_index() == 0


def local_device_count() -> int:
    return jax.local_device_count()
