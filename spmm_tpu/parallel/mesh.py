"""Device mesh helpers.

Equivalent of the reference's (absent) multi-process runtime
(SURVEY.md §2.12): scaling is expressed as a ``jax.sharding.Mesh`` +
``shard_map`` with XLA collectives (NCCL on GPUs) — no custom transport.
"""

from __future__ import annotations

from typing import Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(
    shape: Sequence[int] | int | None = None,
    axis_names: Sequence[str] = ("rows",),
    *,
    devices=None,
) -> Mesh:
    """Build a mesh over the available devices.

    ``make_mesh()`` → 1-D mesh over all devices on axis "rows".
    ``make_mesh((r, c), ("rows", "cols"))`` → 2-D row×col mesh.
    """
    devices = devices if devices is not None else jax.devices()
    if shape is None:
        shape = (len(devices),)
    if isinstance(shape, int):
        shape = (shape,)
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh shape {shape} needs {n} devices, have {len(devices)}")
    axis_names = tuple(axis_names)[: len(shape)]
    if len(axis_names) != len(shape):
        raise ValueError(f"axis_names {axis_names} does not match mesh shape {shape}")
    dev_array = np.asarray(devices[:n]).reshape(shape)
    return Mesh(dev_array, axis_names)


def initialize_distributed(*, retries: int = 5, backoff_s: float = 2.0) -> None:
    """Multi-host bootstrap (no-op single-host): ``jax.distributed`` with
    retry — coordinator startup on a multi-host cluster is racy, and a transient
    connect failure should not kill the job (SURVEY.md §5 failure-detection
    note; this is the framework's only multi-host init surface)."""
    import os
    import time

    if jax.process_count() > 1:
        return  # already initialized by the launcher
    if "COORDINATOR_ADDRESS" not in os.environ:
        return  # single-host
    last = None
    for attempt in range(retries):
        try:
            jax.distributed.initialize()
            return
        except Exception as e:  # pragma: no cover - needs a real cluster
            last = e
            time.sleep(backoff_s * (2**attempt))
    raise RuntimeError(
        f"jax.distributed.initialize failed after {retries} attempts"
    ) from last
