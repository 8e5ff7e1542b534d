"""Multi-host execution utilities.

The reference has no distributed communication of any kind (SURVEY §2: no
NCCL/MPI/sockets — its only transport is GL buffer upload/readback).  This
module is the multi-host story the north star mandates, built on
``jax.distributed`` + GSPMD:

  * ``initialize`` — one barrier at process start (the only cross-host
    rendezvous); after it, ``jax.devices()`` spans every process and the
    1-D ray mesh from parallel.sharded covers every card, so gradient
    psums ride the collective library (NCCL on GPUs).
  * ``gather_image`` — the only cross-host data movement in the pipeline:
    assembling the row-sharded frame on host 0 at save time
    (multihost_utils.process_allgather), the analogue of the
    reference's glGetTexImage readback (render.cpp:474).

Single-process usage is zero-cost: every helper degrades to a no-op.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Initialize multi-host JAX (no-op when single-process).

    Arguments default to the standard JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID environment variables.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None:
        return  # single process
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes, process_id=process_id)


def is_primary() -> bool:
    return jax.process_index() == 0


def gather_image(image) -> np.ndarray:
    """Gather a row-sharded global image to every host -> np.ndarray.

    For single-process, just device_get.  For multi-host, allgather the
    addressable shards across hosts (save-time only — the hot loop never
    crosses hosts)."""
    if jax.process_count() == 1:
        return np.asarray(jax.device_get(image))
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(image, tiled=True))


def save_image_primary(path: str, image, gamma: float = 1.0) -> None:
    """Gather and write the image on host 0 only."""
    full = gather_image(image)
    if is_primary():
        from ..io.image import save_image

        save_image(path, full, gamma=gamma)
