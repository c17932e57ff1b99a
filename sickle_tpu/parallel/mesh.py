"""Device mesh + sharded trimming step.

Single-host multi-device: a 1-D ``data`` mesh; each device computes cuts
for its row-shard of the packed batch.  The kernel is row-local, so the
sharded program has zero collectives — XLA compiles one SPMD program and
the host assembles full outputs (tiny int32[B] arrays) for the writer.
The mesh follows the algorithm alone: rows split evenly over devices.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

from ..ops.trim import TrimParams

DATA_AXIS = "data"


def data_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` LOCAL devices.

    Local, not global: in a multi-host run every host streams its own
    input shard and shards batches only over its own chips; the only
    cross-host communication is the end-of-run counter reduction
    (parallel.dist), never row data.
    """
    devs = list(devices if devices is not None else jax.local_devices())
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (DATA_AXIS,))


def sharded_cuts_fn(params: TrimParams, mesh: Mesh,
                    slice_rows: Optional[int] = None,
                    inflight: Optional[int] = None):
    """The engine's device step (engine.pipeline._device_cuts_fn), row-
    sharded over ``mesh``: the same wire formats, sliced dispatch,
    deferred fetch and packed 4 B/read result as on one device.  Ragged
    batches pad rows to a mesh multiple (length-0 rows are discarded by
    the kernel); results are sliced back by the caller.
    """
    import os

    from ..engine.pipeline import _device_cuts_fn

    if slice_rows is None:
        slice_rows = int(os.environ.get("SICKLE_TPU_SLICE_ROWS", 1 << 16))
    if inflight is None:
        inflight = int(os.environ.get("SICKLE_TPU_INFLIGHT", 2))
    return _device_cuts_fn(params, slice_rows=slice_rows, inflight=inflight,
                           mesh=mesh)
