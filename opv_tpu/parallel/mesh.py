"""Device-mesh helpers.

The workload's parallel axes (SURVEY.md section 2, parallelism table):

* ``ch``   — channel parallelism: independent RF channels sharded like a
             batch axis (the reference's analog: one process per radio).
* ``time`` — time/sequence parallelism: contiguous IQ blocks of one long
             capture sharded across devices with overlap-save halos (the
             reference's analog: chunked streaming, serialized).

The mesh is a plain reshape of ``jax.devices()``: on a multi-GPU host
every card reaches every other at the same rate, so the axis order follows
the algorithm alone.  Collectives (`ppermute` halos, `psum` metrics) go
to the device links.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(axes: dict[str, int], devices=None) -> Mesh:
    """Create a mesh with named axes from the first prod(axes) devices."""
    devices = devices if devices is not None else jax.devices()
    shape = tuple(axes.values())
    n = int(np.prod(shape))
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    arr = np.array(devices[:n]).reshape(shape)
    return Mesh(arr, tuple(axes.keys()))


def channel_mesh(n_devices: int | None = None) -> Mesh:
    n = n_devices or len(jax.devices())
    return make_mesh({"ch": n})
