"""Multi-host execution glue.

Across hosts, channel shards never communicate while halo exchange and
psum stay among each host's own devices (mesh axes ordered so `time` is
innermost and host-local).  This module wraps the standard jax.distributed
bootstrap and builds the (host, ch, time) mesh; single-host callers get the
same API with host=1.

Verified single-host with N virtual devices (tests + dryrun_multichip);
multi-host paths follow the standard jax.distributed contract.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def initialize_multihost(coordinator: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None) -> None:
    """Bootstrap jax.distributed (no-op when unconfigured/single-host)."""
    if coordinator is None:
        return
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh(ch: int | None = None, time: int | None = None) -> Mesh:
    """Build a (ch, time) mesh over ALL processes' devices.

    Device order groups each host's local devices contiguously along `time`
    so halo ppermutes stay inside a host; `ch` spans hosts, where channel
    shards never communicate.
    """
    devs = jax.devices()
    n = len(devs)
    if ch is None and time is None:
        ch = jax.process_count() if jax.process_count() > 1 else 1
        time = n // max(ch, 1)
    elif ch is None:
        ch = n // time
    elif time is None:
        time = n // ch
    if ch * time != n:
        raise ValueError(f"mesh {ch}x{time} != {n} devices")
    arr = np.array(devs).reshape(ch, time)
    return Mesh(arr, ("ch", "time"))
