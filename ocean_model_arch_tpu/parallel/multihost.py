"""Multi-host setup.

Single-host meshes come from parallel/mesh.py. Across hosts,
jax.distributed wires the processes together and the same
Mesh/shard_map/ppermute code spans them: halo traffic between devices of
one host stays on the host's device links; host-boundary edges cross the
network — mirroring the reference's intra-node direct copies vs
inter-node MPI (syncborder_block2D_gen_all.fi:218-231 vs :100-129).

The sharding logic it feeds is validated on virtual device meshes
(tests/test_parallel.py, tests/test_fused_sharded.py), across CPU
processes (tests/test_multiprocess.py) and via
__graft_entry__.dryrun_multichip.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """jax.distributed.initialize. Pass all three arguments unless the
    cluster environment supplies them (a plain GPU host does not: give
    ``coordinator_address="localhost:<port>"``, the process count and
    this process's index)."""
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def pod_mesh(px: int, py: int) -> Mesh:
    """A px*py mesh over ALL devices of the slice (global across hosts).

    Lay the x axis along the major device order so that x-neighbour halo
    exchanges stay intra-host wherever possible and only the px-1
    shard seams that fall on host boundaries touch DCN."""
    devices = jax.devices()
    if len(devices) != px * py:
        raise ValueError(f"mesh {px}x{py} != {len(devices)} devices")
    return Mesh(np.array(devices).reshape(px, py), ("x", "y"))


def gather_to_host(arr) -> np.ndarray:
    """Fully replicate + fetch a sharded global array on every process
    (the analog of the reference's gather-to-master output path)."""
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(arr, tiled=True))
