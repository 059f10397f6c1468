"""Multi-host (multi-process) rendering.

The single-host mesh layer (``parallel/sharding.py``) already expresses the
render as shard_map programs over a ``(tile, sample)`` ``Mesh``; JAX's
multi-controller runtime extends the same programs across hosts — the mesh
simply spans all processes' devices, and XLA routes the collectives within
and between hosts.  Nothing in the render code changes;
this module only adds the process-level plumbing:

* :func:`initialize` — ``jax.distributed`` bring-up (coordinator + rank).
* :func:`make_global_mesh` — (tile, sample) mesh over ALL processes'
  devices.
* :func:`replicate_scene_global` / :func:`make_sharded_zeros` — build
  global arrays from per-host copies (every host loads the same scene
  file, so replication is just placement).
* :func:`gather_image` — all-gather a tile-sharded image to every host
  for display/saving.

Launch (one command per host / per process):

    python tools/multihost_render.py --coordinator HOST:PORT \
        --num-processes N --process-id I SCENE.txt

Tested end-to-end with 2 CPU processes (Gloo collectives) in
tests/test_multihost.py — the standard stand-in for a multi-host cluster.
The reference is strictly single-GPU (SURVEY.md §2 rows 26-27); this layer
is the framework's honest scale-out extension.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               local_device_ids: list[int] | None = None):
    """Bring up the multi-controller runtime (idempotent per process).

    ``local_device_ids``: the cards of this host that this process owns.
    When several processes share a host, give each its own cards — a JAX
    process reserves most of every card it opens."""
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def make_global_mesh(n_sample: int = 1) -> Mesh:
    """(tile, sample) mesh over every device of every process.  Device
    order interleaves hosts last, so tile shards are host-contiguous —
    neighbor traffic for display gathers crosses hosts once, not per row."""
    devices = np.asarray(jax.devices())
    n_tile = len(devices) // n_sample
    return Mesh(devices[: n_tile * n_sample].reshape(n_tile, n_sample),
                axis_names=("tile", "sample"))


def replicate_scene_global(mesh: Mesh, ds):
    """Place the (identical on every host) scene pytree replicated over the
    global mesh."""
    sharding = NamedSharding(mesh, P())

    def put(x):
        return jax.make_array_from_process_local_data(sharding, np.asarray(x))

    return jax.tree_util.tree_map(put, ds)


def make_sharded_zeros(mesh: Mesh, shape, dtype=jnp.float32):
    """A tile-sharded global zeros buffer (built inside jit so no host
    array ever needs to span processes)."""
    sharding = NamedSharding(mesh, P("tile"))
    return jax.jit(
        lambda: jnp.zeros(shape, dtype), out_shardings=sharding
    )()


def shard_state_global(mesh: Mesh, tree):
    """Tile-shard a pytree of per-host-identical [n_pad, ...] arrays."""
    sharding = NamedSharding(mesh, P("tile"))

    def put(x):
        return jax.make_array_from_process_local_data(sharding, np.asarray(x))

    return jax.tree_util.tree_map(put, tree)


def gather_image(img) -> np.ndarray:
    """All-gather a tile-sharded image so every host holds the full frame."""
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(
        img, tiled=True
    ))
