"""Device-mesh parallelism: the replacement for the pthread pool.

The reference's only parallelism is a shared-memory task queue
(reference core/parallel.cpp:722-879, SURVEY.md section 2.4). The
device-mesh equivalents:

- pixel/ray tiles   -> batch axis sharded over a 1D "rays" mesh via
                       shard_map (the analog of SamplerRendererTask
                       fan-out, samplerrenderer.cpp:205-217)
- photon batches    -> shot sharded, maps all_gather-ed (the analog of
                       the photon-merge mutex, photonshooter.cpp:280)
- film accumulation -> per-device accumulators + psum (the analog of
                       the film's atomic float adds, image.cpp:130)
- gradients         -> psum over the mesh inside the backward pass

One mesh axis and no host round-trips inside the step; the mesh
assumes no topology (every card of a host reaches every other over
NVLink at the same rate).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


AXIS = "rays"


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (AXIS,))


def mesh_from_options(options: Optional[dict] = None) -> Optional[Mesh]:
    """The render/shoot mesh implied by CLI options: --ncores devices
    (0 = all). None on a single device — callers fall through to the
    unsharded path."""
    options = options or {}
    avail = len(jax.devices())
    n = int(options.get("nCores") or 0) or avail
    n = max(1, min(n, avail))
    return make_mesh(n) if n > 1 else None


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for the leading (ray/sample/photon) batch axis."""
    return NamedSharding(mesh, P(AXIS))


def shard_batch(mesh: Mesh, arr):
    """Shard the leading axis of a ray/sample batch over the mesh.

    `arr` is the FULL host array, identical on every process (the
    driver and shooter build batches deterministically); the callback
    form hands each process only its addressable shards, so this is
    the same call single-host and multi-host (jax.device_put of a host
    array onto a sharding with non-addressable devices would throw)."""
    sh = batch_sharding(mesh)
    arr = np.asarray(arr)
    return jax.make_array_from_callback(arr.shape, sh, lambda idx: arr[idx])


def replicate(mesh: Mesh, tree):
    sh = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(
        lambda a: jax.make_array_from_callback(
            np.shape(a), sh, lambda idx, a=a: np.asarray(a)[idx]), tree)


def gather_replicated(mesh: Mesh, tree):
    """Device-side merge of a batch-sharded pytree: jit with replicated
    out_shardings makes XLA insert the all_gather over NVLink — the
    multi-host-correct shape of the reference's photon-merge mutex
    (core/photonshooter.cpp:280-355). After this, every process holds
    the full arrays locally (addressable), so a host fetch is local."""
    rep = NamedSharding(mesh, P())
    return jax.jit(lambda t: t, out_shardings=rep)(tree)
