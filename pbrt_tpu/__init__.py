"""pbrt_tpu — a physically based renderer in JAX (XLA/Pallas), run on GPUs.

A from-scratch re-design of the capabilities of piwell/CS348B-pbrt
(a pbrt-v2 fork with spectral dispersion, volumetric photon mapping,
a rainbow scattering volume, an AAC BVH builder and a realistic lens
camera) for accelerators driven by JAX:

- recursive CPU integrators  ->  wavefront `lax.scan` ray/photon batches
- pointer BVH / kd-trees     ->  flattened node arrays + vectorized and
                                 Pallas traversal kernels
- `KdTree<Photon>` kNN       ->  sorted spatial-hash grid + top-k
- pthread task pool          ->  `shard_map` over a `jax.sharding.Mesh`
- photon-merge mutex         ->  `all_gather` of per-device photon arrays
- film atomics               ->  deterministic segment-sum splatting

The .pbrt scene language, plugin names, parameter names and defaults of
the reference are preserved (see SURVEY.md section 2).
"""

__version__ = "0.1.0"

import os as _os
import sys as _sys

import jax as _jax

_DISTRIBUTED = False
# Multi-host init must happen BEFORE anything touches the XLA backend,
# and importing this package already does (the spectrum tables below
# are device constants). So the jax.distributed.initialize() for the
# CLI's --distributed flag lives here, keyed on the flag itself or the
# explicit PBRT_COORDINATOR env (see pbrt_tpu/main.py and
# tests/test_distributed.py).
if "--distributed" in _sys.argv or _os.environ.get("PBRT_COORDINATOR"):
    _kw = {}
    if _os.environ.get("PBRT_COORDINATOR"):
        _kw = dict(
            coordinator_address=_os.environ["PBRT_COORDINATOR"],
            num_processes=int(_os.environ["PBRT_NUM_PROCESSES"]),
            process_id=int(_os.environ["PBRT_PROCESS_ID"]),
        )
    _jax.distributed.initialize(**_kw)
    _DISTRIBUTED = True

# On the GPU, XLA runs float32 matmul/einsum/dot in TF32 by default
# (~10 mantissa bits); geometry is extremely sensitive to the lost bits
# (shadow-ray origins quantized that coarsely cause false self-shadow
# wedges). All jnp contractions in this package must be exact f32. The
# hot 3x3 transform applies are explicit mul/adds anyway
# (core/transform.py).
_jax.config.update("jax_default_matmul_precision", "highest")

from pbrt_tpu.core import spectrum  # noqa: F401
