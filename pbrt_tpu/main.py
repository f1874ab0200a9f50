"""CLI: python -m pbrt_tpu.main [options] <scene.pbrt ...>

Replaces reference main/pbrt.cpp:41-81: flag parsing, pbrtInit ->
ParseFile per scene -> pbrtCleanup. Flags keep the reference names
(--ncores is accepted for compatibility and maps to the number of
devices to shard over).
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pbrt_tpu")
    ap.add_argument("scenes", nargs="*", help=".pbrt scene files (default: stdin)")
    ap.add_argument("--ncores", type=int, default=0,
                    help="number of devices to shard over (0 = all)")
    ap.add_argument("--outfile", default="", help="output image path")
    ap.add_argument("--quick", action="store_true",
                    help="quarter resolution / reduced quotas for fast iteration")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default="",
                    help="film checkpoint file for crash-resumable renders")
    ap.add_argument("--tile-samples", type=int, default=0,
                    help="camera samples per wavefront tile (0 = auto: "
                         "64k, or 16k when a photon integrator is active); "
                         "lower this if the scene OOMs device memory")
    ap.add_argument("--distributed", action="store_true",
                    help="multi-host: call jax.distributed.initialize() "
                         "(coordinator/process env vars per JAX docs) so "
                         "jax.devices() spans the pod slice; tiles and "
                         "photon batches then shard across all hosts")
    args = ap.parse_args(argv)

    if args.distributed:
        # the actual jax.distributed.initialize() already ran inside
        # `import pbrt_tpu` (package __init__) — it must precede any
        # XLA-backend touch, and importing the package is one. The
        # coordinator/process identity comes from the cluster plugin's
        # autodetection or PBRT_COORDINATOR / PBRT_NUM_PROCESSES /
        # PBRT_PROCESS_ID. After it, jax.devices() is the global device
        # set and the single-process mesh code below is pod-wide SPMD.
        import pbrt_tpu

        if not pbrt_tpu._DISTRIBUTED:
            import jax

            jax.distributed.initialize()

    from pbrt_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    options = {
        "nCores": args.ncores,
        "imageFile": args.outfile,
        "quick": args.quick,
        "quiet": args.quiet,
        "verbose": args.verbose,
        "seed": args.seed,
        "checkpoint": args.checkpoint or None,
        "tile_samples": args.tile_samples,
    }

    from pbrt_tpu.core.error import PbrtError
    from pbrt_tpu.scene import api, parser

    api.pbrt_init(options)
    if not args.scenes:
        print("pbrt_tpu: reading scene from stdin is not supported; "
              "pass a scene file", file=sys.stderr)
        return 1
    for fn in args.scenes:
        try:
            parser.parse_file(fn)
        except FileNotFoundError:
            print(f"pbrt_tpu: couldn't open scene file \"{fn}\"", file=sys.stderr)
            return 1
        except PbrtError as e:
            print(f"pbrt_tpu: {fn}: {e}", file=sys.stderr)
            return 1
    api.pbrt_cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
