"""Differentiable rendering: scene-parameter gradients end-to-end.

The BASELINE.json north star asks for a *differentiable* photon-splat +
volumetric march with gradients for volume sigma_a/sigma_s, BSDF
albedos, and light power. This module is the parameter plumbing:

- `DiffParams` names the differentiable leaves.
- `apply_params(scene, params)` substitutes them into the compiled
  scene tensors (a pure-pytree swap: every integrator already traces
  through the substituted arrays).
- `freeze_photon_shoot` / `diff_photon_ctx` make the photon pipeline
  differentiable: shooting runs once concretely to FREEZE the discrete
  structure (which paths deposited which photons where, and the
  sorted-grid layout), then re-traces with traced parameters and
  gathers photon weights at the frozen indices. Gradients flow from a
  kNN density estimate back through `PhotonMap.alpha_t` ->
  the deposit's path throughput -> light power / BSDF albedo / phase
  weights. Discrete events (Woodcock acceptance, RR survival,
  absorb-vs-scatter, lobe picks, the kNN neighbor sets) are detached —
  the standard differentiable-rendering treatment (SURVEY.md §7): the
  continuous factors carry the gradient.

Reference mapping: the reference renderer (core/photonshooter.cpp,
integrators/photonvolume.cpp:215) has no gradients at all; this is the
this build's extension, with the march recurrence differentiated by
`jax.grad` through the `lax.fori_loop`-as-scan march bodies.
"""
from __future__ import annotations

from dataclasses import replace as dc_replace
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from pbrt_tpu.core import spectrum as spec
from pbrt_tpu.photon.map import (
    MapStructure,
    build_photon_map_from,
    photon_map_structure,
)
from pbrt_tpu.photon.shooter import PhotonCtx, _shoot_batch_fn, compute_majorant
from pbrt_tpu.scene.compile import CompiledScene

S = spec.N_BINS


class DiffParams(NamedTuple):
    """Differentiable scene parameters (None = leave the scene's own).

    sigma_a / sigma_s: [V, S] volume coefficients (VolumeT rows).
    light_scale:       [L] per-light power scale (1.0 = as authored).
    kd_scale:          [M, S] per-material diffuse-albedo scale.
    """

    sigma_a: Optional[jnp.ndarray] = None
    sigma_s: Optional[jnp.ndarray] = None
    light_scale: Optional[jnp.ndarray] = None
    kd_scale: Optional[jnp.ndarray] = None


def default_params(scene: CompiledScene,
                   want=("sigma_a", "sigma_s", "light_scale", "kd_scale"),
                   ) -> DiffParams:
    """Identity-valued parameters matching the scene's shapes."""
    kw = {}
    if scene.volume is not None:
        if "sigma_a" in want:
            kw["sigma_a"] = jnp.asarray(scene.volume.sigma_a)
        if "sigma_s" in want:
            kw["sigma_s"] = jnp.asarray(scene.volume.sigma_s)
    if scene.lights is not None and "light_scale" in want:
        kw["light_scale"] = jnp.ones((scene.n_lights,), jnp.float32)
    if "kd_scale" in want:
        kw["kd_scale"] = jnp.ones((len(scene.materials), S), jnp.float32)
    return DiffParams(**kw)


def apply_params(scene: CompiledScene, params: DiffParams) -> CompiledScene:
    """Substitute differentiable parameters into the compiled scene.

    Pure array swaps — no recompilation of structure. Light scale
    multiplies the sampled radiance and the power table (the pick CDF
    `light_dist` stays frozen: it is a sampling distribution, so the
    estimator stays unbiased and the detachment is gradient-correct).
    Environment-map lights (scene.envs) are not scaled."""
    out = scene
    vol = scene.volume
    if vol is not None and (params.sigma_a is not None
                            or params.sigma_s is not None):
        vol = vol._replace(
            sigma_a=(vol.sigma_a if params.sigma_a is None
                     else jnp.broadcast_to(params.sigma_a, vol.sigma_a.shape)),
            sigma_s=(vol.sigma_s if params.sigma_s is None
                     else jnp.broadcast_to(params.sigma_s, vol.sigma_s.shape)),
        )
        out = dc_replace(out, volume=vol)
    if scene.lights is not None and params.light_scale is not None:
        ls = params.light_scale[:, None]
        out = dc_replace(out, lights=scene.lights._replace(
            spectra=scene.lights.spectra * ls,
            power=scene.lights.power * ls,
        ))
    if params.kd_scale is not None:
        out = dc_replace(out, kd_scale=params.kd_scale)
    return out


class FrozenShoot(NamedTuple):
    """Concrete record of one photon-shooting run: enough to re-trace
    the identical paths with traced parameters and rebuild the maps
    differentiably. Produced by freeze_photon_shoot."""

    n_batches: int
    B: int                 # lanes per batch
    seed: int
    max_depth: int
    has_volume: bool
    majorant: float        # static Woodcock majorant (detached control)
    # per class (caustic, indirect, volume, direct): flat indices into
    # the [n_batches*B*D] record arrays, concrete pos/wi, structure,
    # nshot normalizer; None where the class is empty
    classes: dict          # code -> (idx, pos, wi, MapStructure, nshot)
    cfg: dict              # n_used / max_dist2 / vol_* / depth knobs


_CLASS_CODES = {"caustic": 1, "indirect": 2, "direct": 3, "volume": 4}


def freeze_photon_shoot(scene: CompiledScene, n_paths: int,
                        vol_quota: int = 0, seed: int = 0,
                        max_depth: int = 5, n_used: int = 50,
                        max_dist: float = 0.1, vol_n_used: int = 30,
                        vol_max_dist: float = 0.1) -> FrozenShoot:
    """Shoot `n_paths` photon paths concretely and freeze the discrete
    outcome (fixed-shot differentiable analog of build_photon_maps;
    quotas are replaced by a fixed path count so the re-trace is a
    static program)."""
    has_volume = scene.volume is not None and vol_quota > 0
    majorant = compute_majorant(scene, has_volume)
    batch_fn = _shoot_batch_fn(scene, max_depth, has_volume,
                               sig_majorant=majorant)
    B = min(n_paths, 8192)
    n_batches = max(1, -(-n_paths // B))
    pos_l, al_l, wi_l, cls_l = [], [], [], []
    for bi in range(n_batches):
        lane = jnp.arange(B, dtype=jnp.int32)
        shot = jnp.full((B,), bi * B, jnp.int32)
        pos, al, wi, cls, *_ = batch_fn(lane, shot, seed)
        pos_l.append(np.asarray(pos).reshape(-1, 3))
        al_l.append(np.asarray(al).reshape(-1, S))
        wi_l.append(np.asarray(wi).reshape(-1, 3))
        cls_l.append(np.asarray(cls).reshape(-1))
    pos = np.concatenate(pos_l)
    al = np.concatenate(al_l)
    wi = np.concatenate(wi_l)
    cls = np.concatenate(cls_l)
    nz = al.sum(-1) > 0
    nshot = n_batches * B

    classes = {}
    for name, code in _CLASS_CODES.items():
        idx = np.nonzero(nz & (cls == code))[0]
        if len(idx) == 0:
            classes[code] = None
            continue
        cell = vol_max_dist if code == 4 else (
            max_dist if code == 1 else max_dist * 2.0)
        k = vol_n_used if code == 4 else n_used
        st = photon_map_structure(pos[idx], cell, target_k=k)
        classes[code] = (idx, pos[idx], wi[idx], st, nshot)

    return FrozenShoot(
        n_batches=n_batches, B=B, seed=seed, max_depth=max_depth,
        has_volume=has_volume, majorant=majorant, classes=classes,
        cfg=dict(n_used=n_used, max_dist2=max_dist * max_dist,
                 vol_n_used=vol_n_used,
                 vol_max_dist2=vol_max_dist * vol_max_dist),
    )


def diff_photon_ctx(scene_p: CompiledScene, frozen: FrozenShoot) -> PhotonCtx:
    """Re-trace the frozen shoot with (traced) scene parameters and
    assemble photon maps whose alphas carry gradients. scene_p must be
    `apply_params(scene, params)` of the SAME scene frozen against —
    the deterministic counter-hash RNG reproduces the identical paths,
    so the frozen indices select the same deposits."""
    batch_raw = _shoot_batch_fn(scene_p, frozen.max_depth,
                                frozen.has_volume,
                                sig_majorant=frozen.majorant, use_jit=False)
    als = []
    for bi in range(frozen.n_batches):
        lane = jnp.arange(frozen.B, dtype=jnp.int32)
        shot = jnp.full((frozen.B,), bi * frozen.B, jnp.int32)
        _, al, *_ = batch_raw(lane, shot, frozen.seed)
        als.append(al.reshape(-1, S))
    al_flat = jnp.concatenate(als) if len(als) > 1 else als[0]

    maps = {}
    for code, entry in frozen.classes.items():
        if entry is None:
            maps[code] = None
            continue
        idx, pos, wi, st, nshot = entry
        a = jnp.take(al_flat, jnp.asarray(idx), axis=0) / float(max(nshot, 1))
        maps[code] = build_photon_map_from(st, pos, a, wi)

    c = frozen.cfg
    return PhotonCtx(
        caustic=maps.get(1), indirect=maps.get(2), volume=maps.get(4),
        direct=maps.get(3), radiance=None,
        n_caustic_paths=frozen.n_batches * frozen.B,
        n_indirect_paths=frozen.n_batches * frozen.B,
        n_volume_paths=frozen.n_batches * frozen.B,
        n_used=c["n_used"], max_dist2=c["max_dist2"],
        vol_n_used=c["vol_n_used"], vol_max_dist2=c["vol_max_dist2"],
        final_gather=False, gather_samples=1, cos_gather_angle=0.9848,
        max_specular_depth=frozen.max_depth,
        max_photon_depth=frozen.max_depth,
    )
