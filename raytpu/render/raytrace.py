"""Public raytrace API — pure, jittable.

Data-parallel re-design of the reference render loop Draw + CalculateDOF
(`raytracer/Source/raytracer.cpp:547-656`): the triple pixel x AA-sample x
triangle loop becomes a batched intersection (one matmul per triangle chunk,
see raytpu.ops.intersect) followed by vectorized shading and a windowed blur.

Modes (RenderConfig.mode):
  * 'parity' — matches the C++ output bit-for-bit up to f32 reassociation,
    including the reference quirks (double albedo, AA record persistence,
    black 1-px border; see module docstrings in raytpu.ops / raytpu.oracle).
  * 'clean'  — same features with the quirks fixed.
  * 'soft'   — differentiable relaxation (soft visibility), see
    raytpu.render.soft.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from raytpu.core.types import Camera, Lights, RenderConfig, Scene
from raytpu.ops.blur import dof_apply
from raytpu.ops.intersect import (
    gather_rows,
    hit_distances,
    hit_positions,
    intersect,
    one_hot_idx,
    tri_constants,
)
from raytpu.ops.shade import composite, direct_light

_F32MAX = 3.4028235e38  # Python float; see ops/raster.py note


class RenderOut(NamedTuple):
    image: jax.Array           # (H, W, 3) float32
    focal_distances: jax.Array  # (H, W) float32 (distance - dof_focus)


def pixel_grid(cfg: RenderConfig):
    """Integer pixel-center coordinates as float32 grids (H*W,)."""
    ys, xs = jnp.meshgrid(
        jnp.arange(cfg.height, dtype=jnp.float32),
        jnp.arange(cfg.width, dtype=jnp.float32),
        indexing="ij",
    )
    return xs.reshape(-1), ys.reshape(-1)


def camera_ray_dirs(xs, ys, camera: Camera, cfg: RenderConfig) -> jax.Array:
    """Pinhole ray directions ``cameraRot * (x - W/2, y - H/2, f)``
    (`raytracer.cpp:579-580`). (R, 3), unnormalized."""
    d = jnp.stack(
        [
            xs - jnp.float32(cfg.width) / 2.0,
            ys - jnp.float32(cfg.height) / 2.0,
            jnp.broadcast_to(camera.focal, xs.shape),
        ],
        axis=-1,
    )
    # HIGHEST: a reduced-precision f32 matmul (TF32 on GPUs) shifts ray
    # dirs ~1e-3.
    return jnp.matmul(d, camera.rotation().T,
                      precision=jax.lax.Precision.HIGHEST)


def _subpixel_offsets(cfg: RenderConfig):
    """AA sub-ray offsets: start at -0.5 and step 1/(N-1)
    (`raytracer.cpp:564-576,593,596`). Returns list of (dx, dy)."""
    n = cfg.aa_samples
    if n <= 1:
        return [(0.0, 0.0)]
    step = 1.0 / (n - 1)
    return [
        (-0.5 + z2 * step, -0.5 + z * step)
        for z in range(n)
        for z2 in range(n)
    ]


def raytrace_full(scene: Scene, camera: Camera, lights: Lights,
                  cfg: RenderConfig) -> RenderOut:
    """Render a full frame; returns image and DoF focal distances.

    Compacts the light bank at the host boundary (no-op under tracing) so
    cost scales with ACTIVE lights — a default capacity-32 bank with one
    light renders as cheaply as a capacity-1 bank.
    """
    return _raytrace_full(scene, camera, lights.compact(), cfg)


@partial(jax.jit, static_argnames=("cfg",))
def _raytrace_full(scene: Scene, camera: Camera, lights: Lights,
                   cfg: RenderConfig) -> RenderOut:
    xs, ys = pixel_grid(cfg)
    consts = tri_constants(scene, camera.pos)

    offsets = _subpixel_offsets(cfg)
    n_sub = len(offsets)  # total sub-rays = AA_SAMPLES^2 (`raytracer.cpp:599`)
    parity_record = cfg.mode == "parity" and n_sub > 1

    accum = jnp.zeros((xs.shape[0], 3), jnp.float32)
    # Closest Euclidean distance per pixel across sub-rays (the reference's
    # persistent intersection record, `raytracer.cpp:580`); feeds DoF.
    rec_dist = jnp.full(xs.shape, _F32MAX, jnp.float32)
    rec_idx = jnp.zeros(xs.shape, jnp.int32)
    rec_pos = jnp.zeros((xs.shape[0], 3), jnp.float32)
    for dx, dy in offsets:
        dirs = camera_ray_dirs(xs + dx, ys + dy, camera, cfg)
        hits = intersect(dirs, consts, tri_chunk=cfg.tri_chunk)
        dist = hit_distances(dirs, hits)

        # Merge into the running record (`>=` update semantics, `:243`).
        upd = hits.hit & (dist <= rec_dist)
        rec_dist = jnp.where(upd, dist, rec_dist)
        rec_idx = jnp.where(upd, hits.idx, rec_idx)
        rec_pos = jnp.where(
            upd[:, None], hit_positions(camera.pos, dirs, hits), rec_pos
        )
        if parity_record:
            # Parity quirk: each sub-ray shades the RECORD's hit, which may
            # be a stale closer hit from an earlier sub-ray.
            pos, shade_idx = rec_pos, rec_idx
        else:
            pos = hit_positions(camera.pos, dirs, hits)
            shade_idx = jnp.maximum(hits.idx, 0)

        T = scene.num_triangles
        if T <= 1024:
            # ONE (R, T) @ (T, 6) matmul for normals+albedo: the one-hot
            # buffer (R*T f32, 33 MB at 512^2/T=32) is read once instead
            # of twice, fwd and bwd — each output column is the same
            # independent K-dot, so results are bit-identical to two
            # separate gathers.
            oh = one_hot_idx(shade_idx, T)
            both = gather_rows(
                oh, jnp.concatenate([scene.normals(), scene.color], axis=1)
            )
            n_dir, albedo = both[:, :3], both[:, 3:]
        else:
            n_dir = None
            albedo = scene.color[shade_idx]
        direct = direct_light(pos, shade_idx, scene, lights, cfg,
                              n_dir=n_dir)
        color = composite(direct, albedo, hits.hit, cfg)
        # Reference adds a sample only when the sub-ray itself hit
        # (`raytracer.cpp:580-591`).
        accum = accum + color

    img = (accum / jnp.float32(n_sub)).reshape(cfg.height, cfg.width, 3)
    fd = jnp.where(
        rec_dist < _F32MAX, rec_dist - camera.dof_focus, 0.0
    ).reshape(cfg.height, cfg.width)
    out = dof_apply(img, fd, cfg)
    return RenderOut(image=out, focal_distances=fd)


def raytrace(scene: Scene, camera: Camera, lights: Lights,
             cfg: RenderConfig) -> jax.Array:
    """Render and return the (H, W, 3) float32 image."""
    if cfg.mode == "soft":
        from raytpu.render.soft import raytrace_soft

        return jax.jit(raytrace_soft, static_argnames=("cfg",))(
            scene, camera, lights.compact(), cfg
        )
    return raytrace_full(scene, camera, lights, cfg).image
