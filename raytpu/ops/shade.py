"""Direct lighting + shadow shading (jnp / XLA path).

Vectorized re-design of DirectLight (`raytracer/Source/raytracer.cpp:265-327`)
over all pixels at once. The light bank is a statically-sized padded array
(:class:`raytpu.core.types.Lights`); the per-light python loop below unrolls
into the traced graph (light capacity drives cost — create Lights with a
small capacity for benchmarking).

Physics per light sample (`raytracer.cpp:294-304`):
  P = color * intensity / samples        (soft-shadow split, `:296`)
  A = 4 * pi * r^2                       (inverse-square falloff, `:295`)
  D = (P / A) * max(dot(r_hat, n_hat), 0)
with the shadow ray traced FROM the light toward the surface and occlusion
declared when something sits closer than 0.99 * r (`raytracer.cpp:307-315`).

Modes:
  * parity — reproduces the reference's accumulation run-on: ``result`` is
    never reset between lights, so light k is counted (L - k) times
    (`raytracer.cpp:269-322`). Exact for the default single light.
  * clean  — each light counted once.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from raytpu.core.types import Lights, RenderConfig, Scene
from raytpu.ops.intersect import intersect_scene


def shadow_sources(lights: Lights, cfg: RenderConfig) -> jax.Array:
    """All shadow-source positions, (capacity * samples, 3), in the
    (light-major, sample-minor) order direct_light's occlusion_rows and
    the soft shadow sweep use: the jittered positions with soft shadows
    (`raytracer.cpp:286`), the light positions otherwise (`:290`)."""
    n_s = cfg.soft_shadow_samples
    if n_s > 1:
        return lights.jitter[:, :n_s].reshape(-1, 3)
    return lights.position


def direct_light(
    hit_pos: jax.Array,
    hit_idx: jax.Array,
    scene: Scene,
    lights: Lights,
    cfg: RenderConfig,
    n_dir: jax.Array | None = None,
    occlusion_rows: jax.Array | None = None,
) -> jax.Array:
    """Direct-light irradiance term ("result2") per ray, before albedo.

    Args:
      hit_pos: (R, 3) surface positions.
      hit_idx: (R,) triangle indices (clamped to valid range by caller).

    Returns (R, 3). The caller composites per mode:
      parity: ``p * (direct * p + ambient)`` — albedo applied twice to the
              direct term (`raytracer.cpp:325-326` then `:584-588`).
      clean:  ``p * (direct + ambient)``.

    occlusion_rows: optional (capacity * samples, R) precomputed occlusion
      bits in (light-major, sample-minor) source order — the model-sharded
      path's merged shadow test (raytpu.parallel.render). Default traces
      the full scene.
    """
    samples = cfg.soft_shadow_samples
    if n_dir is None:
        # glm::normalize(triangle.normal) (`:300`); callers on the hot path
        # pass a one-hot-matmul gather instead (scatter-free backward).
        n_dir = scene.normals()[hit_idx]

    result = jnp.zeros_like(hit_pos)  # parity: never reset across lights
    result2 = jnp.zeros_like(hit_pos)

    for k in range(lights.capacity):
        mask_k = lights.mask[k]
        light_color = lights.color[k] * lights.intensity[k]
        P = light_color / jnp.float32(samples)  # (`:296`)
        light_sum = jnp.zeros_like(hit_pos)
        for s in range(samples):
            if samples > 1:
                position = lights.jitter[k, s]  # (`:286`)
            else:
                position = lights.position[k]  # (`:290`)

            delta = hit_pos - position[None, :]
            # r = 0 when a (fitted) light lands exactly on a surface point:
            # guard BOTH the sqrt input and the reciprocals — `where` after
            # the fact does NOT stop NaN cotangents (CLAUDE.md invariant).
            # Where r > 0 the guarded values are bit-identical to the
            # unguarded formulation (r*r round-trips through sqrt exactly
            # for the guarded-away case only).
            r2 = jnp.sum(delta * delta, axis=-1)
            lit = r2 > 0.0
            r = jnp.sqrt(jnp.where(lit, r2, 1.0))
            A = 4.0 * jnp.pi * (r * r)  # (`:295`)
            r_dir = -delta / r[:, None]  # normalize(position - pos) (`:298`)
            B = P[None, :] / A[:, None]
            lam = jnp.maximum(jnp.sum(r_dir * n_dir, axis=-1), 0.0)
            D = jnp.where(lit[:, None], B * lam[:, None], 0.0)

            # Shadow ray from the light toward the surface (`:307-315`).
            if occlusion_rows is not None:
                occluded = occlusion_rows[k * samples + s]
            else:
                # Trace with the UNNORMALIZED direction delta = pos - light:
                # the hit tests are scale-invariant in the direction and the
                # ray parameter becomes a fraction of the light distance, so
                # the reference's `distance < 0.99 * r` occlusion test
                # (`raytracer.cpp:310-315`) is simply t < 0.99 — no per-ray
                # normalization and a constant threshold.
                sh = intersect_scene(position, delta, scene,
                                     tri_chunk=cfg.tri_chunk)
                occluded = sh.hit & (sh.t < jnp.float32(0.99))
            D = jnp.where(occluded[:, None], 0.0, D)
            light_sum = light_sum + D

        if cfg.mode == "parity":
            result = result + mask_k * light_sum
            result2 = result2 + mask_k * result  # run-on accumulation (`:322`)
        else:
            result2 = result2 + mask_k * light_sum

    return result2


def irradiance_no_shadow(world: jax.Array, n_dir: jax.Array,
                         lights: Lights) -> jax.Array:
    """Per-point direct irradiance with NO occlusion test — the rasteriser's
    lighting model (`rasteriser.cpp:567-584`) and the per-hypothesis term of
    the soft renderers. world: (..., 3); n_dir: (..., 3). Returns (..., 3).
    """
    result = jnp.zeros_like(world)
    for k in range(lights.capacity):
        delta = world - lights.position[k]
        r2 = jnp.sum(delta * delta, axis=-1)
        # Guard r = 0 (light exactly on the shaded point): see direct_light.
        lit = r2 > 0.0
        r2s = jnp.where(lit, r2, 1.0)
        r = jnp.sqrt(r2s)
        A = 4.0 * jnp.pi * r2s
        light_color = lights.color[k] * lights.intensity[k]
        r_dir = -delta / r[..., None]
        lam = jnp.maximum(jnp.sum(r_dir * n_dir, axis=-1), 0.0)
        result = result + lights.mask[k] * jnp.where(
            lit[..., None], (light_color / A[..., None]) * lam[..., None],
            0.0,
        )
    return result


def composite(direct: jax.Array, albedo: jax.Array, hit: jax.Array,
              cfg: RenderConfig) -> jax.Array:
    """Final per-ray color (`raytracer.cpp:583-591`). Non-hits are black."""
    ambient = jnp.float32(cfg.ambient)
    if cfg.mode == "parity":
        # DirectLight already multiplied by p (`:325-326`); Draw multiplies
        # by p again (`:587-588`).
        color = albedo * (direct * albedo + ambient)
    else:
        color = albedo * (direct + ambient)
    return jnp.where(hit[:, None], color, 0.0)
