"""Batched ray-triangle intersection (jnp / XLA path).

Data-parallel reformulation of the reference's scalar Cramer's-rule loop
(`raytracer/Source/raytracer.cpp:202-257`). Key observation: for a bundle of
rays sharing one origin ``start`` (true for both reference ray types —
primary rays start at the camera `raytracer.cpp:580`, shadow rays start at
the light `raytracer.cpp:310`), every per-(ray, triangle) triple product in
the reference collapses to a dot of the ray *direction* with a per-triangle
constant vector:

  reference (`raytracer.cpp:225-237`)          raytpu constant (per triangle)
  ------------------------------------         ------------------------------
  e1e2d = dot(cross(e1,e2), -d)          =     d . ( -n ),    n  = e1 x e2
  be2d  = dot(cross(b, e2), -d)          =     d . (e2 x b),  b  = start - v0
  e1bd  = dot(cross(e1, b), -d)          =     d . (b x e1)
  e1e2b = dot(cross(e1,e2),  b)          =     n . b          (ray-independent)

so intersecting R rays against T triangles is ONE K=3 contraction
``dirs (R,3) . M^T (3,3T)`` plus elementwise math, with no (R, T, 3)
intermediates. Triangles stream through a `lax.scan` in chunks with a
running closest-hit reduction, which keeps memory at O(R * chunk).

The closest-hit metric is the Euclidean distance ``|start - pos| = t * |d|``
(`raytracer.cpp:241-242`); since ``|d|`` is constant per ray, reducing by t
gives the identical winner.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from raytpu.core.types import Scene

# Python float (see ops/raster.py note: module-level jnp constants
# would initialize the backend at import, breaking multi-host init).
_F32MAX = 3.4028235e38


class TriConstants(NamedTuple):
    """Per-(origin, triangle) intersection constants.

    m:  (T, 3, 3) rows [n, e2 x b, b x e1] — dotted with the ray direction to
        produce (denominator, u-numerator, v-numerator) * (-1, 1, 1).
    k0: (T,) n . b — the t numerator (`raytracer.cpp:231`).
    valid: (T,) float32 mask (scene.active).
    """

    m: jax.Array
    k0: jax.Array
    valid: jax.Array


def tri_constants(scene: Scene, start: jax.Array) -> TriConstants:
    """Precompute intersection constants for rays originating at ``start``."""
    e1, e2 = scene.edges()
    b = start[None, :] - scene.v0  # (T, 3)
    n = jnp.cross(e1, e2)
    m = jnp.stack([n, jnp.cross(e2, b), jnp.cross(b, e1)], axis=1)
    k0 = jnp.sum(n * b, axis=-1)
    return TriConstants(m=m, k0=k0, valid=scene.active)


class Hits(NamedTuple):
    """Closest-hit result per ray.

    t:    (R,) ray parameter of the closest hit (F32MAX when none).
    idx:  (R,) int32 triangle index (-1 when none).
    hit:  (R,) bool.
    """

    t: jax.Array
    idx: jax.Array
    hit: jax.Array


def _chunk_hits(dirs: jax.Array, m: jax.Array, k0: jax.Array,
                valid: jax.Array, base_index: jax.Array) -> tuple:
    """Closest hit of each ray within one triangle chunk.

    dirs (R, 3); m (C, 3, 3); k0 (C,); valid (C,). Returns (t, local_idx)
    with t = F32MAX where the chunk has no valid hit.
    """
    C = m.shape[0]
    # K=3 contraction as broadcast-FMA outer products: (R,1)x(1,C). Exact
    # f32 on every backend (no reduced-precision matmul unit is involved)
    # and XLA fuses it with the hit test and the argmin below.
    dn = (
        dirs[:, 0:1] * m[None, :, 0, 0] + dirs[:, 1:2] * m[None, :, 0, 1]
        + dirs[:, 2:3] * m[None, :, 0, 2]
    )
    du = (
        dirs[:, 0:1] * m[None, :, 1, 0] + dirs[:, 1:2] * m[None, :, 1, 1]
        + dirs[:, 2:3] * m[None, :, 1, 2]
    )
    dv = (
        dirs[:, 0:1] * m[None, :, 2, 0] + dirs[:, 1:2] * m[None, :, 2, 1]
        + dirs[:, 2:3] * m[None, :, 2, 2]
    )
    denom = -dn  # e1e2d (`raytracer.cpp:232`)
    # Grad-safe division: a zero denominator (ray parallel to the plane)
    # fails the hit test in the reference via inf/NaN comparisons; divide by
    # a safe value and mask explicitly so reverse-mode AD stays NaN-free.
    # One reciprocal + three multiplies (cheaper than three divides).
    nonpar = denom != 0.0
    denom_safe = jnp.where(nonpar, denom, 1.0)
    recip = 1.0 / denom_safe
    t = k0[None, :] * recip
    u = du * recip
    v = dv * recip
    # Inclusive bounds exactly as `raytracer.cpp:239`. NaNs (degenerate /
    # padded triangles) fail every comparison.
    ok = (u + v <= 1.0) & (u >= 0.0) & (v >= 0.0) & (t >= 0.0)
    ok &= nonpar & (valid[None, :] > 0.0)
    tm = jnp.where(ok, t, _F32MAX)
    # Reference tie-break is "last triangle wins" (`>=` update,
    # `raytracer.cpp:243`): argmin on the reversed axis.
    rev_arg = jnp.argmin(tm[:, ::-1], axis=-1)
    local = (C - 1) - rev_arg
    tbest = jnp.take_along_axis(tm, local[:, None], axis=-1)[:, 0]
    return tbest, base_index + local


def intersect(dirs: jax.Array, consts: TriConstants,
              tri_chunk: int = 512) -> Hits:
    """Closest intersection of R rays against all triangles.

    Streams triangles in chunks of ``tri_chunk`` via `lax.scan`, carrying a
    running (t, idx) minimum — O(R * chunk) live memory regardless of scene
    size (the 9k-triangle STL path needs this; the 32-triangle Cornell box
    takes the single-chunk fast path).
    """
    T = consts.m.shape[0]
    R = dirs.shape[0]

    if T <= tri_chunk:
        t, idx = _chunk_hits(
            dirs, consts.m, consts.k0, consts.valid, jnp.int32(0)
        )
        hit = t < _F32MAX
        return Hits(t=t, idx=jnp.where(hit, idx, -1).astype(jnp.int32),
                    hit=hit)

    if T % tri_chunk != 0:
        raise ValueError(
            f"triangle count {T} must be padded to a multiple of "
            f"tri_chunk={tri_chunk} (use Scene.pad_to)"
        )
    n_chunks = T // tri_chunk
    m_c = consts.m.reshape(n_chunks, tri_chunk, 3, 3)
    k0_c = consts.k0.reshape(n_chunks, tri_chunk)
    valid_c = consts.valid.reshape(n_chunks, tri_chunk)

    def body(carry, xs):
        best_t, best_idx = carry
        ci, m, k0, valid = xs
        t, idx = _chunk_hits(dirs, m, k0, valid, ci * tri_chunk)
        # Later chunks win ties (reference `>=` update semantics).
        upd = t <= best_t
        return (
            jnp.where(upd, t, best_t),
            jnp.where(upd, idx, best_idx),
        ), None

    init = (
        jnp.full((R,), _F32MAX, jnp.float32),
        jnp.zeros((R,), jnp.int32),
    )
    (best_t, best_idx), _ = jax.lax.scan(
        body, init, (jnp.arange(n_chunks, dtype=jnp.int32), m_c, k0_c, valid_c)
    )
    hit = best_t < _F32MAX
    return Hits(
        t=best_t,
        idx=jnp.where(hit, best_idx, -1).astype(jnp.int32),
        hit=hit,
    )


def intersect_scene(start: jax.Array, dirs: jax.Array, scene: Scene,
                    tri_chunk: int = 512) -> Hits:
    """Convenience wrapper: constants + intersect in one call."""
    return intersect(dirs, tri_constants(scene, start), tri_chunk=tri_chunk)


def one_hot_idx(idx: jax.Array, T: int) -> jax.Array:
    """(R,) indices -> (R, T) f32 one-hot (clamped; callers mask misses).

    Expressing a gather over a small table as one_hot @ table turns the
    backward pass into a matmul instead of a scatter-add. Use only for
    small T (memory is R*T).
    """
    safe = jnp.maximum(idx, 0)
    return (safe[:, None] == jnp.arange(T, dtype=idx.dtype)[None, :]).astype(
        jnp.float32
    )


def gather_rows(oh: jax.Array, table: jax.Array) -> jax.Array:
    """one_hot (R, T) @ table (T, C) -> (R, C) with matmul-fast backward."""
    return jax.lax.dot_general(
        oh, table,
        dimension_numbers=(((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )


def hit_positions(start: jax.Array, dirs: jax.Array, hits: Hits) -> jax.Array:
    """World positions of closest hits: start + t * d.

    (Reference computes ``v0 + u*e1 + v*e2``, `raytracer.cpp:241` — identical
    up to f32 rounding; this form needs no gather of triangle data.)
    """
    t = jnp.where(hits.hit, hits.t, 0.0)
    return start[None, :] + t[:, None] * dirs


def hit_distances(dirs: jax.Array, hits: Hits) -> jax.Array:
    """Euclidean hit distances ``t * |d|`` (`raytracer.cpp:242` semantics);
    F32MAX where no hit. The product is computed on a zeroed t so the
    unselected branch stays finite (NaN-free reverse-mode)."""
    norm = jnp.linalg.norm(dirs, axis=-1)
    t = jnp.where(hits.hit, hits.t, 0.0)
    return jnp.where(hits.hit, t * norm, _F32MAX)
