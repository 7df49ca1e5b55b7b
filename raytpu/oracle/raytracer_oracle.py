"""Numpy parity oracle for the reference raytracer.

Re-derives `raytracer/Source/raytracer.cpp` math bit-for-bit in float32,
vectorized over pixels but looping triangles in the reference's order so the
"closest" tie-breaking (`closestIntersection.distance >= distance`,
`raytracer.cpp:243`) matches exactly. This oracle is the regression anchor
for every JAX path — it is deliberately slow and simple.

Reproduced quirks (see SURVEY.md §3.1):
  * Double albedo on the direct term: DirectLight returns ``result2 * p``
    (`raytracer.cpp:325-326`) and Draw multiplies by ``p`` again
    (`raytracer.cpp:587-588`).
  * Multi-light accumulation run-on: ``result`` is never reset inside the
    light loop, so light k's contribution is counted (NUM_LIGHTS - k) times
    (`raytracer.cpp:269-322`).
  * Shadow rays traced FROM the light toward the surface with occlusion test
    ``j.distance < r * 0.99f`` (`raytracer.cpp:310-313`).
  * Closest-hit distance is Euclidean ``glm::distance(start, pos)`` — not the
    ray parameter t (`raytracer.cpp:241-242`).
  * The AA sub-ray offsets advance only on hit (`raytracer.cpp:593,596`) and
    the per-pixel intersection record persists across sub-rays, so a sub-ray
    can shade a stale (closer, earlier) hit (`raytracer.cpp:580-583`).
  * Un-drawn pixels stay black: CalculateDOF only writes x,y in
    [1, S-2] (`raytracer.cpp:618-620`), leaving a 1-px black border.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from functools import lru_cache

import numpy as np

F32MAX = np.float32(np.finfo(np.float32).max)


@lru_cache(maxsize=None)
def glibc_rand_sequence(n: int) -> tuple:
    """First n values of glibc ``rand()`` with the default seed (1).

    The reference never calls ``srand``, so its soft-shadow jitter
    (`raytracer.cpp:186-190`) is the fixed glibc sequence. We obtain it by
    calling libc directly (this runs on glibc Linux).
    """
    libc = ctypes.CDLL(ctypes.util.find_library("c"))
    libc.srand(1)
    return tuple(libc.rand() for _ in range(n))


def reference_random_numbers(n: int) -> np.ndarray:
    """RandomNumber() sequence: ((double)rand() / RAND_MAX) - 0.5f
    (`raytracer.cpp:260-263`). RAND_MAX = 2^31 - 1 on glibc."""
    seq = np.array(glibc_rand_sequence(n), dtype=np.float64)
    return (seq / 2147483647.0 - np.float64(np.float32(0.5))).astype(
        np.float32
    )


def reference_light_jitter(position: np.ndarray, samples: int = 16,
                           light_index: int = 0) -> np.ndarray:
    """randomPositions for one light (`raytracer.cpp:186-190`):
    ``pos + RandomNumber() * 0.08f`` per axis, consuming 3 rands per sample.

    light_index gives the offset into the global rand() stream (lights are
    added in order; light k consumes rands [3*16*k, 3*16*(k+1))).
    """
    start = 3 * samples * light_index
    r = reference_random_numbers(start + 3 * samples)[start:]
    r = r.reshape(samples, 3)
    return (position[None, :].astype(np.float32)
            + r * np.float32(0.08)).astype(np.float32)


def closest_intersection(start, dirs, v0, v1, v2):
    """Vectorized ClosestIntersection (`raytracer.cpp:202-257`).

    Args:
      start: (3,) float32 common ray origin (camera or light position).
      dirs:  (R, 3) float32 ray directions (not normalized).
      v0, v1, v2: (T, 3) float32 triangle vertices.

    Returns:
      (hit, dist, index, pos): (R,) bool, (R,) f32 Euclidean distance
      (F32MAX where no hit), (R,) int32 triangle index (-1 where no hit),
      (R, 3) f32 hit position.

    Follows the reference exactly: Cramer's-rule triple products
    (`raytracer.cpp:225-239`), inclusive barycentric bounds, distance =
    ``glm::distance(start, pos)`` (`:241-242`), and per-triangle update when
    ``best >= distance`` — so among equal distances the LAST triangle wins.
    """
    start = np.asarray(start, np.float32)
    dirs = np.asarray(dirs, np.float32)
    R = dirs.shape[0]
    neg_d = -dirs

    best_dist = np.full((R,), F32MAX, np.float32)
    best_idx = np.full((R,), -1, np.int32)
    best_pos = np.zeros((R, 3), np.float32)
    any_hit = np.zeros((R,), bool)

    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        for i in range(v0.shape[0]):
            e1 = v1[i] - v0[i]
            e2 = v2[i] - v0[i]
            b = start - v0[i]

            e1e2 = np.cross(e1, e2).astype(np.float32)
            be2 = np.cross(b, e2).astype(np.float32)
            e1b = np.cross(e1, b).astype(np.float32)

            e1e2b = np.float32(np.dot(e1e2, b))
            e1e2d = neg_d @ e1e2  # (R,)
            be2d = neg_d @ be2
            e1bd = neg_d @ e1b

            t = e1e2b / e1e2d
            u = be2d / e1e2d
            v = e1bd / e1e2d

            cond = (u + v <= 1.0) & (u >= 0.0) & (v >= 0.0) & (t >= 0.0)
            pos = v0[i] + u[:, None] * e1 + v[:, None] * e2
            delta = start - pos
            dist = np.sqrt(
                delta[:, 0] ** 2 + delta[:, 1] ** 2 + delta[:, 2] ** 2
            ).astype(np.float32)

            upd = cond & (best_dist >= dist)
            best_dist = np.where(upd, dist, best_dist)
            best_idx = np.where(upd, np.int32(i), best_idx)
            best_pos = np.where(upd[:, None], pos, best_pos)
            any_hit |= cond

    return any_hit, best_dist, best_idx, best_pos


def _normalize(v):
    n = np.sqrt(np.sum(v * v, axis=-1, keepdims=True)).astype(np.float32)
    return (v / n).astype(np.float32)


def direct_light(hit_pos, hit_idx, v0, v1, v2, colors, normals,
                 light_positions, light_colors, light_intensities,
                 soft_positions=None):
    """Vectorized DirectLight (`raytracer.cpp:265-327`) including the
    multi-light accumulation run-on bug (`:322`).

    Args:
      hit_pos: (R, 3) intersection positions; hit_idx: (R,) triangle index.
      light_positions/colors/intensities: (L, 3)/(L, 3)/(L,).
      soft_positions: optional (L, S, 3) jittered sample positions; when
        given, soft shadows are on with S samples (`raytracer.cpp:272-296`).

    Returns (R, 3): ``result2 * p`` — note this already includes one factor
    of the albedo ``p`` (`raytracer.cpp:325-326`).
    """
    R = hit_pos.shape[0]
    L = light_positions.shape[0]
    samples = 1 if soft_positions is None else soft_positions.shape[1]

    result = np.zeros((R, 3), np.float32)   # never reset across lights!
    result2 = np.zeros((R, 3), np.float32)

    n_dir = _normalize(normals[hit_idx])  # glm::normalize(normal) `:300`

    for k in range(L):
        light_color = (light_colors[k] * light_intensities[k]).astype(
            np.float32
        )
        for counter in range(samples):
            if samples != 1:
                position = soft_positions[k, counter]
            else:
                position = light_positions[k]

            delta = (hit_pos - position).astype(np.float32)
            r = np.sqrt(np.sum(delta * delta, axis=-1)).astype(np.float32)
            # `float A = 4*M_PI*(r*r)`: r*r in f32, * double 4pi, narrow to f32
            A = (4.0 * np.pi * (r * r).astype(np.float64)).astype(np.float32)
            P = (light_color / np.float32(samples)).astype(np.float32)
            r_dir = _normalize((position - hit_pos).astype(np.float32))
            B = P[None, :] / A[:, None]
            lam = np.maximum(np.sum(r_dir * n_dir, axis=-1), np.float32(0.0))
            D = (B * lam[:, None]).astype(np.float32)

            # Shadow: trace from the light toward the surface `:307-315`.
            sh_hit, sh_dist, _, _ = closest_intersection(
                position, -r_dir, v0, v1, v2
            )
            occluded = sh_hit & (sh_dist < r * np.float32(0.99))
            D = np.where(occluded[:, None], np.float32(0.0), D)
            result += D
        result2 += result

    p = colors[hit_idx]
    return (result2 * p).astype(np.float32)


def render(scene_arrays, width=500, height=500, focal=250.0,
           camera_pos=(0.0, 0.0, -2.0), yaw=0.0,
           light_positions=((0.0, -0.5, -0.7),),
           light_colors=((1.0, 1.0, 1.0),),
           light_intensities=(14.0,),
           aa_samples=1, soft_positions=None, ambient=0.2,
           dof_enabled=False, dof_kernel_size=8, dof_focus=1.3):
    """Full-frame oracle render (Draw + CalculateDOF,
    `raytracer.cpp:547-656`). Returns (image (H, W, 3) f32, focal_distances
    (H, W) f32).
    """
    v0, v1, v2, colors = scene_arrays
    e1 = v1 - v0
    e2 = v2 - v0
    normals = np.cross(e2, e1).astype(np.float32)  # `TestModel.h:26-31`
    normals = _normalize(normals)

    cam = np.asarray(camera_pos, np.float32)
    c, s = np.float32(np.cos(yaw)), np.float32(np.sin(yaw))
    rot = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], np.float32)

    lp = np.asarray(light_positions, np.float32)
    lc = np.asarray(light_colors, np.float32)
    li = np.asarray(light_intensities, np.float32)

    ys, xs = np.meshgrid(
        np.arange(height, dtype=np.float32),
        np.arange(width, dtype=np.float32),
        indexing="ij",
    )
    R = width * height

    n_sub = aa_samples if aa_samples > 1 else 1
    step = (
        np.float32(1.0) / np.float32(n_sub - 1) if n_sub > 1 else np.float32(0)
    )

    accum = np.zeros((R, 3), np.float32)
    # Per-pixel intersection record persists across sub-rays (`:580`).
    rec_dist = np.full((R,), F32MAX, np.float32)
    rec_idx = np.full((R,), -1, np.int32)
    rec_pos = np.zeros((R, 3), np.float32)

    for z in range(n_sub):
        for z2 in range(n_sub):
            if n_sub > 1:
                # Offsets assume every sub-ray hits (true for the enclosing
                # Cornell box; ref increments sit inside the hit branch
                # `:593,596`).
                x1 = xs - np.float32(0.5) + np.float32(z2) * step
                y1 = ys - np.float32(0.5) + np.float32(z) * step
            else:
                x1, y1 = xs, ys
            d = np.stack(
                [
                    x1 - np.float32(width) / np.float32(2.0),
                    y1 - np.float32(height) / np.float32(2.0),
                    np.full_like(x1, np.float32(focal)),
                ],
                axis=-1,
            ).reshape(R, 3)
            dirs = (d @ rot.T).astype(np.float32)  # cameraRot * d  `:580`

            hit, dist, idx, pos = closest_intersection(cam, dirs, v0, v1, v2)
            # Merge into the persistent record (update when record >= new).
            upd = hit & (rec_dist >= dist)
            rec_dist = np.where(upd, dist, rec_dist)
            rec_idx = np.where(upd, idx, rec_idx)
            rec_pos = np.where(upd[:, None], pos, rec_pos)

            shade_idx = np.maximum(rec_idx, 0)
            dl = direct_light(
                rec_pos, shade_idx, v0, v1, v2, colors, normals,
                lp, lc, li, soft_positions=soft_positions,
            )
            p = colors[shade_idx]
            contrib = p * (dl + np.float32(ambient))  # `:584-588`
            accum += np.where(hit[:, None], contrib, np.float32(0.0))

    img = (accum / np.float32(n_sub * n_sub)).reshape(height, width, 3)
    fd = np.where(
        rec_idx >= 0, rec_dist - np.float32(dof_focus), np.float32(0.0)
    ).reshape(height, width)

    out = dof_post(img, fd, dof_enabled, dof_kernel_size)
    return out, fd


def dof_post(img, focal_distances, dof_enabled, kernel_size=8):
    """CalculateDOF (`raytracer.cpp:608-656`): writes only pixels with
    x, y in [1, S-2] (black border), and when DoF is on applies the
    focal-distance-weighted box blur (`:626-639`)."""
    height, width, _ = img.shape
    out = np.zeros_like(img)
    if not dof_enabled:
        out[1 : height - 1, 1 : width - 1] = img[1 : height - 1, 1 : width - 1]
        return out

    total = np.float32(kernel_size * kernel_size)
    lo = int(np.ceil(kernel_size / -2.0))
    hi = int(np.ceil(kernel_size / 2.0))
    w_kern = np.minimum(np.abs(focal_distances), np.float32(1.0))
    w_center = np.float32(1.0) - w_kern * np.float32((total - 1) / total)
    w_other = w_kern * np.float32(1.0 / total)

    flat = img.reshape(-1, 3)
    n = flat.shape[0]
    for y in range(1, height - 1):
        for x in range(1, width - 1):
            acc = np.zeros(3, np.float32)
            for z in range(lo, hi):
                for z2 in range(lo, hi):
                    w = (
                        w_center[y, x]
                        if (z == 0 and z2 == 0)
                        else w_other[y, x]
                    )
                    # Reference indexes the flat array without bounds checks
                    # (`:637`); emulate flat wrap within the buffer, clamp
                    # truly out-of-range indices to zero contribution.
                    fi = (y + z) * height + (x + z2)
                    if 0 <= fi < n:
                        acc += flat[fi] * w
            out[y, x] = acc
    return out
