"""Differentiable ('soft') render paths.

The hard renderers already propagate gradients through every smooth
quantity — the winning triangle's ray parameter t, hit positions, shading,
light parameters, albedos (the argmin/argmax index is piecewise-constant,
so interior gradients are exact). What they cannot provide is the
*silhouette* gradient: moving a vertex so that a pixel's winner CHANGES is
invisible to autodiff through a hard select. The soft paths replace the
hard visibility decision with a smooth aggregation (soft-rasterizer-style)
so that losses see occlusion boundaries.

Relaxation:

  * hypotheses aggregate ATTRIBUTES (albedo, position/zinv, normal) and
    shading runs ONCE per pixel on the aggregated surface. Hard limit:
    aggregation converges to the winner's attributes, then shades
    exactly like 'clean'.
  * shadows are optical-depth: T = exp(-kappa * sum occ) (NeRF-style
    transmittance; kappa = _OD_SCALE) — one exp per RAY instead of a log
    per (ray, triangle) pair, and the od sum is shard-additive, which
    makes the model-parallel merge an add.
  * the raytracer's depth logit is METRIC (t * |d|): the raw ray
    parameter is in unnormalized-|d| units, which would make the
    effective depth sharpness ~|d| (~300x) weaker than the rasterizer's
    and FOV-dependent; behind-camera plane hits are hard-gated out of
    the aggregation.
  * coverage is the SIGMOID in additive log-space
    (zs-depth + log_sigmoid(es * edge) + log(valid)). A compact-support
    smoothstep alternative was tried: its zero tail destroys long-range
    silhouette attraction — an STL-scale vertex fit converged 19x with
    sigmoid coverage vs 1.3x with every compact band tried. The
    sigmoid's infinite tail is load-bearing for OPTIMIZATION, not just
    smoothing.

  raytrace_soft  — barycentric-margin coverage x softmin over t.
  rasterize_soft — screen-space signed-distance coverage x softmax over
                   zinv (background logit = 0, matching the reference's
                   cleared-to-0 depth buffer, `rasteriser.cpp:188`);
                   perspective-correct attributes.

Both converge to the 'clean' hard images as the sharpness parameters grow
(tests assert the hard limit). Temperatures live in RenderConfig
(soft_edge_sharpness, soft_z_sharpness).

Each renderer's triangle sweep is a streaming ("online") softmax over
triangle chunks whose partials (aggregate, running max, mass) are exposed
(raytrace_soft_partials, rasterize_soft_partials, soft_optical_depth) so
the model-sharded path (raytpu.parallel.render) runs the same math on its
triangle block and merges the partials across devices.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from raytpu.core.types import Camera, Lights, RenderConfig, Scene
from raytpu.ops.shade import irradiance_no_shadow, shadow_sources
from raytpu.render.raytrace import camera_ray_dirs, pixel_grid

_MM = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)

# Optical-depth scale for soft shadows: occluded (od >= 1) gives
# T = e^-16 ~ 1e-7 (exact-black in f32 image terms); fully open gives 1.
_OD_SCALE = 16.0

# The soft raytracer's depth logit is +zs * zinv with
# zinv = 1/max(metric dist, _T_NEAR) and a BACKGROUND LOGIT OF 0 —
# mirroring the rasterizer's cleared-to-0 z-buffer (`rasteriser.cpp:188`).
# Consequences:
#   * the hard limit is exact (argmax zinv == argmin dist for forward
#     hits; misses/behind-camera are hard-gated to zero weight);
#   * a hypothesis's logit is BOUNDED ABOVE by zs * zinv of its nearest
#     possible hit instead of unbounded relative to the background;
#   * one zs unit means "per unit of inverse metric distance", matching
#     the rasterizer's zinv semantics exactly.
_T_NEAR = 0.1

# Near-parallel gate: pairs with |d . n| below this relative threshold
# are gated to exactly zero weight. Two reasons:
#   * below ~1e-12 absolute, the MT denominator clamp destroys the
#     barycentric identities outright (computed u, v are the true ones
#     scaled toward 0, so the margin can read ~0 for a hit point that is
#     arbitrarily far from the triangle);
#   * between that and ~1e-3 relative, u and v are correct but carry
#     relative error ~ ulp(dot)/|denom| — up to ~10% near the bottom of
#     the range — and under the bounded logit (which does not
#     depth-suppress grazing hypotheses) an es-scaled margin noise of
#     that size makes pair weights differ by e^+-few between two
#     evaluations of the same formula that contract FMAs differently
#     (e.g. the CPU and the GPU backend).
# At 1e-3 the gate drops incidence angles within ~0.06 deg of exactly
# edge-on (where a hypothesis is a sliver the rasterizer's area_ok test
# would likewise drop) and everything kept is accurate to ~0.1%.
_DENOM_EPS = 1e-3

def shade_agg_raytrace(alb, pos, nrm, lights: Lights, ambient: float,
                       shadow) -> jax.Array:
    """Shade the aggregated raytrace surface: one irradiance evaluation
    per ray at the softly-aggregated (position, normal), scaled by the
    shadow transmittance; albedo and ambient as in 'clean' compositing.
    alb/pos/nrm: (..., 3); shadow: (...,). Returns (..., 3)."""
    irr = irradiance_no_shadow(pos, nrm, lights)
    return alb * (irr * shadow[..., None] + jnp.float32(ambient))


def shade_agg_raster(alb, ppx, zpx, nrm, camera: Camera, lights: Lights,
                     ambient: float) -> jax.Array:
    """Shade the aggregated raster surface: reconstruct the world point
    from aggregated (pos3d-numerator, zinv) — hard limit: the winner's
    exact `rasteriser.cpp:557` reconstruction — and shade once per
    pixel. alb/ppx/nrm: (..., 3); zpx: (...,). Returns (..., 3)."""
    from raytpu.ops.raster import glm_inverse3

    inv_rot = glm_inverse3(camera.rotation())
    # Visibility gate, not an epsilon: background-dominated pixels have
    # agg zinv ~ w * zinv with w -> 0, and a 1e-12-style guard would
    # amplify their COTANGENTS by 1/zsafe^2 ~ 1e24 even though the
    # forward is masked by the near-zero albedo (grad-safety invariant:
    # `where` after the fact does not stop junk cotangents). Gate the
    # division itself: sub-threshold pixels shade at a benign point
    # (z = 1 keeps ppx/zsafe tiny) with bounded gradients; real surfaces
    # have zinv >> 1e-6, so the hard limit is untouched.
    vis = zpx > 1e-6
    zsafe = jnp.where(vis, zpx, 1.0)
    world = _MM(ppx / zsafe[..., None], inv_rot) + camera.pos
    irr = irradiance_no_shadow(world, nrm, lights)
    return alb * (irr + jnp.float32(ambient))


# ---------------------------------------------------------------------------
# Soft raytracer
# ---------------------------------------------------------------------------

def _ray_tri_tuv(dirs: jax.Array, v0, v1, v2, start: jax.Array):
    """Per-(ray, triangle) t, u, v via the matmul formulation
    (see raytpu.ops.intersect). dirs (R, 3), v0/v1/v2 (C, 3) ->
    t/u/v/denom (R, C) plus nmag (C,) = |cross(e1, e2)| for the
    near-parallel gate (_DENOM_EPS)."""
    e1 = v1 - v0
    e2 = v2 - v0
    b = start[None, :] - v0
    n = jnp.cross(e1, e2)
    m = jnp.stack([n, jnp.cross(e2, b), jnp.cross(b, e1)], axis=1)
    k0 = jnp.sum(n * b, axis=-1)
    n2 = jnp.sum(n * n, axis=-1)
    nmag = jnp.sqrt(jnp.where(n2 > 0.0, n2, 1.0))
    nmag = jnp.where(n2 > 0.0, nmag, 0.0)
    C = m.shape[0]
    prods = _MM(dirs, m.reshape(3 * C, 3).T).reshape(-1, C, 3)
    denom = -prods[..., 0]
    safe = jnp.where(jnp.abs(denom) > 1e-12, denom, 1e-12)
    t = k0[None, :] / safe
    u = prods[..., 1] / safe
    v = prods[..., 2] / safe
    return t, u, v, denom, nmag


def _chunked_scene(scene: Scene, chunk: int):
    """Pad + reshape scene arrays to (n_chunks, chunk, ...) for lax.scan."""
    T = scene.num_triangles
    chunk = min(max(T, 1), max(chunk, 1))
    # T == 0: run one all-inactive chunk so the scan still produces the
    # background hypothesis (chunk=0 would divide by zero here).
    padn = chunk if T == 0 else (-T) % chunk
    arrays = dict(v0=scene.v0, v1=scene.v1, v2=scene.v2,
                  color=scene.color, active=scene.active,
                  normal=scene.normals())
    if padn:
        for k, a in arrays.items():
            pad = jnp.zeros((padn,) + a.shape[1:], a.dtype)
            arrays[k] = jnp.concatenate([a, pad], axis=0)
    n_chunks = (T + padn) // chunk
    return {
        k: a.reshape((n_chunks, chunk) + a.shape[1:])
        for k, a in arrays.items()
    }


def raytrace_soft(scene: Scene, camera: Camera, lights: Lights,
                  cfg: RenderConfig) -> jax.Array:
    """Differentiable raytrace; returns (H, W, 3).

    Relaxation (module docstring, _T_NEAR note): logit =
    z_sharpness * zinv + log_sigmoid(edge_sharpness * margin) +
    log(active), margin = min(u, v, 1-u-v), and zinv =
    1/max(t|d|, dmin_tri, _T_NEAR) — the metric ray-plane-hit depth
    through a BOUNDED inverse transform, floored per triangle by
    dmin_tri = max(|o - centroid| - r_tri, 0) (a lower bound on the
    distance from the origin to any triangle point). True hits satisfy
    t|d| >= dmin_tri, so the hard limit is exact; plane-extension
    pseudo-hits (a plane passing near the camera) are capped by the
    triangle's REAL proximity instead of carrying a zs/_T_NEAR-scale
    logit no margin could suppress. Hypotheses aggregate (albedo,
    ray-hit position, normal) and shading runs once per ray on the
    aggregate. The background hypothesis sits at
    logit 0 (zinv -> 0: black at infinity — the raytrace analog of the
    rasterizer's cleared-to-0 depth buffer, `rasteriser.cpp:188`);
    behind-camera and near-parallel (_DENOM_EPS) plane hits are
    hard-gated to zero weight.

    Shadows: optical-depth transmittance T = exp(-kappa * sum occ) at
    the aggregated hit position, averaged over the light's jittered
    soft-shadow samples when cfg.soft_shadow_samples > 1
    (`raytracer.cpp:272-296`). One shadow sweep per light sample, not per
    hypothesis (documented approximation; exact in the hard limit).
    """
    xs, ys = pixel_grid(cfg)
    dirs = camera_ray_dirs(xs, ys, camera, cfg)
    agg, _, _ = raytrace_soft_partials(dirs, camera.pos, scene, cfg)
    alb, agg_pos, agg_nrm = agg[:, 0:3], agg[:, 3:6], agg[:, 6:9]

    # Optical-depth shadow at the aggregated position; scales the direct
    # term only (`raytracer.cpp:314` zeroes only D).
    shadow = _soft_shadow_factor(agg_pos, scene, lights, cfg)
    img = shade_agg_raytrace(alb, agg_pos, agg_nrm, lights, cfg.ambient,
                             shadow)
    return img.reshape(cfg.height, cfg.width, 3)


def raytrace_soft_partials(dirs: jax.Array, origin: jax.Array,
                           scene: Scene, cfg: RenderConfig):
    """Streaming softmin-over-depth of rays ``origin + t * dirs`` against
    ``scene``'s triangles plus the background hypothesis (logit 0, zero
    attributes).

    dirs: (R, 3). Returns the online-softmax partials (agg, m, s):
    agg (R, 9) the normalized (albedo, hit position, normal) aggregate,
    m (R,) the running max logit and s (R,) the softmax mass relative to
    exp(m). A model-sharded caller runs this on its triangle block and
    merges the partials (parallel.render._soft_combine).
    """
    R = dirs.shape[0]
    zs = jnp.float32(cfg.soft_z_sharpness)
    es = jnp.float32(cfg.soft_edge_sharpness)
    chunks = _chunked_scene(scene, cfg.raster_tri_chunk)

    # Metric depth: the ray parameter t is in UNNORMALIZED-direction
    # units (|d| ~ focal px), so a logit on raw t would make the
    # effective depth sharpness |d|-dependent (~300x weaker than the
    # rasterizer's zinv logit, and varying across the FOV). Scale by the
    # per-ray |d| so zs means "per scene unit" everywhere.
    dnorm = jnp.linalg.norm(dirs, axis=-1)

    def body(carry, ch):
        m, s, acc = carry
        t, u, v, denom, nmag = _ray_tri_tuv(
            dirs, ch["v0"], ch["v1"], ch["v2"], origin)
        margin = jnp.minimum(jnp.minimum(u, v), 1.0 - u - v)
        # Hard-gate behind-camera / near-parallel plane hits (exactly
        # zero weight; clamp artifacts otherwise ghost — see _DENOM_EPS).
        fwd_ok = (t > 1e-6) & (
            jnp.abs(denom)
            > _DENOM_EPS * dnorm[:, None] * nmag[None, :]
        )
        # Bounded inverse depth from the ray-plane hit: zinv =
        # 1/max(t|d|, dmin_tri, _T_NEAR). For TRUE hits the hit point is
        # on the triangle, so t|d| >= dist(origin, triangle) >= dmin_tri
        # and the clamp is inactive — the hard limit is exact. For
        # plane-EXTENSION pseudo-hits (a plane passing near the camera
        # hits at tiny t) the per-triangle floor dmin_tri =
        # max(|o - centroid| - r_tri, 0) caps the depth logit by the
        # triangle's REAL proximity, so no margin-suppressible
        # hypothesis can carry a zs/_T_NEAR-scale logit (hijack).
        cen = (ch["v0"] + ch["v1"] + ch["v2"]) / 3.0
        r2t = jnp.maximum(
            jnp.maximum(jnp.sum((ch["v0"] - cen) ** 2, axis=-1),
                        jnp.sum((ch["v1"] - cen) ** 2, axis=-1)),
            jnp.sum((ch["v2"] - cen) ** 2, axis=-1))
        oc = jnp.linalg.norm(cen - origin[None, :], axis=-1)
        dmin = jnp.maximum(oc - jnp.sqrt(r2t + 1e-20), 0.0)
        dist = t * dnorm[:, None]
        zinv = 1.0 / jnp.maximum(
            jnp.maximum(dist, dmin[None, :]), jnp.float32(_T_NEAR))
        logit = (
            zs * jnp.where(fwd_ok, zinv, 0.0)
            + jax.nn.log_sigmoid(es * margin)
            + jnp.log(ch["active"][None, :] + 1e-20)
        )
        logit = jnp.where(fwd_ok, logit, -1e30)

        tp = jnp.where(fwd_ok & (t < 3e38), t, 0.0)
        pos = origin[None, None, :] + tp[..., None] * dirs[:, None, :]
        alb = jnp.broadcast_to(ch["color"][None, :, :], pos.shape)
        nrm = jnp.broadcast_to(ch["normal"][None, :, :], pos.shape)
        num = jnp.concatenate([alb, pos, nrm], axis=-1)  # (R, C, 9)
        return _online_softmax_step(m, s, acc, logit, num), None

    # Background hypothesis at logit 0 (black at infinity).
    dt = dirs.dtype
    init = (
        jnp.zeros((R,), dt),
        jnp.ones((R,), dt),
        jnp.zeros((R, 9), dt),
    )
    (m, s, acc), _ = jax.lax.scan(body, init, chunks)
    return acc / s[:, None], m, s


def _online_softmax_step(m, s, acc, logit, num):
    """Fold one chunk of hypotheses into the running softmax partials.

    m, s: (R,); acc: (R, K); logit: (R, C); num: (R, C, K). The weighted
    attribute sum is a contraction over C, pinned to full f32 precision
    (a reduced-precision matmul would round the attributes to ~1e-3)."""
    m_new = jnp.maximum(m, jnp.max(logit, axis=1))
    scale = jnp.exp(m - m_new)
    w = jnp.exp(logit - m_new[:, None])
    s_new = s * scale + jnp.sum(w, axis=1)
    acc_new = acc * scale[:, None] + jnp.einsum(
        "rc,rcd->rd", w, num, precision=jax.lax.Precision.HIGHEST)
    return m_new, s_new, acc_new


def _soft_shadow_factor(world: jax.Array, scene: Scene, lights: Lights,
                        cfg: RenderConfig) -> jax.Array:
    """Smooth visibility of each (R, 3) point toward the lights over the
    whole scene: the optical-depth sweep followed by the transmittance
    average. Returns (R,)."""
    od = soft_optical_depth(world, scene, shadow_sources(lights, cfg), cfg)
    return shadow_transmittance(od, lights, cfg)


def soft_optical_depth(world: jax.Array, scene: Scene, sources: jax.Array,
                       cfg: RenderConfig) -> jax.Array:
    """Optical depth toward each shadow source over ``scene``'s triangles.

    Relaxation of `raytracer.cpp:307-315` (occluded when an intersection
    from the light toward the point is closer than 0.99 r): od = sum over
    triangles of sigmoid(es * margin) * sigmoid(zs * (0.99 r - t)). od is
    a plain SUM, so the chunk combine and the model-shard combine
    (parallel/render.py) are adds. Hard limit: any real occluder gives
    od >= 1 => T <= e^-16 ~ 0 (shadow_transmittance).

    world: (R, 3); sources: (S, 3) (ops.shade.shadow_sources). Returns
    (S, R).

    Saturation regime (measured): at very soft settings the SUM's
    sigmoid tails dominate — with ~32 triangles at es <= ~10 every
    non-occluding triangle contributes sigmoid(es * margin) ~ 0.1-0.3,
    od >> 1 everywhere, and T = exp(-16 * od) underflows to exactly 0,
    killing the direct term AND its light-parameter gradients. Anneal
    the raytrace soft path from moderate sharpness (>= ~50), or train
    through the rasterize path (no shadow term) at softer settings, as
    bench/fit_reference.py does.
    """
    chunks = _chunked_scene(scene, cfg.raster_tri_chunk)
    es = jnp.float32(cfg.soft_edge_sharpness)
    zs = jnp.float32(cfg.soft_z_sharpness)

    rows = []
    for si in range(sources.shape[0]):
        position = sources[si]
        delta = world - position
        # Guard r = 0 (light on the aggregated surface point) — the
        # sqrt AND the reciprocal both need it for finite grads.
        r2 = jnp.sum(delta * delta, axis=-1)
        r = jnp.sqrt(jnp.where(r2 > 0.0, r2, 1.0))
        d_hat = delta / r[..., None]

        def body(od, ch, position=position, r=r, d_hat=d_hat):
            t, u, v, denom, nmag = _ray_tri_tuv(
                d_hat, ch["v0"], ch["v1"], ch["v2"], position
            )
            margin = jnp.minimum(jnp.minimum(u, v), 1.0 - u - v)
            cov = jax.nn.sigmoid(es * margin) * ch["active"][None, :]
            # d_hat is unit, so the near-parallel gate (_DENOM_EPS)
            # is relative to |n| alone.
            ok = (t > 1e-6) & (
                jnp.abs(denom) > _DENOM_EPS * nmag[None, :]
            )
            occ_z = jnp.where(
                ok, jax.nn.sigmoid(zs * (0.99 * r[:, None] - t)), 0.0,
            )
            return od + jnp.sum(cov * occ_z, axis=1), None

        od, _ = jax.lax.scan(
            body, jnp.zeros(world.shape[0], world.dtype), chunks
        )
        rows.append(od)
    return jnp.stack(rows)


def shadow_transmittance(od: jax.Array, lights: Lights,
                         cfg: RenderConfig) -> jax.Array:
    """Shadow factor per ray from the (S, R) optical depths: T =
    exp(-kappa * od) per source, averaged over each light's samples and
    then over the active lights (by light mask). Returns (R,)."""
    samples = max(cfg.soft_shadow_samples, 1)
    trans = jnp.exp(-jnp.float32(_OD_SCALE) * od)
    per_light = jnp.mean(trans.reshape(lights.capacity, samples, -1), axis=1)
    denom = jnp.maximum(jnp.sum(lights.mask), 1.0)
    return jnp.sum(lights.mask[:, None] * per_light, axis=0) / denom


# ---------------------------------------------------------------------------
# Soft rasterizer
# ---------------------------------------------------------------------------

def _screen_vertices(scene: Scene, camera: Camera, cfg: RenderConfig):
    """Float screen coords (no truncation) + zinv + pos3d per vertex."""
    rot = camera.rotation()
    verts = jnp.stack([scene.v0, scene.v1, scene.v2], axis=1)
    pos = _MM(verts - camera.pos, rot)
    z = pos[..., 2]
    zinv = 1.0 / z
    sx = camera.focal * pos[..., 0] * zinv + cfg.width / 2.0
    sy = camera.focal * pos[..., 1] * zinv + cfg.height / 2.0
    pos3d = pos * zinv[..., None]
    return sx, sy, zinv, pos3d


def _pixel_centers(cfg: RenderConfig) -> jax.Array:
    H, W = cfg.height, cfg.width
    ys, xs = jnp.meshgrid(
        jnp.arange(H, dtype=jnp.float32), jnp.arange(W, dtype=jnp.float32),
        indexing="ij",
    )
    return jnp.stack([xs.reshape(-1), ys.reshape(-1)], axis=-1)  # (R, 2)


def _raster_fields(scene: Scene, camera: Camera, cfg: RenderConfig):
    """Per-(pixel, triangle) fields over ALL triangles (exact jnp path)."""
    sx, sy, zinv, pos3d = _screen_vertices(scene, camera, cfg)
    return _fields_for(_pixel_centers(cfg), sx, sy, zinv, pos3d)[:3]


def _fields_for(p, sx, sy, zinv, pos3d):
    """Per-(pixel, triangle) fields for a triangle SLICE:
    signed distance (px, inside-positive), interpolated zinv, pos3d, and
    an area-validity mask. p: (R, 2); sx/sy/zinv: (C, 3); pos3d: (C,3,3).

    area_ok masks near-degenerate SCREEN-SPACE triangles (edge-on
    surfaces, zero-area padding): their three near-parallel edges yield
    sdist ~ 0 along an entire line, which would otherwise light up a
    band of pixels (catastrophic on dense meshes).
    """
    ax, ay = sx[:, 0], sy[:, 0]
    bx, by = sx[:, 1], sy[:, 1]
    cx, cy = sx[:, 2], sy[:, 2]

    # Twice-signed-area; orientation normalizes inside to positive.
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)  # (C,)
    area_ok = jnp.abs(area) > 1e-4  # px^2; sub-hundredth-pixel triangles
    orient = jnp.sign(jnp.where(jnp.abs(area) > 1e-12, area, 1e-12))

    def edge_vals(x0, y0, x1, y1):
        # E(p) = (x1-x0)(py-y0) - (y1-y0)(px-x0): (R, T)
        ex = x1 - x0
        ey = y1 - y0
        val = ex[None, :] * (p[:, 1:2] - y0[None, :]) - ey[None, :] * (
            p[:, 0:1] - x0[None, :]
        )
        # Degenerate edges (zero-padded triangles) have n2 = 0: sqrt'(0)
        # is inf and val == 0 there, so the unguarded form NaNs vertex
        # AND camera grads (0 * inf). val == 0 whenever n2 == 0, so the
        # guard leaves every forward value unchanged.
        n2 = ex * ex + ey * ey
        norm = jnp.sqrt(jnp.where(n2 > 0.0, n2, 1.0)) + 1e-12
        return val * orient[None, :] / norm[None, :]

    d0 = edge_vals(ax, ay, bx, by)
    d1 = edge_vals(bx, by, cx, cy)
    d2 = edge_vals(cx, cy, ax, ay)
    hp_min = jnp.minimum(jnp.minimum(d0, d1), d2)  # half-plane min

    # True signed distance: the half-plane minimum is only valid INSIDE.
    # Outside, in the cone regions beyond a vertex, a pixel can be near an
    # edge's LINE extension while far from the triangle — with thousands
    # of small triangles that covers the whole screen and leaks coverage.
    # Use the exact distance to the nearest edge SEGMENT when outside.
    def seg_dist(x0, y0, x1, y1):
        ex = (x1 - x0)[None, :]
        ey = (y1 - y0)[None, :]
        len2 = ex * ex + ey * ey + 1e-12
        tpar = jnp.clip(
            ((p[:, 0:1] - x0[None, :]) * ex
             + (p[:, 1:2] - y0[None, :]) * ey) / len2,
            0.0, 1.0,
        )
        dx = p[:, 0:1] - (x0[None, :] + tpar * ex)
        dy = p[:, 1:2] - (y0[None, :] + tpar * ey)
        return jnp.sqrt(dx * dx + dy * dy + 1e-20)

    seg_min = jnp.minimum(
        jnp.minimum(seg_dist(ax, ay, bx, by), seg_dist(bx, by, cx, cy)),
        seg_dist(cx, cy, ax, ay),
    )
    inside = hp_min >= 0.0
    sdist = jnp.where(inside, hp_min, -seg_min)  # pixels, inside-positive


    # Screen-space barycentrics (normalized sub-areas).
    area_safe = jnp.where(jnp.abs(area) > 1e-12, area, 1e-12)
    l0 = (
        (bx[None, :] - p[:, 0:1]) * (cy[None, :] - p[:, 1:2])
        - (by[None, :] - p[:, 1:2]) * (cx[None, :] - p[:, 0:1])
    ) / area_safe[None, :]
    l1 = (
        (cx[None, :] - p[:, 0:1]) * (ay[None, :] - p[:, 1:2])
        - (cy[None, :] - p[:, 1:2]) * (ax[None, :] - p[:, 0:1])
    ) / area_safe[None, :]
    l2 = 1.0 - l0 - l1

    # Outside a triangle raw barycentrics EXTRAPOLATE, which lets a
    # nearby triangle's extrapolated depth hijack the softmax (and shades
    # at a nonexistent surface point). Clamp barycentrics to the simplex —
    # outside pixels take the attributes of (approximately) their nearest
    # in-triangle point; exact for inside pixels.
    l0c = jnp.clip(l0, 0.0, 1.0)
    l1c = jnp.clip(l1, 0.0, 1.0)
    l2c = jnp.clip(l2, 0.0, 1.0)
    lsum = l0c + l1c + l2c + 1e-12
    l0c, l1c, l2c = l0c / lsum, l1c / lsum, l2c / lsum

    zpx = (
        l0c * zinv[None, :, 0]
        + l1c * zinv[None, :, 1]
        + l2c * zinv[None, :, 2]
    )  # (R, T)
    ppx = (
        l0c[..., None] * pos3d[None, :, 0, :]
        + l1c[..., None] * pos3d[None, :, 1, :]
        + l2c[..., None] * pos3d[None, :, 2, :]
    )  # (R, T, 3)

    return sdist, zpx, ppx, area_ok


def rasterize_soft(scene: Scene, camera: Camera, lights: Lights,
                   cfg: RenderConfig) -> jax.Array:
    """Differentiable rasterize; returns (H, W, 3).

    Soft z-buffer: per-pixel softmax over triangle logits
    ``z_sharpness * zinv + log_sigmoid(edge_sharpness * sdist)`` with a
    background logit at zinv = 0 — exactly the reference's cleared depth
    buffer in the hard limit (`rasteriser.cpp:188,606`). Hypotheses
    aggregate attributes
    (albedo, pos3d numerator, zinv, normal) with simplex-clamped
    screen-space barycentrics (zinv and pos3d = pos/z are affine in
    screen space — the standard perspective-correct scheme, same as
    `rasteriser.cpp:538-541`); shading runs once per pixel on the
    aggregate (shade_agg_raster).
    """
    agg, _, _ = rasterize_soft_partials(_pixel_centers(cfg), scene, camera,
                                        cfg)
    img = shade_agg_raster(agg[:, 0:3], agg[:, 3:6], agg[:, 6],
                           agg[:, 7:10], camera, lights, cfg.ambient)
    return img.reshape(cfg.height, cfg.width, 3)


def rasterize_soft_partials(p: jax.Array, scene: Scene, camera: Camera,
                            cfg: RenderConfig):
    """Streaming soft z-buffer of pixels ``p`` (R, 2) against ``scene``'s
    triangles plus the background hypothesis (logit 0 at zinv = 0, the
    cleared depth buffer `rasteriser.cpp:188`; zero attributes).

    Returns the online-softmax partials (agg, m, s): agg (R, 10) the
    normalized (albedo, pos3d numerator, zinv, normal) aggregate, m (R,)
    the running max logit and s (R,) the softmax mass relative to
    exp(m). O(R * chunk) live memory, so 9k-triangle scenes fit. A
    model-sharded caller runs this on its triangle block and merges the
    partials (parallel.render._soft_combine).
    """
    sx, sy, zinv, pos3d = _screen_vertices(scene, camera, cfg)
    keep = scene.active
    colors = scene.color
    normals = scene.normals()

    T = scene.num_triangles
    chunk = min(max(T, 1), max(cfg.raster_tri_chunk, 1))
    padn = chunk if T == 0 else (-T) % chunk  # see _chunked_scene
    if padn:
        def padt(a):
            return jnp.concatenate(
                [a, jnp.zeros((padn,) + a.shape[1:], a.dtype)], axis=0
            )
        sx, sy, zinv, pos3d = padt(sx), padt(sy), padt(zinv), padt(pos3d)
        keep, colors, normals = padt(keep), padt(colors), padt(normals)
    n_chunks = (T + padn) // chunk
    R = p.shape[0]

    def resh(a):
        return a.reshape((n_chunks, chunk) + a.shape[1:])

    def body(carry, inp):
        m, s, acc = carry
        sxc, syc, zc, pc, keepc, colc, nc = inp
        sdist, zpx, ppx, area_ok = _fields_for(p, sxc, syc, zc, pc)
        mask = keepc * area_ok.astype(jnp.float32)
        logit = (
            cfg.soft_z_sharpness * zpx
            + jax.nn.log_sigmoid(cfg.soft_edge_sharpness * sdist)
            + jnp.log(mask[None, :] + 1e-20)
        )
        alb = jnp.broadcast_to(colc[None, :, :], ppx.shape)
        nrm = jnp.broadcast_to(nc[None, :, :], ppx.shape)
        num = jnp.concatenate(
            [alb, ppx, zpx[..., None], nrm], axis=-1
        )  # (R, C, 10)
        return _online_softmax_step(m, s, acc, logit, num), None

    dt = sx.dtype
    init = (
        jnp.zeros((R,), dt),        # m = bg logit
        jnp.ones((R,), dt),         # s = bg weight
        jnp.zeros((R, 10), dt),     # acc (bg contributes zeros)
    )
    xs_in = (resh(sx), resh(sy), resh(zinv), resh(pos3d), resh(keep),
             resh(colors), resh(normals))
    (m, s, acc), _ = jax.lax.scan(body, init, xs_in)
    return acc / s[:, None], m, s


def rasterize_exact(scene: Scene, camera: Camera, lights: Lights,
                    cfg: RenderConfig) -> jax.Array:
    """Float-precise HARD rasterizer — the limit of rasterize_soft.

    Same geometry as the soft path, but a hard select: a pixel is covered
    when its signed distance >= 0, and the max-zinv covered triangle wins
    (background when none; zinv > 0 required, matching the cleared depth
    buffer). This is 'clean'-mode rasterization: the reference's scanline
    truncation quirks (kept in mode='parity') are dropped.

    Only the winner's attributes are then recomputed and shaded —
    gradients flow through that recompute (the winner index is
    piecewise-constant).
    """
    H, W = cfg.height, cfg.width
    sx, sy, zinv, pos3d = _screen_vertices(scene, camera, cfg)
    # Honor the reference's backface culling toggle (Z5,
    # `rasteriser.cpp:404-412`) in clean mode too: it is part of the
    # reference pipeline, not a scanline quirk, and it halves the winner
    # search. Frustum culling (Z6) stays parity-only: its any-VERTEX-
    # inside test (`:444-445`) wrongly culls triangles whose interior
    # covers the screen when focal >> resolution — a reference bug the
    # clean path does not reproduce. Piecewise-constant, no grad path.
    from raytpu.ops.raster import cull_mask as _hard_cull

    keep = jax.lax.stop_gradient(
        _hard_cull(scene, camera, cfg.replace(frustum_cull=False)))
    ys, xs = jnp.meshgrid(
        jnp.arange(H, dtype=jnp.float32), jnp.arange(W, dtype=jnp.float32),
        indexing="ij",
    )
    px = xs.reshape(-1)
    py = ys.reshape(-1)

    sdist, zpx_f, _, area_ok = _fields_for(
        _pixel_centers(cfg), sx, sy, zinv, pos3d
    )
    covered = (
        (sdist >= 0.0) & (keep[None, :] > 0.0) & (zpx_f > 0.0)
        & area_ok[None, :]
    )
    z_masked = jnp.where(covered, zpx_f, -jnp.inf)
    arg = jnp.argmax(z_masked, axis=1)
    hit = jnp.take_along_axis(z_masked, arg[:, None], axis=1)[:, 0] > 0.0
    winner = jnp.where(hit, arg, -1).astype(jnp.int32)

    img = _shade_winner(winner, px, py, sx, sy, zinv, pos3d, scene,
                        camera, lights, cfg)
    return img.reshape(H, W, 3)


def _shade_winner(winner, px, py, sx, sy, zinv, pos3d, scene: Scene,
                  camera: Camera, lights: Lights,
                  cfg: RenderConfig) -> jax.Array:
    """Shade only each pixel's winning triangle: recompute its
    barycentrics/attributes per pixel (O(R) instead of O(R*T)) and run the
    clean PixelShader. winner: (R,) int32, -1 = background."""
    from raytpu.ops.intersect import gather_rows, one_hot_idx
    from raytpu.ops.raster import glm_inverse3

    hit = winner >= 0
    safe = jnp.maximum(winner, 0)
    T = sx.shape[0]
    if T <= 1024:
        # ONE (R, T) @ (T, 24) matmul for all six per-winner attribute
        # gathers: the (R, T) one-hot is read once instead of six times
        # fwd and bwd; each output column is the same independent K-dot,
        # so results are bit-identical to separate gathers.
        oh = one_hot_idx(safe, T)
        g = gather_rows(oh, jnp.concatenate(
            [sx, sy, zinv, pos3d.reshape(T, 9),
             scene.normals(), scene.color], axis=1))
        vx, vy, vz = g[:, 0:3], g[:, 3:6], g[:, 6:9]
        vp = g[:, 9:18].reshape(-1, 3, 3)
        n_dir, albedo = g[:, 18:21], g[:, 21:24]
    else:
        vx, vy = sx[safe], sy[safe]
        vz, vp = zinv[safe], pos3d[safe]
        n_dir = scene.normals()[safe]
        albedo = scene.color[safe]

    ax, ay = vx[:, 0], vy[:, 0]
    bx, by = vx[:, 1], vy[:, 1]
    cx, cy = vx[:, 2], vy[:, 2]
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    area_safe = jnp.where(jnp.abs(area) > 1e-12, area, 1e-12)
    l0 = ((bx - px) * (cy - py) - (by - py) * (cx - px)) / area_safe
    l1 = ((cx - px) * (ay - py) - (cy - py) * (ax - px)) / area_safe
    l2 = 1.0 - l0 - l1
    l0c = jnp.clip(l0, 0.0, 1.0)
    l1c = jnp.clip(l1, 0.0, 1.0)
    l2c = jnp.clip(l2, 0.0, 1.0)
    lsum = l0c + l1c + l2c + 1e-12
    l0c, l1c, l2c = l0c / lsum, l1c / lsum, l2c / lsum

    zpx = l0c * vz[:, 0] + l1c * vz[:, 1] + l2c * vz[:, 2]
    ppx = (
        l0c[:, None] * vp[:, 0] + l1c[:, None] * vp[:, 1]
        + l2c[:, None] * vp[:, 2]
    )

    inv_rot = glm_inverse3(camera.rotation())
    zsafe = jnp.where(jnp.abs(zpx) > 1e-12, zpx, 1e-12)
    world = _MM(ppx / zsafe[:, None], inv_rot) + camera.pos
    irr = irradiance_no_shadow(world, n_dir, lights)
    color = albedo * (irr + jnp.float32(cfg.ambient))
    return jnp.where(hit[:, None], color, 0.0)
