"""Pixel-major rasterization ops (jnp / XLA path).

Data-parallel inversion of the reference's triangle-major scanline pipeline
(`rasteriser/Source/rasteriser.cpp:461-768`): instead of walking rows and
Bresenham-filling pixels per triangle (with its default-off racy OpenMP
triangle loop, `rasteriser.cpp:22,467-479`), raytpu computes, for every
pixel in parallel, which triangle wins the depth test — a data-parallel
formulation with no write races by construction (SURVEY.md §5 Z9).

The pipeline:
  1. vertex_stage    — batched VertexShader (`rasteriser.cpp:532-546`).
  2. cull_mask       — backface + frustum masks (`rasteriser.cpp:404-447`).
  3. row_bounds      — per-(triangle, row) left/right extremes with the
                       reference's float-walk interpolation semantics
                       (`ComputePolygonRows`/`Interpolate`, `:674-735`).
  4. resolve_depth   — pixel-major coverage + z-resolve; the sequential
                       z-test ``zinv > depthBuffer`` over ordered triangles
                       (`:606`) is exactly "max zinv, first-wins ties".
  5. pixel_shade     — deferred PixelShader over the G-buffer (`:549-589`).

Parity: the reference accumulates edge interpolation in float
(``current += step``, `:626-635`), which has no closed form; parity mode
replays the accumulation bit-for-bit with a lax.scan (row_bounds_exact),
making coverage and depth winners EXACTLY the oracle's
(raytpu.oracle.rasterizer_oracle). 'clean'/'soft' modes use the
closed-form ``a + k*step`` (identical to 1 ulp, no sequential scan).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from raytpu.core.types import Camera, Lights, RenderConfig, Scene

# Python int, not jnp.int32(...): a module-level device constant would
# initialize the XLA backend at import time, breaking
# jax.distributed.initialize() (must run before backend init).
_INTMAX = 2147483647


def glm_inverse3(m: jax.Array) -> jax.Array:
    """3x3 inverse via adjugate/det in f32 — glm::inverse op order."""
    det = (
        m[0, 0] * (m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1])
        - m[0, 1] * (m[1, 0] * m[2, 2] - m[1, 2] * m[2, 0])
        + m[0, 2] * (m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0])
    )
    inv_det = 1.0 / det
    adj = jnp.array(
        [
            [
                m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1],
                -(m[0, 1] * m[2, 2] - m[0, 2] * m[2, 1]),
                m[0, 1] * m[1, 2] - m[0, 2] * m[1, 1],
            ],
            [
                -(m[1, 0] * m[2, 2] - m[1, 2] * m[2, 0]),
                m[0, 0] * m[2, 2] - m[0, 2] * m[2, 0],
                -(m[0, 0] * m[1, 2] - m[0, 2] * m[1, 0]),
            ],
            [
                m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0],
                -(m[0, 0] * m[2, 1] - m[0, 1] * m[2, 0]),
                m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0],
            ],
        ]
    )
    return adj * inv_det


class VertexData(NamedTuple):
    """Screen-space data for all triangle vertices.

    px, py: (T, 3) int32 screen coords (truncated, `rasteriser.cpp:544-545`).
    zinv:   (T, 3) float32 1/z in camera space (`:541`).
    pos3d:  (T, 3, 3) float32 camera-space position / z (`:538`).
    """

    px: jax.Array
    py: jax.Array
    zinv: jax.Array
    pos3d: jax.Array


def vertex_stage(scene: Scene, camera: Camera,
                 cfg: RenderConfig) -> VertexData:
    """Batched VertexShader: one matmul over all 3T vertices."""
    rot = camera.rotation()
    verts = jnp.stack([scene.v0, scene.v1, scene.v2], axis=1)  # (T, 3, 3)
    # precision=HIGHEST: a reduced-precision f32 matmul (TF32 on GPUs) is a
    # 1e-3-level error on vertex positions — far above parity tolerance.
    pos = jnp.matmul(
        verts - camera.pos, rot, precision=jax.lax.Precision.HIGHEST
    )  # (v - C) * R  (`:535`)
    z = pos[..., 2]
    zinv = 1.0 / z
    pos3d = pos * zinv[..., None]
    # int truncation BEFORE adding W/2 (`:544-545`).
    px = jnp.trunc(camera.focal * (pos[..., 0] * zinv)).astype(jnp.int32) + (
        cfg.width // 2
    )
    py = jnp.trunc(camera.focal * (pos[..., 1] * zinv)).astype(jnp.int32) + (
        cfg.height // 2
    )
    return VertexData(px=px, py=py, zinv=zinv, pos3d=pos3d)


def cull_mask(scene: Scene, camera: Camera, cfg: RenderConfig) -> jax.Array:
    """Triangle keep-mask (float32): active & !backface & !frustum-out.

    Backface: ``dot(v0 - cameraPos, normal) > 0`` culls (`:410`).
    Frustum: the reference's fovy matrix with transform[3][2] overwritten to
    1.0 (`:402`) reduces to an x,y NDC bounds test with w' = z; a triangle is
    culled when ALL three verts are outside (`:444-445`).
    """
    keep = scene.active > 0.0
    normals = scene.normals()
    if cfg.backface_cull:
        keep &= ~(
            jnp.sum((scene.v0 - camera.pos) * normals, axis=-1) > 0.0
        )
    if cfg.frustum_cull:
        h = jnp.float32(cfg.height)
        w = jnp.float32(cfg.width)
        t = jnp.array([0.0, -1.0, 0.0]) * (h / 2.0) + jnp.array(
            [0.0, 0.0, 1.0]
        ) * camera.focal
        b = jnp.array([0.0, 1.0, 0.0]) * (h / 2.0) + jnp.array(
            [0.0, 0.0, 1.0]
        ) * camera.focal
        cy = jnp.dot(t, b, precision=jax.lax.Precision.HIGHEST) / (
            jnp.linalg.norm(t) * jnp.linalg.norm(b)
        )
        rfovy = jnp.arccos(cy)
        k = 1.0 / jnp.tan(rfovy / 2.0)
        aspect = w / h
        rot = camera.rotation()

        def ndc_inside(v):
            cs = jnp.matmul(v - camera.pos, rot,
                            precision=jax.lax.Precision.HIGHEST)
            x = (cs[:, 0] * (k / aspect)) / cs[:, 2]
            y = (cs[:, 1] * k) / cs[:, 2]
            return (x >= -1) & (x <= 1) & (y >= -1) & (y <= 1)

        inside = (
            ndc_inside(scene.v0) | ndc_inside(scene.v1) | ndc_inside(scene.v2)
        )
        keep &= inside
    return keep.astype(jnp.float32)


class RowBounds(NamedTuple):
    """Per-(triangle, screen-row) scanline extremes.

    left_x/right_x: (T, H) int32 (INT_MAX / -INT_MAX when the row is not
    covered). left_z/right_z: (T, H) f32. left_p/right_p: (T, H, 3) f32.
    """

    left_x: jax.Array
    right_x: jax.Array
    left_z: jax.Array
    right_z: jax.Array
    left_p: jax.Array
    right_p: jax.Array


def row_bounds(vd: VertexData, cfg: RenderConfig) -> RowBounds:
    """ComputePolygonRows, vectorized over (triangle, row).

    For each of the 3 edges i->(i+1)%3 (`:705-714`) the reference
    interpolates |dy|+1 samples — one per row — truncating x to int; the
    left/right extremes update on STRICT inequality in edge order
    (`:716-733`). Here each edge's sample at screen row y is computed in
    closed form (k = |y - y_i|, attribute = a + k*step). Parity mode uses
    row_bounds_exact instead (bit-faithful float accumulation).
    """
    T = vd.px.shape[0]
    H = cfg.height
    y_rows = jnp.arange(H, dtype=jnp.int32)[None, :]  # (1, H)

    left_x = jnp.full((T, H), _INTMAX, jnp.int32)
    right_x = jnp.full((T, H), -_INTMAX, jnp.int32)
    left_z = jnp.zeros((T, H), jnp.float32)
    right_z = jnp.zeros((T, H), jnp.float32)
    left_p = jnp.zeros((T, H, 3), jnp.float32)
    right_p = jnp.zeros((T, H, 3), jnp.float32)

    for i in range(3):
        j = (i + 1) % 3
        xi = vd.px[:, i][:, None]
        xj = vd.px[:, j][:, None]
        yi = vd.py[:, i][:, None]
        yj = vd.py[:, j][:, None]
        zi = vd.zinv[:, i][:, None]
        zj = vd.zinv[:, j][:, None]
        pi = vd.pos3d[:, i][:, None, :]
        pj = vd.pos3d[:, j][:, None, :]

        lo = jnp.minimum(yi, yj)
        hi = jnp.maximum(yi, yj)
        visited = (y_rows >= lo) & (y_rows <= hi)  # (T, H)
        denom = jnp.maximum(hi - lo, 1).astype(jnp.float32)
        kf = jnp.abs(y_rows - yi).astype(jnp.float32)

        sx = (xj - xi).astype(jnp.float32) / denom
        x = jnp.trunc(xi.astype(jnp.float32) + kf * sx).astype(jnp.int32)
        z = zi + kf * ((zj - zi) / denom)
        p = pi + kf[..., None] * ((pj - pi) / denom[..., None])

        xl = jnp.where(visited, x, _INTMAX)
        upd_l = xl < left_x
        left_x = jnp.where(upd_l, xl, left_x)
        left_z = jnp.where(upd_l, z, left_z)
        left_p = jnp.where(upd_l[..., None], p, left_p)

        xr = jnp.where(visited, x, -_INTMAX)
        upd_r = xr > right_x
        right_x = jnp.where(upd_r, xr, right_x)
        right_z = jnp.where(upd_r, z, right_z)
        right_p = jnp.where(upd_r[..., None], p, right_p)

    return RowBounds(left_x, right_x, left_z, right_z, left_p, right_p)


def row_bounds_exact(vd: VertexData, cfg: RenderConfig) -> RowBounds:
    """ComputePolygonRows with the reference's float ACCUMULATION
    semantics, bit-for-bit (`Interpolate`, `rasteriser.cpp:615-637`):
    each edge walks ``current += step`` in f32 and truncates per sample,
    so sample k is k chained rounded adds — there is no closed form.

    A `lax.scan` of 2H steps replays the walk for all T triangles at
    once; at step k every edge's sample lands on screen row
    ``y_i + k*sign(dy)`` (the y accumulator steps by exactly +-1.0, which
    is exact in f32 for |y| < 2^24), and the left/right extremes update
    in place via a masked scatter. Edges run as three SEQUENTIAL scans to
    preserve the reference's edge-major strict-inequality tie order
    (`:716-733`). Edges whose start row lies outside [-H, 2H) cannot
    reach the screen within the 2H-step horizon; they fall back to the
    closed-form sample (off-screen-start geometry, not present in the
    parity scenes — and a 1-ulp flip there moves an extreme by one pixel
    at most).

    This is the parity path: it trades a 6H-step sequential scan for the
    rasterizer bit-parity claim (round-1 VERDICT stretch 9). 'clean' and
    'soft' modes keep the closed-form row_bounds.
    """
    T = vd.px.shape[0]
    H = cfg.height
    L = 2 * H  # static accumulation horizon
    y_rows = jnp.arange(H, dtype=jnp.int32)[None, :]

    left_x = jnp.full((T, H), _INTMAX, jnp.int32)
    right_x = jnp.full((T, H), -_INTMAX, jnp.int32)
    left_z = jnp.zeros((T, H), jnp.float32)
    right_z = jnp.zeros((T, H), jnp.float32)
    left_p = jnp.zeros((T, H, 3), jnp.float32)
    right_p = jnp.zeros((T, H, 3), jnp.float32)

    ar_t = jnp.arange(T, dtype=jnp.int32)

    for i in range(3):
        j = (i + 1) % 3
        xi, xj = vd.px[:, i], vd.px[:, j]          # (T,) int32
        yi, yj = vd.py[:, i], vd.py[:, j]
        zi, zj = vd.zinv[:, i], vd.zinv[:, j]      # (T,) f32
        pi, pj = vd.pos3d[:, i], vd.pos3d[:, j]    # (T, 3) f32

        dy = yj - yi
        ady = jnp.abs(dy)
        dirn = jnp.sign(dy)                        # int32, 0 when dy == 0
        denom = jnp.maximum(ady, 1).astype(jnp.float32)
        sx = (xj - xi).astype(jnp.float32) / denom
        sz = (zj - zi) / denom
        sp = (pj - pi) / denom[:, None]
        in_horizon = (yi >= -H) & (yi < 2 * H)

        def body(carry, k, yi=yi, ady=ady, dirn=dirn, sx=sx, sz=sz, sp=sp,
                 in_horizon=in_horizon):
            cx, cz, cp, lx, lz, lp, rx, rz, rp = carry
            r = yi + k * dirn
            x_int = jnp.trunc(cx).astype(jnp.int32)
            valid = ((k <= ady) & in_horizon & (r >= 0) & (r < H))
            rc = jnp.clip(r, 0, H - 1)

            old = lx[ar_t, rc]
            upd = valid & (x_int < old)
            lx = lx.at[ar_t, rc].set(jnp.where(upd, x_int, old))
            lz = lz.at[ar_t, rc].set(jnp.where(upd, cz, lz[ar_t, rc]))
            lp = lp.at[ar_t, rc].set(
                jnp.where(upd[:, None], cp, lp[ar_t, rc]))

            old = rx[ar_t, rc]
            upd = valid & (x_int > old)
            rx = rx.at[ar_t, rc].set(jnp.where(upd, x_int, old))
            rz = rz.at[ar_t, rc].set(jnp.where(upd, cz, rz[ar_t, rc]))
            rp = rp.at[ar_t, rc].set(
                jnp.where(upd[:, None], cp, rp[ar_t, rc]))

            return (cx + sx, cz + sz, cp + sp,
                    lx, lz, lp, rx, rz, rp), None

        init = (xi.astype(jnp.float32), zi, pi,
                left_x, left_z, left_p, right_x, right_z, right_p)
        carry, _ = jax.lax.scan(body, init,
                                jnp.arange(L, dtype=jnp.int32))
        (_, _, _, left_x, left_z, left_p,
         right_x, right_z, right_p) = carry

        # Closed-form fallback for edges starting beyond the horizon.
        lo = jnp.minimum(yi, yj)[:, None]
        hi = jnp.maximum(yi, yj)[:, None]
        visited = (~in_horizon)[:, None] & (y_rows >= lo) & (y_rows <= hi)
        kf = jnp.abs(y_rows - yi[:, None]).astype(jnp.float32)
        x = jnp.trunc(
            xi[:, None].astype(jnp.float32) + kf * sx[:, None]
        ).astype(jnp.int32)
        z = zi[:, None] + kf * sz[:, None]
        p = pi[:, None, :] + kf[..., None] * sp[:, None, :]

        xl = jnp.where(visited, x, _INTMAX)
        upd_l = xl < left_x
        left_x = jnp.where(upd_l, xl, left_x)
        left_z = jnp.where(upd_l, z, left_z)
        left_p = jnp.where(upd_l[..., None], p, left_p)
        xr = jnp.where(visited, x, -_INTMAX)
        upd_r = xr > right_x
        right_x = jnp.where(upd_r, xr, right_x)
        right_z = jnp.where(upd_r, z, right_z)
        right_p = jnp.where(upd_r[..., None], p, right_p)

    return RowBounds(left_x, right_x, left_z, right_z, left_p, right_p)


class GBuffer(NamedTuple):
    """Per-pixel closest-surface attributes (flattened R = H*W).

    idx: (R,) int32 winning triangle (-1 = background). zinv: (R,) f32.
    pos3d: (R, 3) f32 interpolated camera-space pos/z.
    """

    idx: jax.Array
    zinv: jax.Array
    pos3d: jax.Array


def resolve_depth(bounds: RowBounds, keep: jax.Array,
                  cfg: RenderConfig) -> GBuffer:
    """Pixel-major coverage + depth resolve.

    A pixel (x, y) is covered by a triangle when ``left_x < x <= right_x``
    on its row — the reference's Bresenham skips the leftmost pixel
    (`:651-653`) — and its interpolated zinv beats the buffer
    (``zinv > depth``, cleared to 0: `:606,:188`). Attributes lag one pixel:
    ``attr(x) = a + step * (x - a.x - 1)`` (`:665-668`).

    Triangles stream in chunks of ``cfg.raster_tri_chunk`` via lax.scan;
    ties keep the earliest triangle (strict > update == reference order).
    """
    T, H = bounds.left_x.shape
    W = cfg.width
    xs = jnp.arange(W, dtype=jnp.int32)[None, None, :]  # (1, 1, W)

    chunk = min(cfg.raster_tri_chunk, T)
    if T % chunk != 0:
        raise ValueError(f"triangle count {T} not a multiple of {chunk}")
    n_chunks = T // chunk

    def chunk_best(cb: RowBounds, keep_c):
        """(C, H) bounds -> per-pixel best (zinv, local idx) over chunk."""
        lx = cb.left_x[:, :, None]  # (C, H, 1)
        rx = cb.right_x[:, :, None]
        covered = (xs > lx) & (xs <= rx)
        covered &= (keep_c > 0.0)[:, None, None]
        dx = (cb.right_x - cb.left_x).astype(jnp.float32)
        zstep = jnp.where(
            dx > 0, (cb.right_z - cb.left_z) / jnp.maximum(dx, 1.0), 0.0
        )
        i_rel = (xs - lx - 1).astype(jnp.float32)
        z = cb.left_z[:, :, None] + zstep[:, :, None] * i_rel  # (C, H, W)
        z = jnp.where(covered, z, -jnp.inf)
        best_local = jnp.argmax(z, axis=0)  # (H, W) first-wins
        best_z = jnp.take_along_axis(z, best_local[None], axis=0)[0]
        return best_z, best_local

    if n_chunks == 1:
        best_z, best_local = chunk_best(bounds, keep)
        best_idx = best_local.astype(jnp.int32)
    else:
        b_r = jax.tree_util.tree_map(
            lambda a: a.reshape((n_chunks, chunk) + a.shape[1:]), bounds
        )
        keep_r = keep.reshape(n_chunks, chunk)

        def body(carry, xs_c):
            bz, bi = carry
            ci, cb, kc = xs_c
            z, local = chunk_best(cb, kc)
            gidx = (ci * chunk + local).astype(jnp.int32)
            upd = z > bz  # strictly-greater: earlier chunk wins ties
            return (jnp.where(upd, z, bz), jnp.where(upd, gidx, bi)), None

        init = (
            jnp.full((H, W), -jnp.inf, jnp.float32),
            jnp.zeros((H, W), jnp.int32),
        )
        (best_z, best_idx), _ = jax.lax.scan(
            body, init,
            (jnp.arange(n_chunks, dtype=jnp.int32), b_r, keep_r),
        )

    hit = jnp.isfinite(best_z) & (best_z > 0.0)
    idx = jnp.where(hit, best_idx, -1)

    # Recompute the winner's attributes by gathering its row bounds.
    y_grid = jnp.broadcast_to(
        jnp.arange(H, dtype=jnp.int32)[:, None], (H, W)
    )
    safe = jnp.maximum(idx, 0)
    lx = bounds.left_x[safe, y_grid]
    rx = bounds.right_x[safe, y_grid]
    lz = bounds.left_z[safe, y_grid]
    rz = bounds.right_z[safe, y_grid]
    lp = bounds.left_p[safe, y_grid]
    rp = bounds.right_p[safe, y_grid]
    dx = (rx - lx).astype(jnp.float32)
    i_rel = (
        jnp.broadcast_to(jnp.arange(W, dtype=jnp.int32)[None, :], (H, W))
        - lx - 1
    ).astype(jnp.float32)
    dx_safe = jnp.maximum(dx, 1.0)
    zpx = lz + ((rz - lz) / dx_safe) * i_rel
    ppx = lp + ((rp - lp) / dx_safe[..., None]) * i_rel[..., None]

    return GBuffer(
        idx=idx.reshape(-1),
        zinv=jnp.where(hit, zpx, 0.0).reshape(-1),
        pos3d=jnp.where(hit[..., None], ppx, 0.0).reshape(-1, 3),
    )


def pixel_shade(g: GBuffer, scene: Scene, camera: Camera, lights: Lights,
                cfg: RenderConfig):
    """Deferred PixelShader (`rasteriser.cpp:549-589`).

    World position is reconstructed as ``(pos3d / zinv) * R^-1 + C``
    (`:554-560`); per-light inverse-square + Lambert with NO shadow test
    (`:567-584`); final color ``reflectance * (result + ambient) * albedo``
    with reflectance = (1,1,1) (`:466,:587`).

    Returns (color (R, 3), focal_distance (R,)).
    """
    hit = g.idx >= 0
    safe = jnp.maximum(g.idx, 0)
    inv_rot = glm_inverse3(camera.rotation())
    zinv_safe = jnp.where(hit, g.zinv, 1.0)
    world = jnp.matmul(
        g.pos3d / zinv_safe[:, None], inv_rot,
        precision=jax.lax.Precision.HIGHEST,
    ) + camera.pos

    # Guarded norms: sqrt(0) has an infinite derivative, and a masking
    # `where` AFTER the sqrt does not stop the NaN cotangent.
    cam_d2 = jnp.sum((world - camera.pos) ** 2, axis=-1)
    cam_d = jnp.sqrt(jnp.where(cam_d2 > 0.0, cam_d2, 1.0))
    fd = jnp.where(hit & (cam_d2 > 0.0), cam_d - camera.dof_focus, 0.0)

    normals = scene.normals()
    n_dir = normals[safe]
    result = jnp.zeros_like(world)
    for k in range(lights.capacity):
        delta = world - lights.position[k][None, :]
        r2 = jnp.sum(delta * delta, axis=-1)
        # r = 0 when a (fitted) light sits exactly on the shaded point.
        lit = r2 > 0.0
        r2s = jnp.where(lit, r2, 1.0)
        r = jnp.sqrt(r2s)
        A = 4.0 * jnp.pi * r2s
        light_color = lights.color[k] * lights.intensity[k]
        r_dir = -delta / r[:, None]
        lam = jnp.maximum(jnp.sum(r_dir * n_dir, axis=-1), 0.0)
        result = result + lights.mask[k] * jnp.where(
            lit[:, None],
            (light_color[None, :] / A[:, None]) * lam[:, None], 0.0,
        )

    color = (result + jnp.float32(cfg.ambient)) * scene.color[safe]
    return jnp.where(hit[:, None], color, 0.0), fd
