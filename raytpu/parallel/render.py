"""Sharded rendering + training step (shard_map over a device mesh).

SPMD re-design of the reference's OpenMP row loop (`raytracer.cpp:557`;
SURVEY.md §5.8):

  * image rows are sharded over the mesh's 'data' axis — each device
    renders a contiguous row block (the reference's ``parallel for`` over
    scanlines, minus the shared-memory races by construction);
  * triangles are sharded over the 'model' axis — each device intersects
    its triangle block, and the global closest hit is merged with an
    `all_gather` over the axis (the reduction analog of the reference's
    per-triangle loop); shadow occlusion bits merge with an any-reduce;
  * scene attribute arrays stay replicated (they are tiny next to the
    per-ray work), so winner gathers are local;
  * the training loss is `psum`'d over 'data' and `pmean`'d over 'model',
    and `jax.grad` through the shard_map produces replicated parameter
    gradients with the cross-device reductions inserted by JAX.

Each block runs the single-device math (raytpu.ops, raytpu.render.soft)
on its rows and triangle block; only the merges live here. DoF runs on
the row-sharded image with a halo exchange between neighbouring row
shards (dof_block).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from jax import shard_map

from raytpu.core.types import Camera, Lights, RenderConfig, Scene
from raytpu.ops.intersect import intersect, tri_constants
from raytpu.ops.shade import composite, direct_light, shadow_sources
from raytpu.parallel.mesh import DATA_AXIS, MODEL_AXIS

_F32MAX = 3.4028235e38  # Python float; see ops/raster.py note


def _scene_block(scene: Scene, axis_name: str) -> tuple[Scene, jax.Array]:
    """This shard's contiguous triangle block (sliced from the replicated
    scene) and its global base index."""
    mi = jax.lax.axis_index(axis_name)
    nm = jax.lax.axis_size(axis_name)
    T = scene.num_triangles
    if T % nm != 0:
        raise ValueError(
            f"triangle count {T} not divisible by model axis {nm}; "
            "use Scene.pad_to"
        )
    tb = T // nm
    base = mi * tb

    def sl(a):
        return jax.lax.dynamic_slice_in_dim(a, base, tb, axis=0)

    return Scene(v0=sl(scene.v0), v1=sl(scene.v1), v2=sl(scene.v2),
                 color=sl(scene.color), active=sl(scene.active)), base


def _merged_intersect(start, dirs, block: Scene, base, cfg: RenderConfig,
                      axis_name: str):
    """Closest hit against the FULL scene from per-shard triangle blocks.

    Local closest hits (t, global idx) are all_gathered over the model axis
    and merged in ascending block order with the reference's
    last-wins-on-ties rule (`raytracer.cpp:243`).
    Returns (t, idx, hit) with t = ray parameter.
    """
    h = intersect(dirs, tri_constants(block, start), tri_chunk=cfg.tri_chunk)
    t_local = jnp.where(h.hit, h.t, _F32MAX)
    idx_local = jnp.where(h.hit, h.idx + base, -1)
    ts = jax.lax.all_gather(t_local, axis_name)      # (nm, R)
    idxs = jax.lax.all_gather(idx_local, axis_name)  # (nm, R)

    best_t = ts[0]
    best_idx = idxs[0]
    for m in range(1, ts.shape[0]):
        upd = ts[m] <= best_t  # later (higher-index) blocks win ties
        best_t = jnp.where(upd, ts[m], best_t)
        best_idx = jnp.where(upd, idxs[m], best_idx)
    hit = best_t < _F32MAX
    return best_t, jnp.where(hit, best_idx, -1), hit


def _block_grid(cfg: RenderConfig, y0, rows: int):
    """Pixel grid for rows [y0, y0 + rows)."""
    ys, xs = jnp.meshgrid(
        y0 + jnp.arange(rows, dtype=jnp.float32),
        jnp.arange(cfg.width, dtype=jnp.float32),
        indexing="ij",
    )
    return xs.reshape(-1), ys.reshape(-1)


def _merged_occlusion_rows(pos, block: Scene, src_pos, cfg: RenderConfig,
                           axis_name: str) -> jax.Array:
    """(S, R) occlusion bits against the FULL scene from per-shard blocks.

    Each device any-hit-tests its triangle block for every shadow source,
    then the global bit is the any-reduce over the model axis
    (all_gather + max — pmax has no JAX differentiation rule and this
    sits inside the training step's backward even though the boolean
    carries no gradient).
    """
    rows = []
    for s in range(src_pos.shape[0]):
        delta = pos - src_pos[s][None, :]
        sh = intersect(delta, tri_constants(block, src_pos[s]),
                       tri_chunk=cfg.tri_chunk)
        rows.append(sh.hit & (sh.t < jnp.float32(0.99)))
    occ_local = jnp.stack(rows, axis=0)
    gathered = jax.lax.all_gather(
        occ_local.astype(jnp.int32), axis_name
    )  # (nm, S, R)
    return jnp.max(gathered, axis=0) > 0


def render_block(scene: Scene, camera: Camera, lights: Lights,
                 cfg: RenderConfig, y0, rows: int) -> jax.Array:
    """Render a row block inside shard_map (data+model sharded).

    Full feature set of the single-chip path in 'clean'/'parity'
    (non-AA-record) semantics: AA sub-rays, soft shadows, multi-light —
    shadow occlusion for every (light, sample) source is computed against
    the local triangle block in one fused launch and any-merged over the
    model axis. DoF is applied by the caller (dof_block halo exchange).
    Returns (rows * W, 3).
    """
    from raytpu.render.raytrace import _subpixel_offsets, camera_ray_dirs

    xs, ys = _block_grid(cfg, y0, rows)
    block, base = _scene_block(scene, MODEL_AXIS)
    src_pos = shadow_sources(lights, cfg)

    offsets = _subpixel_offsets(cfg)
    accum = jnp.zeros((xs.shape[0], 3), jnp.float32)
    rec_dist = jnp.full(xs.shape, _F32MAX, jnp.float32)
    for dx, dy in offsets:
        dirs = camera_ray_dirs(xs + dx, ys + dy, camera, cfg)
        t, idx, hit = _merged_intersect(
            camera.pos, dirs, block, base, cfg, MODEL_AXIS,
        )
        t_safe = jnp.where(hit, t, 0.0)
        pos = camera.pos[None, :] + t_safe[:, None] * dirs
        idx_safe = jnp.maximum(idx, 0)

        # Closest Euclidean distance record across sub-rays (feeds DoF,
        # `raytracer.cpp:242,249`).
        dist = jnp.where(hit, t_safe * jnp.linalg.norm(dirs, axis=-1),
                         _F32MAX)
        rec_dist = jnp.minimum(rec_dist, dist)

        occ_rows = _merged_occlusion_rows(pos, block, src_pos, cfg,
                                          MODEL_AXIS)
        direct = direct_light(pos, idx_safe, scene, lights, cfg,
                              occlusion_rows=occ_rows)
        albedo = scene.color[idx_safe]
        accum = accum + composite(direct, albedo, hit, cfg)
    fd = jnp.where(rec_dist < _F32MAX, rec_dist - camera.dof_focus, 0.0)
    return accum / jnp.float32(len(offsets)), fd


def _soft_combine(vals, m, s, bg_logit, axis_name):
    """Combine per-model-shard online-softmax partials into globally
    normalized values.

    Each shard aggregated its OWN triangle block's hypotheses PLUS the
    shared background hypothesis (value 0, logit `bg_logit`) into
    (vals_i = acc_i / s_i, m_i, s_i) — so the true per-shard mass is
    S_i = s_i * exp(m_i) and the combined denominator counts the
    background nm times; subtract the nm - 1 duplicates. The global max
    M is stop-gradded (any shift gives the same value AND gradient; the
    s-cotangent carries the full logit dependence).
    vals: (P, K); m, s: (P, 1). Returns (P, K) normalized.
    """
    nm = jax.lax.axis_size(axis_name)
    ms = jax.lax.all_gather(jax.lax.stop_gradient(m), axis_name)
    M = jnp.max(ms, axis=0)  # (P, 1)
    w = s * jnp.exp(m - M)
    num = jax.lax.psum(vals * w, axis_name)
    den = jax.lax.psum(w, axis_name)
    den = den - jnp.float32(nm - 1) * jnp.exp(jnp.float32(bg_logit) - M)
    return num / den


def soft_raster_block(scene: Scene, camera: Camera, lights: Lights,
                      cfg: RenderConfig, y0, rows: int) -> jax.Array:
    """Soft-rasterize a row block inside shard_map (data+model sharded).

    The silhouette-gradient renderer (BASELINE config 4) on a mesh:
    pixels shard over 'data' rows; triangles shard over 'model', each
    shard running the single-device soft z-buffer sweep
    (render.soft.rasterize_soft_partials) on its block and the global
    soft-z softmax merging via _soft_combine (the smooth analog of
    raster_block's hard max-zinv merge). Returns (rows * W, 3) with
    end-to-end gradients (vertices, colors, camera, lights).
    """
    from raytpu.render.soft import rasterize_soft_partials, shade_agg_raster

    block, _ = _scene_block(scene, MODEL_AXIS)
    xs, ys = _block_grid(cfg, y0, rows)
    agg, m, s = rasterize_soft_partials(jnp.stack([xs, ys], axis=-1),
                                        block, camera, cfg)
    # Background logit 0 (`rasteriser.cpp:188` cleared-to-0 depth buffer).
    out = _soft_combine(agg, m[:, None], s[:, None], 0.0, MODEL_AXIS)
    return shade_agg_raster(out[:, 0:3], out[:, 3:6], out[:, 6],
                            out[:, 7:10], camera, lights,
                            float(cfg.ambient))


def soft_raytrace_block(scene: Scene, camera: Camera, lights: Lights,
                        cfg: RenderConfig, y0, rows: int) -> jax.Array:
    """Soft-raytrace a row block inside shard_map (data+model sharded).

    Primary softmin-over-depth partials (render.soft.
    raytrace_soft_partials on this shard's triangle block) merge via
    _soft_combine; the shadow optical depth is a plain sum over
    triangles, so the per-shard depths merge with a psum over 'model'
    before the transmittance. Returns (rows * W, 3).
    """
    from raytpu.render.raytrace import camera_ray_dirs
    from raytpu.render.soft import (
        raytrace_soft_partials,
        shade_agg_raytrace,
        shadow_transmittance,
        soft_optical_depth,
    )

    block, _ = _scene_block(scene, MODEL_AXIS)
    xs, ys = _block_grid(cfg, y0, rows)
    dirs = camera_ray_dirs(xs, ys, camera, cfg)
    agg, m, s = raytrace_soft_partials(dirs, camera.pos, block, cfg)
    # Background logit 0 (bounded-background relaxation — the raytrace
    # analog of the rasterizer's cleared-to-0 depth buffer).
    comb = _soft_combine(agg, m[:, None], s[:, None], 0.0, MODEL_AXIS)
    alb, world, nrm = comb[:, 0:3], comb[:, 3:6], comb[:, 6:9]

    od = jax.lax.psum(
        soft_optical_depth(world, block, shadow_sources(lights, cfg), cfg),
        MODEL_AXIS)
    shadow = shadow_transmittance(od, lights, cfg)
    return shade_agg_raytrace(alb, world, nrm, lights, float(cfg.ambient),
                              shadow)


def make_sharded_soft_render(mesh, cfg: RenderConfig,
                             renderer: str = "rasterize"):
    """jit-compiled sharded soft (differentiable) forward render:
    (H, W, 3) sharded row-wise over 'data', triangle hypotheses sharded
    over 'model' with softmax/optical-depth merges. renderer: 'rasterize'
    or 'raytrace'."""
    nd = mesh.shape[DATA_AXIS]
    if cfg.height % nd != 0:
        raise ValueError(f"height {cfg.height} not divisible by {nd}")
    rows = cfg.height // nd
    block_fn = (soft_raster_block if renderer == "rasterize"
                else soft_raytrace_block)

    def _block(scene, camera, lights):
        di = jax.lax.axis_index(DATA_AXIS)
        color = block_fn(scene, camera, lights, cfg, di * rows, rows)
        return color.reshape(rows, cfg.width, 3)

    smapped = shard_map(
        _block,
        mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=P(DATA_AXIS, None, None),
        check_vma=False,
    )
    return jax.jit(smapped)


class TrainState(NamedTuple):
    scene: Scene
    lights: Lights
    opt_state: object


def dof_block(img_block, fd_block, cfg: RenderConfig, global_h: int, y0,
              axis_name: str = DATA_AXIS):
    """Clean DoF blur on a row-sharded image via a halo exchange.

    The 8x8 window (rows [-K/2, K/2-1] around each pixel, ops/blur.py)
    needs K/2 rows from the previous row shard and K/2-1 from the next:
    exchanged with two `ppermute`s. Non-participating edges of a
    non-cyclic ppermute receive ZEROS — exactly dof_blur's zero padding,
    so shard boundaries blur identically to the single-device path.
    img_block: (rows, W, 3); fd_block: (rows, W). The center-pixel weights
    depend only on LOCAL focal distances — no fd halo needed.
    """
    if not cfg.dof_enabled:
        return img_block
    from raytpu.ops.blur import _interior_mask, _weights

    k = cfg.dof_kernel_size
    lo = k // 2          # rows needed from the previous shard
    hi = k - lo - 1      # rows needed from the next shard
    rows, w, _ = img_block.shape
    if rows < max(lo, hi):
        raise ValueError(
            f"row shard of {rows} smaller than the DoF halo {max(lo, hi)}"
        )
    n = jax.lax.axis_size(axis_name)

    down = [(j, j + 1) for j in range(n - 1)]  # shard j -> j+1
    up = [(j + 1, j) for j in range(n - 1)]    # shard j+1 -> j
    top_halo = jax.lax.ppermute(img_block[-lo:], axis_name, down)
    bot_halo = jax.lax.ppermute(img_block[:hi], axis_name, up)
    ext = jnp.concatenate([top_halo, img_block, bot_halo], axis=0)

    box = jax.lax.reduce_window(
        ext, 0.0, jax.lax.add,
        window_dimensions=(k, k, 1), window_strides=(1, 1, 1),
        padding=((0, 0), (lo, hi), (0, 0)),
    )  # (rows, W, 3)
    w_center, w_other = _weights(fd_block, k)
    out = w_center[..., None] * img_block + w_other[..., None] * (
        box - img_block
    )
    # Global 1-px border blanking (`raytracer.cpp:618-620`): rebuild the
    # full-image interior mask rows for this shard.
    full = _interior_mask(global_h, w)
    mask = jax.lax.dynamic_slice_in_dim(full, y0, rows, axis=0)
    return out * mask[..., None]


def make_sharded_render(mesh, cfg: RenderConfig, with_dof: bool = True):
    """jit-compiled sharded forward render: returns (H, W, 3) image sharded
    row-wise over the data axis. Supports the full clean feature set (AA,
    soft shadows, multi-light, DoF-with-halo-exchange)."""
    nd = mesh.shape[DATA_AXIS]
    if cfg.height % nd != 0:
        raise ValueError(f"height {cfg.height} not divisible by {nd}")
    rows = cfg.height // nd

    def _block(scene, camera, lights):
        di = jax.lax.axis_index(DATA_AXIS)
        color, fd = render_block(scene, camera, lights, cfg,
                                 di * rows, rows)
        img = color.reshape(rows, cfg.width, 3)
        if with_dof and cfg.dof_enabled:
            fd = fd.reshape(rows, cfg.width)
            img = dof_block(img, fd, cfg, cfg.height, di * rows)
        return img

    smapped = shard_map(
        _block,
        mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=P(DATA_AXIS, None, None),
        check_vma=False,
    )
    return jax.jit(smapped)


def raster_block(scene: Scene, camera: Camera, lights: Lights,
                 cfg: RenderConfig, y0, rows: int) -> jax.Array:
    """Rasterize a row block inside shard_map (data+model sharded).

    'clean'-mode (float-precise) rasterization: pixels are sharded over
    'data' rows; the O(pixels x triangles) winner resolve runs on each
    device's triangle block only, and the global winner is the max-zinv
    merge over the model axis with the reference's first-triangle-wins
    tie rule (strict > z-test, `rasteriser.cpp:606`). The O(T) vertex
    stage and the winner shading use the replicated scene.
    Returns (rows * W, 3).
    """
    from raytpu.render.soft import _fields_for, _screen_vertices, _shade_winner

    sx, sy, zinv, pos3d = _screen_vertices(scene, camera, cfg)
    # Same culling as single-chip rasterize_exact (backface Z5 honored
    # under sharding; frustum Z6 stays parity-only — see rasterize_exact).
    # O(T) on the replicated scene, piecewise-constant.
    from raytpu.ops.raster import cull_mask as _hard_cull

    keep = jax.lax.stop_gradient(
        _hard_cull(scene, camera, cfg.replace(frustum_cull=False)))
    xs, ys = _block_grid(cfg, y0, rows)

    mi = jax.lax.axis_index(MODEL_AXIS)
    nm = jax.lax.axis_size(MODEL_AXIS)
    T = scene.num_triangles
    if T % nm != 0:
        raise ValueError(
            f"triangle count {T} not divisible by model axis {nm}"
        )
    tb = T // nm
    base = mi * tb

    def sl(a):
        return jax.lax.dynamic_slice_in_dim(a, base, tb, axis=0)

    p = jnp.stack([xs, ys], axis=-1)
    sdist, zpx, _, area_ok = _fields_for(
        p, sl(sx), sl(sy), sl(zinv), sl(pos3d)
    )
    covered = (
        (sdist >= 0.0) & (sl(keep)[None, :] > 0.0) & (zpx > 0.0)
        & area_ok[None, :]
    )
    z_masked = jnp.where(covered, zpx, 0.0)
    win_local = jnp.argmax(z_masked, axis=1).astype(jnp.int32)
    z_local = jnp.take_along_axis(z_masked, win_local[:, None], axis=1)[:, 0]
    win_local = jnp.where(z_local > 0.0, win_local, -1)

    win_global = jnp.where(win_local >= 0, win_local + base, -1)
    zs = jax.lax.all_gather(
        jax.lax.stop_gradient(z_local), MODEL_AXIS
    )  # (nm, R)
    idxs = jax.lax.all_gather(win_global, MODEL_AXIS)
    best_z = zs[0]
    best_idx = idxs[0]
    for m in range(1, zs.shape[0]):
        upd = zs[m] > best_z  # strictly: earlier (lower-index) block keeps
        best_z = jnp.where(upd, zs[m], best_z)
        best_idx = jnp.where(upd, idxs[m], best_idx)
    winner = jnp.where(best_z > 0.0, best_idx, -1)

    return _shade_winner(winner, xs, ys, sx, sy, zinv, pos3d, scene,
                         camera, lights, cfg)


def make_sharded_rasterize(mesh, cfg: RenderConfig):
    """jit-compiled sharded clean rasterizer: (H, W, 3) image sharded
    row-wise over 'data', winner resolve sharded over 'model'."""
    nd = mesh.shape[DATA_AXIS]
    if cfg.height % nd != 0:
        raise ValueError(f"height {cfg.height} not divisible by {nd}")
    rows = cfg.height // nd

    def _block(scene, camera, lights):
        di = jax.lax.axis_index(DATA_AXIS)
        color = raster_block(scene, camera, lights, cfg, di * rows, rows)
        return color.reshape(rows, cfg.width, 3)

    smapped = shard_map(
        _block,
        mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=P(DATA_AXIS, None, None),
        check_vma=False,
    )
    return jax.jit(smapped)


def make_sharded_train_step(mesh, cfg: RenderConfig, optimizer,
                            renderer: str = "raytrace"):
    """Sharded inverse-rendering train step (BASELINE configs 4/5).

    params = (scene, lights) replicated; target (H, W, 3) sharded over rows.
    loss = mean squared error to the target image. cfg.mode == 'soft'
    trains through the sharded SOFT renderer (silhouette gradients on a
    mesh); other modes through the hard clean path. renderer selects
    'raytrace' or 'rasterize' in soft mode. Returns (train_step, loss_fn)
    — both jit-compiled for the mesh.
    """
    nd = mesh.shape[DATA_AXIS]
    if cfg.height % nd != 0:
        raise ValueError(f"height {cfg.height} not divisible by {nd}")
    rows = cfg.height // nd
    denom = jnp.float32(cfg.height * cfg.width * 3)
    soft = cfg.mode == "soft"
    soft_fn = (soft_raster_block if renderer == "rasterize"
               else soft_raytrace_block)

    def _local_loss(scene, lights, camera, target_block):
        di = jax.lax.axis_index(DATA_AXIS)
        if soft:
            color = soft_fn(scene, camera, lights, cfg, di * rows, rows)
            img_block = color.reshape(rows, cfg.width, 3)
        else:
            color, fd = render_block(scene, camera, lights, cfg,
                                     di * rows, rows)
            img_block = color.reshape(rows, cfg.width, 3)
            if cfg.dof_enabled:
                img_block = dof_block(img_block,
                                      fd.reshape(rows, cfg.width),
                                      cfg, cfg.height, di * rows)
        l = jnp.sum((img_block - target_block) ** 2)
        l = jax.lax.psum(l, DATA_AXIS) / denom
        l = jax.lax.pmean(l, MODEL_AXIS)
        return l

    smapped = shard_map(
        _local_loss,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(DATA_AXIS, None, None)),
        out_specs=P(),
        check_vma=False,
    )

    def loss_fn(params, camera, target):
        scene, lights = params
        return smapped(scene, lights, camera, target)

    @jax.jit
    def train_step(state: TrainState, camera: Camera, target):
        params = (state.scene, state.lights)
        loss, grads = jax.value_and_grad(loss_fn)(params, camera, target)
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              params)
        import optax

        scene, lights = optax.apply_updates(params, updates)
        return TrainState(scene=scene, lights=lights,
                          opt_state=opt_state), loss

    return train_step, jax.jit(loss_fn)
