"""The factored soft sweeps (render.soft *_partials, soft_optical_depth)
against an unfactored dense softmax over every hypothesis at once, and
the merge algebra the model-sharded path relies on."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytpu.core.cornell import cornell_box
from raytpu.core.types import Camera, Lights, RenderConfig, Scene
from raytpu.ops.shade import shadow_sources
from raytpu.render import soft
from raytpu.render.raytrace import camera_ray_dirs, pixel_grid

SIZE = 20
CFG = RenderConfig(width=SIZE, height=SIZE, mode="soft",
                   soft_edge_sharpness=30.0, soft_z_sharpness=30.0)


def _scene():
    return cornell_box(pad_to=32)


def _slice(scene, lo, hi):
    return jax.tree_util.tree_map(lambda a: a[lo:hi], scene)


def _dense_raytrace(scene, cam):
    """Same logits as raytrace_soft_partials, one softmax over all T."""
    xs, ys = pixel_grid(CFG)
    dirs = camera_ray_dirs(xs, ys, cam, CFG)
    t, u, v, denom, nmag = soft._ray_tri_tuv(
        dirs, scene.v0, scene.v1, scene.v2, cam.pos)
    dnorm = jnp.linalg.norm(dirs, axis=-1)
    fwd_ok = (t > 1e-6) & (
        jnp.abs(denom) > soft._DENOM_EPS * dnorm[:, None] * nmag[None, :])
    cen = (scene.v0 + scene.v1 + scene.v2) / 3.0
    r2t = jnp.maximum(jnp.maximum(jnp.sum((scene.v0 - cen) ** 2, -1),
                                  jnp.sum((scene.v1 - cen) ** 2, -1)),
                      jnp.sum((scene.v2 - cen) ** 2, -1))
    dmin = jnp.maximum(jnp.linalg.norm(cen - cam.pos, axis=-1)
                       - jnp.sqrt(r2t + 1e-20), 0.0)
    zinv = 1.0 / jnp.maximum(jnp.maximum(t * dnorm[:, None], dmin[None]),
                             soft._T_NEAR)
    margin = jnp.minimum(jnp.minimum(u, v), 1.0 - u - v)
    logit = (CFG.soft_z_sharpness * jnp.where(fwd_ok, zinv, 0.0)
             + jax.nn.log_sigmoid(CFG.soft_edge_sharpness * margin)
             + jnp.log(scene.active[None, :] + 1e-20))
    logit = jnp.where(fwd_ok, logit, -1e30)
    tp = jnp.where(fwd_ok, t, 0.0)
    pos = cam.pos + tp[..., None] * dirs[:, None, :]
    nrm = jnp.broadcast_to(scene.normals()[None], pos.shape)
    alb = jnp.broadcast_to(scene.color[None], pos.shape)
    num = jnp.concatenate([alb, pos, nrm], axis=-1)
    return _dense_softmax(logit, num)


def _dense_raster(scene, cam):
    sx, sy, zinv, pos3d = soft._screen_vertices(scene, cam, CFG)
    sdist, zpx, ppx, area_ok = soft._fields_for(
        soft._pixel_centers(CFG), sx, sy, zinv, pos3d)
    mask = scene.active * area_ok.astype(jnp.float32)
    logit = (CFG.soft_z_sharpness * zpx
             + jax.nn.log_sigmoid(CFG.soft_edge_sharpness * sdist)
             + jnp.log(mask[None, :] + 1e-20))
    alb = jnp.broadcast_to(scene.color[None], ppx.shape)
    nrm = jnp.broadcast_to(scene.normals()[None], ppx.shape)
    num = jnp.concatenate([alb, ppx, zpx[..., None], nrm], axis=-1)
    return _dense_softmax(logit, num)


def _dense_softmax(logit, num):
    """Softmax over [background (logit 0, zero value)] + T hypotheses."""
    logit = np.asarray(logit, np.float64)
    num = np.asarray(num, np.float64)
    m = np.maximum(logit.max(axis=1), 0.0)
    w = np.exp(logit - m[:, None])
    s = np.exp(-m) + w.sum(axis=1)
    return np.einsum("rc,rcd->rd", w, num) / s[:, None]


def _partials(renderer, scene, cam, cfg=CFG):
    if renderer == "raytrace":
        xs, ys = pixel_grid(cfg)
        return soft.raytrace_soft_partials(
            camera_ray_dirs(xs, ys, cam, cfg), cam.pos, scene, cfg)
    return soft.rasterize_soft_partials(soft._pixel_centers(cfg), scene,
                                        cam, cfg)


def _cam(renderer):
    return (Camera.raytracer_default() if renderer == "raytrace"
            else Camera.rasterizer_default())


@pytest.mark.parametrize("renderer", ["raytrace", "rasterize"])
@pytest.mark.parametrize("chunk", [4, 64])
def test_partials_match_dense_softmax(renderer, chunk):
    """Streaming over chunks of `chunk` triangles == one dense softmax."""
    scene, cam = _scene(), _cam(renderer)
    agg, m, s = _partials(renderer, scene, cam,
                          CFG.replace(raster_tri_chunk=chunk))
    dense = (_dense_raytrace if renderer == "raytrace"
             else _dense_raster)(scene, cam)
    np.testing.assert_allclose(np.asarray(agg), dense, atol=2e-5,
                               rtol=1e-4)
    assert np.all(np.asarray(m) >= 0.0)  # background logit 0 is in m
    assert np.all(np.asarray(s) >= 1.0 - 1e-6)  # the max term is exp(0)


@pytest.mark.parametrize("renderer", ["raytrace", "rasterize"])
def test_split_partials_merge_to_full(renderer):
    """Two triangle blocks, each with its own background hypothesis,
    merged the way parallel.render._soft_combine does, give the
    full-scene aggregate."""
    scene, cam = _scene(), _cam(renderer)
    full, _, _ = _partials(renderer, scene, cam)
    parts = [_partials(renderer, _slice(scene, lo, lo + 16), cam)
             for lo in (0, 16)]
    ms = np.stack([np.asarray(p[1], np.float64) for p in parts])
    M = ms.max(axis=0)
    ws = [np.asarray(p[2], np.float64) * np.exp(np.asarray(p[1]) - M)
          for p in parts]
    num = sum(np.asarray(p[0], np.float64) * w[:, None]
              for p, w in zip(parts, ws))
    den = sum(ws) - 1.0 * np.exp(-M)  # the background counted twice
    np.testing.assert_allclose(num / den[:, None], np.asarray(full),
                               atol=2e-5, rtol=1e-4)


def test_optical_depth_is_additive_over_triangle_blocks():
    scene = _scene()
    lights = Lights.single(capacity=2, soft_samples=3)
    cfg = CFG.replace(soft_shadow_samples=3)
    world = jnp.asarray(np.random.default_rng(0).uniform(
        -0.9, 0.9, (50, 3)), jnp.float32)
    src = shadow_sources(lights, cfg)
    od = soft.soft_optical_depth(world, scene, src, cfg)
    assert od.shape == (6, 50)
    halves = sum(soft.soft_optical_depth(world, _slice(scene, lo, lo + 16),
                                         src, cfg) for lo in (0, 16))
    np.testing.assert_allclose(np.asarray(halves), np.asarray(od),
                               rtol=1e-5, atol=1e-6)
    assert float(od.max()) > 1.0  # some points really are occluded


def test_shadow_transmittance_weights_lights_and_samples():
    lights = Lights.single(capacity=2, soft_samples=2)  # slot 1 inactive
    cfg = CFG.replace(soft_shadow_samples=2)
    od = jnp.asarray([[0.0, 1.0], [0.0, 0.0],   # light 0, samples 0-1
                      [5.0, 5.0], [5.0, 5.0]])  # inactive light 1
    t = np.asarray(soft.shadow_transmittance(od, lights, cfg))
    e = np.exp(-soft._OD_SCALE)
    np.testing.assert_allclose(t, [1.0, (e + 1.0) / 2.0], rtol=1e-6)


def test_shadow_sources_order_is_light_major():
    lights = Lights.single(capacity=2, soft_samples=4).add(
        (0.4, 0.4, -0.6), (1.0, 1.0, 1.0), 8.0, key=jax.random.PRNGKey(7))
    src = np.asarray(shadow_sources(lights, CFG.replace(
        soft_shadow_samples=3)))
    jit = np.asarray(lights.jitter)
    np.testing.assert_array_equal(src, jit[:, :3].reshape(-1, 3))
    np.testing.assert_array_equal(
        np.asarray(shadow_sources(lights, CFG)), np.asarray(lights.position))


@pytest.mark.parametrize("renderer", ["raytrace", "rasterize"])
def test_zero_triangles_render_background(renderer):
    """T == 0 still runs one all-inactive chunk: the background (black)."""
    empty = jnp.zeros((0, 3), jnp.float32)
    scene = Scene(v0=empty, v1=empty, v2=empty, color=empty,
                  active=jnp.zeros((0,), jnp.float32))
    render = (soft.raytrace_soft if renderer == "raytrace"
              else soft.rasterize_soft)
    img = np.asarray(render(scene, _cam(renderer), Lights.single(capacity=2),
                            CFG))
    assert img.shape == (SIZE, SIZE, 3)
    np.testing.assert_array_equal(img, 0.0)


def test_sharded_block_matches_single_device_partials():
    """soft_raytrace_block on a (1, 4) mesh == raytrace_soft (the block
    runs the single-device partials and merges them)."""
    from raytpu.parallel.mesh import make_mesh
    from raytpu.parallel.render import make_sharded_soft_render

    scene, cam = _scene(), _cam("raytrace")
    lights = Lights.single(capacity=1, soft_samples=2)
    cfg = CFG.replace(soft_shadow_samples=2)
    mesh = make_mesh(data=1, model=4, devices=jax.devices()[:4])
    img = make_sharded_soft_render(mesh, cfg, "raytrace")(scene, cam, lights)
    ref = soft.raytrace_soft(scene, cam, lights, cfg)
    np.testing.assert_allclose(np.asarray(img), np.asarray(ref), atol=1e-5,
                               rtol=1e-4)
