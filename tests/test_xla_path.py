"""The hard raytrace path's multi-light / soft-shadow / AA features against
the numpy oracle and finite differences, and its triangle chunking."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytpu.core.cornell import cornell_box, cornell_box_numpy
from raytpu.core.types import Camera, Lights, RenderConfig
from raytpu.oracle import raytracer_oracle as oracle
from raytpu.ops.intersect import intersect, tri_constants
from raytpu.render.raytrace import camera_ray_dirs, pixel_grid, raytrace_full

from test_gradients import _dir_deriv_check, _setup
from test_raytrace_parity import _assert_images_match


def _lights(n_lights, samples):
    lights = Lights.single(capacity=n_lights, soft_samples=max(samples, 1))
    if n_lights > 1:
        lights = lights.add((0.4, 0.4, -0.6), (1.0, 0.8, 0.6), 8.0,
                            key=jax.random.PRNGKey(7))
    return lights


@pytest.mark.parametrize("n_lights, samples", [(1, 1), (2, 1), (1, 4)])
def test_parity_aa_matches_oracle(n_lights, samples):
    """Parity AA (each sub-ray shades the persistent record) with one
    light, two lights (run-on accumulation) and jittered soft shadows."""
    lights = _lights(n_lights, samples)
    size = 32
    cfg = RenderConfig(width=size, height=size, aa_samples=3,
                       soft_shadow_samples=samples)
    img = np.asarray(raytrace_full(cornell_box(), Camera.raytracer_default(),
                                   lights, cfg).image)
    ref, _ = oracle.render(
        cornell_box_numpy(), width=size, height=size, aa_samples=3,
        light_positions=np.asarray(lights.position),
        light_colors=np.asarray(lights.color),
        light_intensities=np.asarray(lights.intensity),
        soft_positions=(np.asarray(lights.jitter) if samples > 1 else None))
    _assert_images_match(img, ref, u8_frac=0.99)


@pytest.mark.parametrize("n_lights, samples", [(1, 1), (2, 1), (1, 4),
                                               (2, 4)])
def test_light_grads_match_finite_differences(n_lights, samples):
    """Light color and intensity gradients through every shadow source
    (clean mode, one occlusion mask per source).
    Positions move shadow boundaries, where central differences straddle
    the discontinuity; test_gradients covers them on one light."""
    scene, cam, _, w = _setup()
    lights = _lights(n_lights, samples)
    cfg = RenderConfig(width=w.shape[0], height=w.shape[1], mode="clean",
                       soft_shadow_samples=samples)

    def img_fn(x):
        l2 = Lights(position=lights.position, color=x["color"],
                    intensity=x["intensity"], mask=lights.mask,
                    jitter=lights.jitter)
        return raytrace_full(scene, cam, l2, cfg).image

    x = {"color": lights.color, "intensity": lights.intensity}
    err = _dir_deriv_check(img_fn, x, w, key=3, eps=3e-3)
    assert err < 1e-3, f"rel err {err:.2e}"


@pytest.mark.parametrize("tri_chunk", [8, 16])
def test_chunked_intersect_matches_single_chunk(tri_chunk):
    """The lax.scan over triangle chunks (last-wins ties across chunks)
    gives the single-chunk closest hit: same winners, t to 1 ulp."""
    scene = cornell_box(pad_to=32)
    cam = Camera.raytracer_default()
    cfg = RenderConfig(width=32, height=32)
    xs, ys = pixel_grid(cfg)
    dirs = camera_ray_dirs(xs, ys, cam, cfg)
    consts = tri_constants(scene, cam.pos)
    one = intersect(dirs, consts, tri_chunk=512)
    many = intersect(dirs, consts, tri_chunk=tri_chunk)
    np.testing.assert_array_equal(np.asarray(many.idx), np.asarray(one.idx))
    # XLA fuses the scan body and the single chunk differently: 1 ulp.
    np.testing.assert_allclose(np.asarray(many.t), np.asarray(one.t),
                               rtol=5e-7)
    assert np.asarray(one.hit).all()


def test_chunked_render_matches_default():
    scene = cornell_box(pad_to=32)
    lights = _lights(2, 4)
    cfg = RenderConfig(width=24, height=24, mode="clean",
                       soft_shadow_samples=4, aa_samples=2)
    ref = raytrace_full(scene, Camera.raytracer_default(), lights, cfg)
    out = raytrace_full(scene, Camera.raytracer_default(), lights,
                        cfg.replace(tri_chunk=8))
    np.testing.assert_allclose(np.asarray(out.image), np.asarray(ref.image),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.focal_distances),
                               np.asarray(ref.focal_distances), atol=1e-6)
    assert float(jnp.max(ref.image)) > 0.1
