"""Card-only checks: the main path compiled for the GPU agrees with the
same functions on the CPU device. Marked `gpu`; the `gpu_device` fixture
skips them where JAX finds no GPU. `python chip_smoke.py` runs them on
the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytpu.core.cornell import cornell_box
from raytpu.core.image import quantize_u8
from raytpu.core.types import Camera, Lights, RenderConfig
from raytpu.render.raytrace import raytrace_full
from raytpu.render.soft import rasterize_soft, raytrace_soft

pytestmark = pytest.mark.gpu

SIZE = 64


def _on(device, fn, *args):
    return jax.device_get(fn(*jax.device_put(args, device)))


@pytest.mark.parametrize("mode", ["parity", "clean"])
def test_hard_raytrace_gpu_matches_cpu(gpu_device, mode):
    cfg = RenderConfig(width=SIZE, height=SIZE, mode=mode, aa_samples=2,
                       soft_shadow_samples=4)
    fn = jax.jit(lambda s, c, l: raytrace_full(s, c, l, cfg).image)
    args = (cornell_box(pad_to=32), Camera.raytracer_default(),
            Lights.single(capacity=1, soft_samples=4))
    img_g = _on(gpu_device, fn, *args)
    with jax.default_matmul_precision("highest"):
        img_c = _on(jax.devices("cpu")[0], fn, *args)
    d = np.abs(quantize_u8(img_g).astype(int)
               - quantize_u8(img_c).astype(int)).max(axis=-1)
    # A winner can flip at a silhouette where the two backends contract
    # FMAs differently; everything else agrees to a u8 step.
    assert (d <= 1).mean() >= 0.999, f"{(d > 1).sum()} pixels differ"


@pytest.mark.parametrize("renderer", ["raytrace", "rasterize"])
def test_soft_grads_gpu_match_cpu(gpu_device, renderer):
    render, cam = ((raytrace_soft, Camera.raytracer_default())
                   if renderer == "raytrace"
                   else (rasterize_soft, Camera.rasterizer_default()))
    cfg = RenderConfig(width=SIZE, height=SIZE, mode="soft",
                       soft_edge_sharpness=40.0, soft_z_sharpness=40.0)
    w = jnp.asarray(np.random.default_rng(0).normal(size=(SIZE, SIZE, 3)),
                    jnp.float32)

    def loss(s, l, c, w):
        return jnp.mean(render(s, c, l, cfg) * w)

    fn = jax.jit(jax.grad(loss, argnums=(0, 1)))
    args = (cornell_box(pad_to=32), Lights.single(capacity=1), cam, w)
    g_g = _on(gpu_device, fn, *args)
    with jax.default_matmul_precision("highest"):
        g_c = _on(jax.devices("cpu")[0], fn, *args)
    for a, b in zip(jax.tree_util.tree_leaves(g_g),
                    jax.tree_util.tree_leaves(g_c)):
        scale = max(float(np.abs(b).max()), 1e-12)
        assert np.isfinite(a).all()
        assert float(np.abs(a - b).max()) / scale <= 1e-3
