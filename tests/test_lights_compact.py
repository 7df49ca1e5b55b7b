"""Lights.compact(): render cost scales with ACTIVE lights, results exact.

The shadow sweeps and the shading loop unroll over light CAPACITY
(default bank = 32 slots), so a single light would pay 32 shadow sweeps
and a 32-light shading loop. compact() strips inactive slots at the
host boundary; these tests pin the semantics.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from raytpu.core.cornell import cornell_box
from raytpu.core.types import Camera, Lights, RenderConfig
from raytpu.render.raytrace import raytrace_full

SIZE = 24


def test_compact_strips_inactive_slots():
    lights = Lights.single(capacity=32)
    c = lights.compact()
    assert c.capacity == 1
    np.testing.assert_array_equal(c.position[0], lights.position[0])
    np.testing.assert_array_equal(c.jitter[0], lights.jitter[0])
    assert float(c.mask[0]) == 1.0


def test_compact_preserves_order_with_holes():
    """Active slots keep their relative order when an inactive slot sits
    between them (parity run-on accumulation depends on order)."""
    l = Lights.empty(capacity=4)
    l = l.add((0.0, -0.5, -0.7), (1.0, 1.0, 1.0), 14.0,
              key=jax.random.PRNGKey(0))
    l = l.add((0.3, 0.0, -0.5), (1.0, 0.5, 0.5), 7.0,
              key=jax.random.PRNGKey(1))
    l = l.add((0.0, 0.4, -0.2), (0.2, 0.2, 1.0), 5.0,
              key=jax.random.PRNGKey(2))
    # Punch a hole in the middle slot.
    l = dataclasses.replace(l, mask=l.mask.at[1].set(0.0))
    c = l.compact()
    assert c.capacity == 2
    np.testing.assert_array_equal(np.asarray(c.position),
                                  np.asarray(l.position)[[0, 2]])


def test_compact_render_equivalence_parity_and_clean():
    """capacity-32 bank with holes renders identically to its compaction
    (including the parity multi-light run-on quirk)."""
    scene = cornell_box()
    cam = Camera.raytracer_default()
    cam = dataclasses.replace(cam, focal=jnp.float32(SIZE / 2.0))
    l = Lights.empty(capacity=8)
    l = l.add((0.0, -0.5, -0.7), (1.0, 1.0, 1.0), 14.0,
              key=jax.random.PRNGKey(0))
    l = l.add((0.3, 0.2, -0.5), (1.0, 0.6, 0.4), 6.0,
              key=jax.random.PRNGKey(1))
    for mode in ("parity", "clean"):
        cfg = RenderConfig(width=SIZE, height=SIZE, mode=mode)
        img_full = np.asarray(raytrace_full(scene, cam, l, cfg).image)
        img_comp = np.asarray(
            raytrace_full(scene, cam, l.compact(), cfg).image
        )
        np.testing.assert_array_equal(img_full, img_comp)


def test_compact_noop_under_tracing():
    """Inside jit/grad the mask is abstract — compact must be the identity
    (shapes preserved, grads flow to the original bank)."""
    lights = Lights.single(capacity=4)

    @jax.jit
    def f(l):
        c = l.compact()
        assert c.capacity == 4  # runs at trace time
        return jnp.sum(c.position * c.mask[:, None])

    g = jax.grad(lambda l: f(l))(lights)
    assert g.position.shape == (4, 3)
    assert bool(jnp.all(jnp.isfinite(g.position)))
