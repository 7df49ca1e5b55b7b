"""STL loader and starfield demo coverage."""

import os

import jax
import numpy as np
import pytest

from raytpu.core.starfield import (
    bilinear_fill,
    draw_stars,
    init_stars,
    interpolate,
    update_stars,
)
from raytpu.core.stl import (
    REFERENCE_MODEL,
    load_reference_model,
    load_stl,
    morton_order,
    parse_ascii_stl,
)

TINY_STL = """solid tiny
 facet normal 0 0 1
  outer loop
   vertex 0 0 0
   vertex 10 0 0
   vertex 0 10 0
  endloop
 endfacet
 facet normal 0 0 1
  outer loop
   vertex 1 1 1
   vertex 2 2 2
   vertex 3 3 3
  endloop
 endfacet
endsolid tiny
"""


def test_parse_tiny(tmp_path):
    tris = parse_ascii_stl(TINY_STL)
    assert tris.shape == (2, 3, 3)
    np.testing.assert_array_equal(tris[0, 1], [10, 0, 0])

    path = tmp_path / "t.stl"
    path.write_text(TINY_STL)
    scene = load_stl(str(path))
    # scale -0.05 on every axis (`LoadSTL.cpp:64-77`)
    np.testing.assert_allclose(np.asarray(scene.v1)[0], [-0.5, 0, 0])
    np.testing.assert_array_equal(
        np.asarray(scene.color)[0], np.float32([0.5, 0.5, 0.5])
    )


def test_parse_garbage_raises(tmp_path):
    path = tmp_path / "bad.stl"
    path.write_bytes(b"\x00\x01binarygarbage")
    with pytest.raises(ValueError):
        load_stl(str(path))


@pytest.mark.skipif(
    not os.path.exists(REFERENCE_MODEL), reason="reference STL not mounted"
)
def test_reference_model():
    scene = load_reference_model()
    # 9,028 triangles (SURVEY.md §2 Z7).
    assert scene.num_triangles == 9028
    v = np.asarray(scene.v0)
    assert np.isfinite(v).all()
    padded = load_reference_model(pad_to=9216)
    assert padded.num_triangles == 9216


@pytest.mark.skipif(
    not os.path.exists(REFERENCE_MODEL), reason="reference STL not mounted"
)
def test_render_stl_scene():
    """The 9k-triangle model renders through the chunked raytracer."""
    from raytpu.core.types import Camera, Lights, RenderConfig
    from raytpu.render.raytrace import raytrace_full

    scene = load_reference_model(pad_to=9216)
    cam = Camera.make((0.0, -0.5, -5.0), focal=32.0)  # `rasteriser.cpp:109`
    cfg = RenderConfig(width=32, height=32, mode="clean", tri_chunk=512)
    out = raytrace_full(scene, cam, Lights.single(capacity=1), cfg)
    img = np.asarray(out.image)
    assert np.isfinite(img).all()
    assert (img.sum(-1) > 0).any()


def test_morton_order_is_permutation_and_localizes():
    """Random triangles in four well-separated clusters: the Morton sort
    is a permutation and shrinks the summed bounding radii of 64-triangle
    chunks against a shuffled order."""
    rng = np.random.default_rng(0)
    centers = np.array([(0, 0, 10), (40, 0, 14), (-40, 30, 18),
                        (0, -35, 22)], np.float32)
    a = (np.repeat(centers, 128, axis=0)
         + rng.normal(scale=0.6, size=(512, 3))).astype(np.float32)
    v0 = a
    v1 = a + rng.normal(scale=0.3, size=a.shape).astype(np.float32)
    v2 = a + rng.normal(scale=0.3, size=a.shape).astype(np.float32)
    perm = morton_order(v0, v1, v2)
    assert sorted(perm.tolist()) == list(range(512))

    def total_radius(order):
        verts = np.stack([v0[order], v1[order], v2[order]], axis=1)
        chunks = verts.reshape(-1, 64 * 3, 3)
        centre = chunks.mean(axis=1, keepdims=True)
        return float(np.linalg.norm(chunks - centre, axis=-1).max(1).sum())

    assert total_radius(perm) < total_radius(rng.permutation(512))


def test_starfield():
    stars = init_stars(jax.random.PRNGKey(0))
    assert stars.shape == (1000, 3)
    s = np.asarray(stars)
    assert (s[:, 0] >= -1).all() and (s[:, 0] <= 1).all()

    stars2 = update_stars(stars, 100.0)
    z = np.asarray(stars2[:, 2])
    assert (z > 0).all() and (z <= 1).all()

    img = draw_stars(stars, width=64, height=64)
    assert img.shape == (64, 64, 3)
    assert float(img.max()) > 0


def test_interpolate_matches_reference_semantics():
    # `skeleton.cpp:151-158`: result[i] = a + i*(b-a)/(N-1)
    r = np.asarray(interpolate(0.0, 1.0, 5))
    np.testing.assert_allclose(r, [0, 0.25, 0.5, 0.75, 1.0])
    r3 = np.asarray(interpolate((0, 0, 0), (1, 2, 3), 3))
    np.testing.assert_allclose(r3[1], [0.5, 1.0, 1.5])


def test_bilinear_fill():
    img = np.asarray(
        bilinear_fill((1, 0, 0), (0, 0, 1), (1, 1, 0), (0, 1, 0), 8, 8)
    )
    np.testing.assert_allclose(img[0, 0], [1, 0, 0], atol=1e-6)
    np.testing.assert_allclose(img[0, -1], [0, 0, 1], atol=1e-6)
    np.testing.assert_allclose(img[-1, 0], [1, 1, 0], atol=1e-6)
