"""Soft-path validation on STL-loaded geometry.

The soft renderers were developed on the 32-triangle Cornell box; these
tests exercise them on a mesh that goes through the STL loader
(`rasteriser/Source/LoadSTL.cpp:17-81` semantics: ASCII facets, scale
-0.05): a seeded bumpy sphere that the tests write as an STL file
themselves. They run a finite-difference gradient check through the soft
rasterizer, a short vertex fit through BOTH soft renderers, and a
9216-triangle (padded, multi-chunk) forward + gradient sanity check.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytpu.core.stl import load_stl
from raytpu.core.types import Camera, Lights, RenderConfig
from raytpu.render.soft import rasterize_soft, raytrace_soft

from test_gradients import _dir_deriv_check

SIZE = 24


def _write_blob_stl(path, n_lat, n_lon, seed=0, radius=3.0, bump=0.15):
    """Write a seeded bumpy lat-long sphere (2 * n_lon * (n_lat - 1)
    triangles, in STL units) as an ASCII STL file."""
    rng = np.random.default_rng(seed)
    theta = np.linspace(0.0, np.pi, n_lat + 1)
    phi = np.linspace(0.0, 2.0 * np.pi, n_lon + 1)[:-1]
    r = radius * (1.0 + bump * rng.uniform(-1.0, 1.0, (n_lat + 1, n_lon)))
    r[0, :] = r[0, 0]
    r[-1, :] = r[-1, 0]
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    pts = np.stack([r * st * np.cos(phi), r * ct, r * st * np.sin(phi)],
                   axis=-1)  # (n_lat + 1, n_lon, 3)
    tris = []
    for i in range(n_lat):
        for j in range(n_lon):
            k = (j + 1) % n_lon
            a, b = pts[i, j], pts[i, k]
            c, d = pts[i + 1, j], pts[i + 1, k]
            if i > 0:
                tris.append((a, b, c))
            if i < n_lat - 1:
                tris.append((b, d, c))
    lines = ["solid blob"]
    for tri in tris:
        lines += [" facet normal 0 0 0", "  outer loop"]
        lines += [f"   vertex {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}" for v in tri]
        lines += ["  endloop", " endfacet"]
    lines.append("endsolid blob")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture
def blob(tmp_path):
    """64-triangle STL scene (~0.15 radius after the loader's scale)."""
    return load_stl(_write_blob_stl(tmp_path / "blob.stl", 5, 8))


def _setup():
    # Slight offset + yaw so no edge parks exactly on a pixel row (see
    # test_gradients._setup).
    cam = Camera.make((0.0137, 0.0071, -0.6213), yaw=0.003, focal=32.37)
    lights = Lights.single(capacity=1)
    rng = np.random.default_rng(11)
    w = jnp.asarray(rng.normal(size=(SIZE, SIZE, 3)), jnp.float32)
    return cam, lights, w


def test_soft_stl_raster_vertex_gradients_fd(blob):
    """fd check of soft rasterizer vertex gradients on STL geometry."""
    scene = blob
    cam, lights, w = _setup()
    cfg = RenderConfig(width=SIZE, height=SIZE, mode="soft",
                       soft_edge_sharpness=10.0, soft_z_sharpness=20.0)
    img0 = rasterize_soft(scene, cam, lights, cfg)
    assert float(jnp.max(img0)) > 0.01, "STL scene not visible"

    def img_fn(verts):
        v0, v1, v2 = verts
        s2 = dataclasses.replace(scene, v0=v0, v1=v1, v2=v2)
        return rasterize_soft(s2, cam, lights, cfg)

    err = _dir_deriv_check(img_fn, (scene.v0, scene.v1, scene.v2), w,
                           key=5, eps=1e-3)
    assert err < 5e-2, f"soft rasterize STL vertex grad rel err {err}"


@pytest.mark.parametrize("renderer", ["rasterize", "raytrace"])
def test_soft_stl_fit_converges(blob, renderer):
    """Functional gradient quality on STL geometry: a vertex fit from a
    perturbed mesh drives the image loss down >3x in 40 steps."""
    import optax

    scene = blob
    cam, lights, _ = _setup()
    cfg = RenderConfig(width=SIZE, height=SIZE, mode="soft",
                       soft_edge_sharpness=10.0, soft_z_sharpness=20.0)
    render = rasterize_soft if renderer == "rasterize" else raytrace_soft
    target = render(scene, cam, lights, cfg)

    keys = jax.random.split(jax.random.PRNGKey(4), 3)
    noise = [0.01 * jax.random.normal(k, scene.v0.shape) for k in keys]
    noisy = dataclasses.replace(
        scene, v0=scene.v0 + noise[0], v1=scene.v1 + noise[1],
        v2=scene.v2 + noise[2])

    opt = optax.adam(1e-3)

    @jax.jit
    def step(params, opt_state):
        def loss_fn(p):
            s2 = dataclasses.replace(scene, v0=p[0], v1=p[1], v2=p[2])
            return jnp.mean((render(s2, cam, lights, cfg) - target) ** 2)

        loss, g = jax.value_and_grad(loss_fn)(params)
        upd, opt_state = opt.update(g, opt_state, params)
        return optax.apply_updates(params, upd), opt_state, loss

    params = (noisy.v0, noisy.v1, noisy.v2)
    opt_state = opt.init(params)
    _, _, l0 = step(params, opt_state)
    for _ in range(40):
        params, opt_state, loss = step(params, opt_state)
    assert np.isfinite(float(loss))
    assert float(loss) < float(l0) / 3, f"{float(l0)} -> {float(loss)}"


def test_soft_stl_full_scene_forward(tmp_path):
    """A 9024-triangle STL mesh padded to 9216 through the streaming soft
    rasterizer (144 triangle chunks): finite, non-degenerate output, and
    gradients flow."""
    scene = load_stl(_write_blob_stl(tmp_path / "big.stl", 48, 96),
                     pad_to=9216)
    cam, lights, _ = _setup()
    cfg = RenderConfig(width=8, height=8, mode="soft",
                       soft_edge_sharpness=10.0, soft_z_sharpness=20.0)

    def loss(v0):
        s2 = dataclasses.replace(scene, v0=v0)
        return jnp.sum(rasterize_soft(s2, cam, lights, cfg))

    val, g = jax.value_and_grad(loss)(scene.v0)
    assert np.isfinite(float(val)) and float(val) > 0.0
    g = np.asarray(g)
    assert np.all(np.isfinite(g))
    assert np.abs(g).max() > 0.0
