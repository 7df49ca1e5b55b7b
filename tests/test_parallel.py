"""Sharded rendering/training on a virtual 8-device CPU mesh.

conftest forces JAX_PLATFORMS=cpu with
--xla_force_host_platform_device_count=8 (SURVEY.md §4 item 4), so these
tests exercise the real mesh/collective code paths without accelerators.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from raytpu.core.cornell import cornell_box
from raytpu.core.types import Camera, Lights, RenderConfig
from raytpu.parallel.mesh import make_mesh, row_sharding
from raytpu.parallel.render import (
    TrainState,
    make_sharded_render,
    make_sharded_train_step,
)
from raytpu.render.raytrace import raytrace_full

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def _setup(size=32):
    scene = cornell_box(pad_to=32)
    cam = Camera.raytracer_default()
    lights = Lights.single(capacity=1)
    cfg = RenderConfig(width=size, height=size, mode="clean")
    return scene, cam, lights, cfg


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_render_matches_unsharded(shape):
    """Determinism across mesh shapes (SURVEY.md §5: same seed/params =>
    identical image whatever the mesh) — and equality with single-device."""
    data, model = shape
    scene, cam, lights, cfg = _setup()
    mesh = make_mesh(data=data, model=model)
    img = np.asarray(make_sharded_render(mesh, cfg)(scene, cam, lights))
    ref = np.asarray(raytrace_full(scene, cam, lights, cfg).image)
    np.testing.assert_allclose(img, ref, atol=1e-6)


def test_sharded_full_features_match_unsharded():
    """AA + soft shadows + multi-light + DoF through the sharded path must
    match the single-device clean render (whole feature set, SURVEY §2
    R3/R4/R5/R7 under the §5.8 sharding plan)."""
    scene = cornell_box(pad_to=32)
    cam = Camera.raytracer_default()
    lights = Lights.single(capacity=2, soft_samples=4).add(
        (0.4, 0.4, -0.6), (1.0, 0.8, 0.6), 8.0, key=jax.random.PRNGKey(7)
    )
    cfg = RenderConfig(width=16, height=16, mode="clean", aa_samples=2,
                       soft_shadow_samples=4, dof_enabled=True)
    mesh = make_mesh(data=4, model=2)
    img = np.asarray(make_sharded_render(mesh, cfg)(scene, cam, lights))
    ref = np.asarray(raytrace_full(scene, cam, lights, cfg).image)
    np.testing.assert_allclose(img, ref, atol=1e-6)


def test_sharded_rasterize_matches_unsharded():
    """Sharded clean rasterizer == rasterize_exact across mesh shapes."""
    from raytpu.parallel.render import make_sharded_rasterize
    from raytpu.render.soft import rasterize_exact

    scene = cornell_box(pad_to=32)
    cam = Camera.rasterizer_default()
    lights = Lights.single(capacity=1)
    cfg = RenderConfig(width=32, height=32, mode="clean")
    ref = np.asarray(rasterize_exact(scene, cam, lights, cfg))
    for data, model in [(8, 1), (2, 4)]:
        mesh = make_mesh(data=data, model=model)
        img = np.asarray(
            make_sharded_rasterize(mesh, cfg)(scene, cam, lights)
        )
        # atol 5e-6: the winner-plane eval is reassociated differently in
        # the sharded merge, which can flip a tie between COPLANAR
        # triangles (same plane => same shade up to a ulp).
        np.testing.assert_allclose(img, ref, atol=5e-6,
                                   err_msg=f"mesh {data}x{model}")


def test_sharded_gradients_match_unsharded():
    scene, cam, lights, cfg = _setup()
    mesh = make_mesh(data=4, model=2)
    opt = optax.sgd(1e-2)
    _, loss_fn = make_sharded_train_step(mesh, cfg, opt)
    target = raytrace_full(scene, cam, lights, cfg).image
    lights_off = Lights.single(capacity=1, intensity=10.0)

    g_sh = jax.grad(lambda p: loss_fn(p, cam, target))((scene, lights_off))

    def unsharded_loss(p):
        s, l = p
        img = raytrace_full(s, cam, l, cfg).image
        return jnp.mean((img - target) ** 2)

    g_un = jax.grad(unsharded_loss)((scene, lights_off))
    for a, b in zip(
        jax.tree_util.tree_leaves(g_sh), jax.tree_util.tree_leaves(g_un)
    ):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6
        )


def test_sharded_training_converges():
    """Light-parameter fit through the sharded step drives the loss down
    by >5x (scene frozen — hard-visibility vertex steps are the soft
    path's job)."""
    scene, cam, lights, cfg = _setup()
    mesh = make_mesh(data=4, model=2)
    opt = optax.multi_transform(
        {"lights": optax.adam(0.1), "frozen": optax.set_to_zero()},
        ("frozen", "lights"),
    )
    train_step, loss_fn = make_sharded_train_step(mesh, cfg, opt)
    target = raytrace_full(scene, cam, lights, cfg).image
    target = jax.device_put(target, row_sharding(mesh))
    lights_off = Lights.single(capacity=1, intensity=10.0)
    state = TrainState(
        scene=scene, lights=lights_off,
        opt_state=opt.init((scene, lights_off)),
    )
    l0 = float(loss_fn((state.scene, state.lights), cam, target))
    for _ in range(40):
        state, loss = train_step(state, cam, target)
    assert float(loss) < l0 / 5, f"{l0} -> {float(loss)}"


def test_dryrun_multichip():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "graft_entry", "/root/repo/__graft_entry__.py"
    )
    ge = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ge)
    ge.dryrun_multichip(8)


def test_entry_compiles():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "graft_entry2", "/root/repo/__graft_entry__.py"
    )
    ge = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ge)
    fn, args = ge.entry()
    jax.jit(fn).lower(*args).compile()


@pytest.mark.parametrize("renderer", ["rasterize", "raytrace"])
def test_sharded_soft_render_matches_unsharded(renderer):
    """Sharded SOFT render (triangle-sharded softmax / transmittance
    merges, VERDICT round-2 item 5) equals the single-device soft
    renderer: partial-aggregation combine is exact up to fp
    reassociation."""
    from raytpu.parallel.render import make_sharded_soft_render
    from raytpu.render.soft import rasterize_soft, raytrace_soft

    scene = cornell_box(pad_to=32)
    lights = Lights.single(capacity=1)
    cfg = RenderConfig(width=32, height=32, mode="soft",
                       soft_edge_sharpness=10.0, soft_z_sharpness=20.0)
    if renderer == "rasterize":
        cam = Camera.rasterizer_default()
        ref = rasterize_soft(scene, cam, lights, cfg)
    else:
        cam = Camera.raytracer_default()
        ref = raytrace_soft(scene, cam, lights, cfg)
    mesh = make_mesh(data=4, model=2)
    img = make_sharded_soft_render(mesh, cfg, renderer)(scene, cam, lights)
    np.testing.assert_allclose(np.asarray(img), np.asarray(ref),
                               atol=1e-4, rtol=1e-3)


def test_sharded_soft_gradients_match_unsharded():
    """Soft (silhouette) gradients through the sharded train step equal
    the single-device soft gradients — the m-stop-grad stats combine
    (parallel.render._soft_combine) must be exact, not just the values."""
    from raytpu.render.soft import rasterize_soft

    scene = cornell_box(pad_to=32)
    cam = Camera.rasterizer_default()
    lights = Lights.single(capacity=1)
    cfg = RenderConfig(width=16, height=16, mode="soft",
                       soft_edge_sharpness=10.0, soft_z_sharpness=20.0)
    mesh = make_mesh(data=2, model=4)
    opt = optax.sgd(1e-2)
    _, loss_fn = make_sharded_train_step(mesh, cfg, opt,
                                         renderer="rasterize")
    target = rasterize_soft(scene, cam, lights, cfg)

    perturbed = dataclasses.replace(scene, v0=scene.v0 + 0.01)
    g_sh = jax.grad(lambda p: loss_fn(p, cam, target))((perturbed, lights))

    def unsharded_loss(p):
        s, l = p
        img = rasterize_soft(s, cam, l, cfg)
        return jnp.mean((img - target) ** 2)

    g_un = jax.grad(unsharded_loss)((perturbed, lights))
    for a, b in zip(
        jax.tree_util.tree_leaves(g_sh), jax.tree_util.tree_leaves(g_un)
    ):
        a, b = np.asarray(a), np.asarray(b)
        assert np.all(np.isfinite(a))
        scale = max(np.abs(b).max(), 1e-3)
        np.testing.assert_allclose(a / scale, b / scale, atol=2e-4)


def test_sharded_soft_training_converges():
    """A vertex+light fit through the sharded SOFT step (the sharded
    silhouette-gradient path, BASELINE config 4 on a mesh) recovers a
    perturbed scene: loss drops >3x in 30 steps."""
    from raytpu.render.soft import raytrace_soft

    scene = cornell_box(pad_to=32)
    cam = Camera.raytracer_default()
    lights = Lights.single(capacity=1)
    cfg = RenderConfig(width=16, height=16, mode="soft",
                       soft_edge_sharpness=10.0, soft_z_sharpness=20.0)
    mesh = make_mesh(data=4, model=2)
    opt = optax.adam(3e-3)
    train_step, loss_fn = make_sharded_train_step(mesh, cfg, opt,
                                                  renderer="raytrace")
    target = raytrace_soft(scene, cam, lights, cfg)
    target = jax.device_put(target, row_sharding(mesh))
    key = jax.random.PRNGKey(3)
    noisy = dataclasses.replace(
        scene, v0=scene.v0 + 0.03 * jax.random.normal(key, scene.v0.shape))
    state = TrainState(scene=noisy, lights=lights,
                       opt_state=opt.init((noisy, lights)))
    l0 = float(loss_fn((state.scene, state.lights), cam, target))
    for _ in range(30):
        state, loss = train_step(state, cam, target)
    assert float(loss) < l0 / 3, f"{l0} -> {float(loss)}"
