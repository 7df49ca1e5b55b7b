"""Every f32 contraction on the main path carries an explicit HIGHEST
precision.

An f32 dot_general without one may run in a reduced-precision mode on an
accelerator (TF32 on NVIDIA GPUs keeps ~3 decimal digits), which moves
hit positions, attributes and gradients far outside the parity and
gradient tolerances. The check walks the jaxpr of each forward and
forward+backward entry point, through scan / jit / shard_map bodies.
"""

import jax
import jax.numpy as jnp
import pytest

from raytpu.core.cornell import cornell_box
from raytpu.core.types import Camera, Lights, RenderConfig
from raytpu.render.rasterize import rasterize_full
from raytpu.render.raytrace import raytrace_full
from raytpu.render.soft import rasterize_exact, rasterize_soft, raytrace_soft

SIZE = 16
HIGHEST = jax.lax.Precision.HIGHEST


def _sub_jaxprs(value):
    if hasattr(value, "eqns"):
        yield value
    elif hasattr(value, "jaxpr") and hasattr(value.jaxpr, "eqns"):
        yield value.jaxpr
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _sub_jaxprs(v)


def _contractions(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for value in eqn.params.values():
            for sub in _sub_jaxprs(value):
                yield from _contractions(sub)


def _loose_f32_contractions(fn, *args):
    closed = jax.make_jaxpr(fn)(*args)
    found, loose = 0, []
    for eqn in _contractions(closed.jaxpr):
        if any(v.aval.dtype != jnp.float32 for v in eqn.invars):
            continue
        found += 1
        prec = eqn.params.get("precision")
        precs = prec if isinstance(prec, (tuple, list)) else (prec,)
        if not all(p == HIGHEST for p in precs):
            loose.append(f"{[v.aval.shape for v in eqn.invars]}: {prec}")
    return found, loose


def _scene():
    return cornell_box(pad_to=32)


def _lights():
    return Lights.single(capacity=2, soft_samples=2).add(
        (0.4, -0.5, -0.7), (1.0, 1.0, 1.0), 7.0, key=jax.random.PRNGKey(1))


def _grad(render):
    """fwd+bwd of a scalar loss wrt scene and lights."""
    return jax.grad(lambda s, l: jnp.mean(render(s, l) ** 2), argnums=(0, 1))


def _sharded(renderer, mode):
    from raytpu.parallel.mesh import make_mesh
    from raytpu.parallel.render import make_sharded_train_step

    cfg = RenderConfig(width=SIZE, height=SIZE, mode=mode,
                       soft_edge_sharpness=40.0, soft_z_sharpness=40.0)
    mesh = make_mesh(data=2, model=2, devices=jax.devices()[:4])
    _, loss_fn = make_sharded_train_step(mesh, cfg, None, renderer=renderer)
    cam = (Camera.raytracer_default() if renderer == "raytrace"
           else Camera.rasterizer_default())
    target = jnp.zeros((SIZE, SIZE, 3), jnp.float32)
    return jax.grad(lambda s, l: loss_fn((s, l), cam, target),
                    argnums=(0, 1))


def _cases():
    rt_cam = Camera.raytracer_default()
    rz_cam = Camera.rasterizer_default()
    cfg = RenderConfig(width=SIZE, height=SIZE)
    clean = cfg.replace(mode="clean")
    soft = cfg.replace(mode="soft", soft_edge_sharpness=40.0,
                       soft_z_sharpness=40.0)
    features = clean.replace(aa_samples=2, soft_shadow_samples=2,
                             dof_enabled=True)
    return {
        "raytrace_parity_fwd": lambda s, l: raytrace_full(
            s, rt_cam, l, cfg).image,
        "raytrace_clean_fwd_bwd": _grad(lambda s, l: raytrace_full(
            s, rt_cam, l, clean).image),
        "raytrace_features_fwd_bwd": _grad(lambda s, l: raytrace_full(
            s, rt_cam, l, features).image),
        "rasterize_parity_fwd": lambda s, l: rasterize_full(
            s, rz_cam, l, cfg).image,
        "rasterize_exact_fwd_bwd": _grad(lambda s, l: rasterize_exact(
            s, rz_cam, l, clean)),
        "raytrace_soft_fwd_bwd": _grad(lambda s, l: raytrace_soft(
            s, rt_cam, l, soft)),
        "rasterize_soft_fwd_bwd": _grad(lambda s, l: rasterize_soft(
            s, rz_cam, l, soft)),
        "sharded_clean_fwd_bwd": lambda s, l: _sharded(
            "raytrace", "clean")(s, l),
        "sharded_soft_fwd_bwd": lambda s, l: _sharded(
            "rasterize", "soft")(s, l),
    }


CASES = [
    "rasterize_exact_fwd_bwd", "rasterize_parity_fwd",
    "rasterize_soft_fwd_bwd", "raytrace_clean_fwd_bwd",
    "raytrace_features_fwd_bwd", "raytrace_parity_fwd",
    "raytrace_soft_fwd_bwd", "sharded_clean_fwd_bwd", "sharded_soft_fwd_bwd",
]


@pytest.mark.parametrize("name", CASES)
def test_main_path_contractions_are_highest(name):
    cases = _cases()
    assert sorted(cases) == CASES
    found, loose = _loose_f32_contractions(cases[name], _scene(), _lights())
    assert found > 0, "no contraction found: the walk missed the bodies"
    assert not loose, f"f32 contractions without HIGHEST: {loose}"


def test_walk_flags_a_default_precision_dot():
    """The check itself: a plain jnp.dot inside a scan body is caught."""
    def fn(s, l):
        def body(c, x):
            return c + jnp.dot(x, x), None
        return jax.lax.scan(body, 0.0, s.v0)[0] + jnp.sum(l.intensity)

    found, loose = _loose_f32_contractions(fn, _scene(), _lights())
    assert found == 1 and len(loose) == 1
