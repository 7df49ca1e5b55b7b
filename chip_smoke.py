"""Smoke run of raytpu's main path on the GPU.

    python chip_smoke.py             # one card: every phase below
    python chip_smoke.py --cards 4   # four cards: the sharded train steps
                                     # and the unsharded steps they match

One process; it stops at the first failed phase with a non-zero exit and
prints a result only when every phase passed. Phases on one card:

  device     JAX's default backend must be a GPU (no CPU fallback)
  raytrace   hard raytrace at 512^2: parity vs the numpy oracle; clean
             forward and fwd+bwd train-step gradients vs the CPU device
  rasterize  hard rasterizer, parity mode, at 500^2 vs the numpy oracle
  soft       soft raytrace and soft rasterize at 512^2: image and
             gradients (vertices, albedo, light) vs the CPU device
  features   AA 3x3, 16 soft-shadow samples x 2 lights, DoF at 512^2,
             parity mode, vs the numpy oracle
  fit        a few steps of `raytpu fit results/fit_reference/target.bmp`
             through the CLI: the loss must fall
  gpu tests  the test suite's `gpu`-marked tests
  measure    memory analysis and peak bytes of the 512^2 train step; warm
             median ms of the 512^2 train step, the 512^2 forward and
             the 1024^2 train step

The numpy oracles run in worker processes that stay on the CPU, beside
the card's work. The last stdout line is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import multiprocessing
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FIT_TARGET = os.path.join(ROOT, "results", "fit_reference", "target.bmp")
SIZE = 512
RASTER_SIZE = 500
BIG = 1024
CARD = ""  # "name, power limit" from nvidia-smi, set by the device phase


class PhaseError(RuntimeError):
    """A phase's result is outside its stated tolerance."""


def log(msg: str) -> None:
    print(msg, flush=True)


def result_line(platform: str, kind: str, count: int) -> str:
    """The last stdout line of a passing run."""
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def u8_stats(a, b) -> dict:
    """Per-pixel agreement of two float images after u8 quantization."""
    import numpy as np

    from raytpu.core.image import quantize_u8

    d = np.abs(quantize_u8(a).astype(int)
               - quantize_u8(b).astype(int)).max(axis=-1)
    return {"pixels": int(d.size),
            "equal": float((d == 0).mean()),
            "within1": float((d <= 1).mean()),
            "over1": int((d > 1).sum()),
            "max_diff": int(d.max())}


def tree_rel_err(got, ref) -> tuple[float, str]:
    """Largest per-leaf max|got - ref| / max|ref| (leaf-scale relative)
    and the path of the leaf where it occurs."""
    import jax
    import numpy as np

    worst, where = 0.0, ""
    for (path, g), r in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(ref)):
        g, r = np.asarray(g, np.float64), np.asarray(r, np.float64)
        check(np.isfinite(g).all(), "non-finite value on the GPU")
        scale = max(float(np.abs(r).max()), 1e-12)
        err = float(np.abs(g - r).max()) / scale
        if err >= worst:
            worst, where = err, jax.tree_util.keystr(path)
    return worst, where


def nudge(cam):
    """The camera with its position moved by 4 ulps."""
    import dataclasses

    return dataclasses.replace(cam, pos=cam.pos * (1 + 2**-21))


def grad_check(tag, grad, args, nudged_args, tol):
    """Compare GPU gradients with the CPU's, leaf-relative, within `tol`.

    Hard and gated terms make a gradient depend on per-pixel decisions
    that a 1-ulp change can flip; for scale, the line also reports how
    far the CPU's own gradient moves when the camera position moves by
    4 ulps."""
    g_cpu = on_cpu(grad, *args)
    floor, at = tree_rel_err(on_cpu(grad, *nudged_args), g_cpu)
    err, where = tree_rel_err(grad(*args), g_cpu)
    log(f"[{tag}] grads vs CPU: leaf-relative {err:.2e} (worst {where}), "
        f"tolerance {tol:.0e}; the CPU's own change under a 4-ulp camera "
        f"nudge: {floor:.2e} (worst {at})")
    check(err <= tol, f"{tag} grads off the CPU device: {err} at {where}")


def on_cpu(fn, *args):
    """fn(*args) on the CPU device under full f32 matmul precision."""
    import jax

    cpu = jax.devices("cpu")[0]
    with jax.default_matmul_precision("highest"):
        out = fn(*jax.device_put(args, cpu))
    return jax.device_get(out)


def timed_ms(fn, *args, reps=20, warm=3) -> float:
    """Warm median wall ms per call, each call ended by block_until_ready."""
    import jax

    for _ in range(warm):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Oracle jobs (numpy; run in spawned workers that never touch the card)
# ---------------------------------------------------------------------------

def _oracle_job(name: str, kw: dict):
    os.environ["JAX_PLATFORMS"] = "cpu"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from raytpu.core.cornell import cornell_box_numpy
    from raytpu.oracle import rasterizer_oracle, raytracer_oracle

    oracle = rasterizer_oracle if name == "rasterize" else raytracer_oracle
    return oracle.render(cornell_box_numpy(), **kw)[0]


def full_feature_lights():
    """Two lights with 16 jittered soft-shadow samples each."""
    import jax

    from raytpu.core.types import Lights

    return Lights.single(capacity=2, soft_samples=16).add(
        (0.4, -0.5, -0.7), (1.0, 1.0, 1.0), 7.0, key=jax.random.PRNGKey(1))


def start_oracles(pool):
    """Queue the three oracle renders; returns their async results."""
    import jax
    import numpy as np

    lights = jax.tree_util.tree_map(np.asarray, full_feature_lights())
    return {
        "raytrace": pool.apply_async(_oracle_job, ("raytrace", dict(
            width=SIZE, height=SIZE))),
        "rasterize": pool.apply_async(_oracle_job, ("rasterize", dict(
            width=RASTER_SIZE, height=RASTER_SIZE,
            focal=float(RASTER_SIZE)))),
        "features": pool.apply_async(_oracle_job, ("raytrace", dict(
            width=SIZE, height=SIZE, aa_samples=3,
            light_positions=lights.position, light_colors=lights.color,
            light_intensities=lights.intensity,
            soft_positions=lights.jitter, dof_enabled=True))),
    }


# ---------------------------------------------------------------------------
# Steps under test (the public entry points, jitted)
# ---------------------------------------------------------------------------

def make_train_step(render):
    """jit((params, opt_state, target)) -> (params, opt_state, loss): one
    MSE fwd+bwd step wrt (scene, lights) with an sgd update."""
    import jax
    import jax.numpy as jnp
    import optax

    opt = optax.sgd(1e-3)

    def loss_fn(params, target):
        return jnp.mean((render(*params) - target) ** 2)

    @jax.jit
    def step(params, opt_state, target):
        loss, grads = jax.value_and_grad(loss_fn)(params, target)
        upd, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, upd), opt_state, loss

    return step, opt, jax.jit(jax.grad(loss_fn))


def phase(name: str, tolerance: str, precision: str):
    log(f"[{name}] tolerance: {tolerance}; precision: {precision}")


def phase_raytrace(oracles):
    import jax
    import jax.numpy as jnp

    from raytpu.core.cornell import cornell_box
    from raytpu.core.types import Camera, Lights, RenderConfig
    from raytpu.render.raytrace import raytrace, raytrace_full

    phase("raytrace", "parity vs oracle: >= 99.9% of pixels within 1 u8 "
          "step; clean image vs CPU: max abs 1e-4 on >= 99.9% of pixels; "
          "train-step grads vs CPU: leaf-relative 1e-3",
          "f32; matmuls HIGHEST (explicit); CPU reference under "
          "default_matmul_precision('highest')")
    scene = cornell_box(pad_to=32)
    cam = Camera.raytracer_default()
    lights = Lights.single(capacity=1)

    img = raytrace(scene, cam, lights, RenderConfig(width=SIZE, height=SIZE))
    st = u8_stats(img, oracles["raytrace"].get())
    log(f"[raytrace] parity {SIZE}^2 vs oracle: {st}")
    check(st["within1"] >= 0.999, f"parity raytrace off the oracle: {st}")

    cfg = RenderConfig(width=SIZE, height=SIZE, mode="clean")
    fwd = jax.jit(lambda s, l, c: raytrace_full(s, c, l, cfg).image)
    img_g = jax.device_get(fwd(scene, lights, cam))
    img_c = on_cpu(fwd, scene, lights, cam)
    close = float((abs(img_g - img_c).max(axis=-1) <= 1e-4).mean())
    log(f"[raytrace] clean {SIZE}^2 vs CPU: {close:.6f} of pixels within "
        f"1e-4, {u8_stats(img_g, img_c)}")
    check(close >= 0.999, f"clean raytrace off the CPU device: {close}")

    _, _, grad = make_train_step(fwd)
    target = jnp.asarray(img_c) * 0.9
    lights_off = Lights.single(capacity=1, intensity=10.0)
    grad_check("raytrace clean train-step", grad,
               ((scene, lights_off, cam), target),
               ((scene, lights_off, nudge(cam)), target), 1e-3)


def phase_rasterize(oracles):
    from raytpu.core.cornell import cornell_box
    from raytpu.core.types import Camera, Lights, RenderConfig
    from raytpu.render.rasterize import rasterize

    phase("rasterize", "parity vs oracle: >= 99.9% of pixels within 1 u8 "
          "step", "f32; matmuls HIGHEST (explicit)")
    cam = Camera.make((0.0, 0.0, -3.0), focal=float(RASTER_SIZE),
                      y_scale=1.01, dof_focus=1.9)
    img = rasterize(cornell_box(), cam, Lights.single(capacity=1),
                    RenderConfig(width=RASTER_SIZE, height=RASTER_SIZE))
    st = u8_stats(img, oracles["rasterize"].get())
    log(f"[rasterize] parity {RASTER_SIZE}^2 vs oracle: {st}")
    check(st["within1"] >= 0.999, f"parity rasterize off the oracle: {st}")


def phase_soft():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytpu.core.cornell import cornell_box
    from raytpu.core.types import Camera, Lights, RenderConfig
    from raytpu.render.soft import rasterize_soft, raytrace_soft

    phase("soft", "image vs CPU: max abs 1e-4; grads (vertices, albedo, "
          "light) vs CPU: leaf-relative 1e-2 (the hard behind-camera and "
          "near-parallel gates flip on a few pixels)",
          "f32; matmuls and einsums HIGHEST (explicit); CPU reference "
          "under default_matmul_precision('highest')")
    scene = cornell_box(pad_to=32)
    lights = Lights.single(capacity=1)
    cfg = RenderConfig(width=SIZE, height=SIZE, mode="soft",
                       soft_edge_sharpness=40.0, soft_z_sharpness=40.0)
    w = jnp.asarray(np.random.default_rng(0).normal(
        size=(SIZE, SIZE, 3)), jnp.float32)
    for name, render, cam in (
            ("raytrace", raytrace_soft, Camera.raytracer_default()),
            ("rasterize", rasterize_soft, Camera.rasterizer_default())):
        fwd = jax.jit(lambda s, l, c, _r=render: _r(s, c, l, cfg))
        img_g = jax.device_get(fwd(scene, lights, cam))
        img_c = on_cpu(fwd, scene, lights, cam)
        d_img = float(np.abs(img_g - img_c).max())

        def loss(s, l, c, w, _f=fwd):
            return jnp.mean(_f(s, l, c) * w)

        log(f"[soft] {name} {SIZE}^2 vs CPU: image max abs {d_img:.2e}")
        check(d_img <= 1e-4, f"soft {name} image off the CPU: {d_img}")
        # Vertices, albedo and light: the parameters a fit moves.
        grad = jax.jit(lambda s, l, c, w, _l=loss: (
            lambda g: (g[0].v0, g[0].v1, g[0].v2, g[0].color,
                       g[1].position, g[1].color, g[1].intensity)
        )(jax.grad(_l, argnums=(0, 1))(s, l, c, w)))
        grad_check(f"soft {name}", grad, (scene, lights, cam, w),
                   (scene, lights, nudge(cam), w), 1e-2)


def phase_features(oracles):
    from raytpu.core.cornell import cornell_box
    from raytpu.core.types import Camera, RenderConfig
    from raytpu.render.raytrace import raytrace

    phase("features", "parity vs oracle: >= 99% of pixels within 1 u8 "
          "step (DoF spreads a flipped winner over its 8x8 window)",
          "f32; matmuls HIGHEST (explicit)")
    cfg = RenderConfig(width=SIZE, height=SIZE, aa_samples=3,
                       soft_shadow_samples=16, dof_enabled=True)
    img = raytrace(cornell_box(pad_to=32), Camera.raytracer_default(),
                   full_feature_lights(), cfg)
    st = u8_stats(img, oracles["features"].get())
    log(f"[features] parity {SIZE}^2 AA 3x3, 16 samples x 2 lights, DoF "
        f"vs oracle: {st}")
    check(st["within1"] >= 0.99, f"full-feature raytrace off oracle: {st}")


def phase_fit(steps=20):
    from raytpu.cli.main import main as cli

    phase("fit", "the loss falls over the steps", "f32; matmuls HIGHEST")
    with tempfile.TemporaryDirectory() as tmp:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli(["fit", FIT_TARGET, "--steps", str(steps),
                 "-o", os.path.join(tmp, "fit.bmp")])
    out = dict(line.split(": ", 1) for line in buf.getvalue().splitlines()
               if line.startswith(("first loss", "final loss")))
    first, final = float(out["first loss"]), float(out["final loss"])
    log(f"[fit] raytpu fit {os.path.relpath(FIT_TARGET, ROOT)} --steps "
        f"{steps}: loss {first:.6f} -> {final:.6f}")
    check(final < first, f"fit loss did not fall: {first} -> {final}")


def phase_gpu_tests():
    import pytest

    log("[gpu tests] pytest -m gpu tests/test_gpu.py")
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly", os.path.join(ROOT, "tests",
                                                        "test_gpu.py")])
    check(rc == 0, f"gpu-marked tests failed (pytest exit {rc})")


def phase_measure():
    import jax

    from raytpu.core.cornell import cornell_box
    from raytpu.core.types import Camera, Lights, RenderConfig
    from raytpu.render.raytrace import raytrace_full

    scene = cornell_box(pad_to=32)
    cam = Camera.raytracer_default()
    lights = Lights.single(capacity=1)
    tag = f"[card: {CARD}]"
    for size in (SIZE, BIG):
        cfg = RenderConfig(width=size, height=size, mode="clean")
        fwd = jax.jit(lambda s, l, _c=cfg: raytrace_full(s, cam, l, _c).image)
        step, opt, _ = make_train_step(fwd)
        params = (scene, Lights.single(capacity=1, intensity=10.0))
        target = fwd(scene, lights)
        opt_state = opt.init(params)
        if size == SIZE:
            compiled = step.lower(params, opt_state, target).compile()
            log(f"[measure] {size}^2 train step memory_analysis: "
                f"{compiled.memory_analysis()} {tag}")
            ms = timed_ms(fwd, scene, lights)
            log(f"[measure] {size}^2 clean forward: warm median "
                f"{ms:.3f} ms {tag}")
        ms = timed_ms(step, params, opt_state, target)
        log(f"[measure] {size}^2 clean train step (fwd+bwd+sgd): warm "
            f"median {ms:.3f} ms {tag}")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"[measure] peak_bytes_in_use {stats.get('peak_bytes_in_use')} "
        f"{tag}")


# ---------------------------------------------------------------------------
# Four cards: the sharded train steps vs the unsharded single-card step
# ---------------------------------------------------------------------------

def phase_sharded():
    import dataclasses

    import jax
    import jax.numpy as jnp
    import optax

    from raytpu.core.cornell import cornell_box
    from raytpu.core.types import Camera, Lights, RenderConfig
    from raytpu.parallel.mesh import make_mesh, row_sharding
    from raytpu.parallel.render import (
        TrainState,
        make_sharded_render,
        make_sharded_train_step,
    )
    from raytpu.render.raytrace import raytrace_full
    from raytpu.render.soft import rasterize_soft

    phase("sharded", "image vs unsharded: max abs 1e-5 (clean), 1e-4 "
          "(soft); loss: relative 1e-5; grads: leaf-relative 1e-3",
          "f32; matmuls HIGHEST (explicit)")
    devs = jax.devices()
    check(len(devs) >= 4, f"--cards 4 needs 4 devices, have {len(devs)}")
    scene = cornell_box(pad_to=32)
    lights = Lights.single(capacity=1)
    lights_off = Lights.single(capacity=1, intensity=10.0)
    cases = (
        ("clean", (4, 1), BIG, Camera.raytracer_default(), lights_off,
         scene, RenderConfig(width=BIG, height=BIG, mode="clean"),
         "raytrace"),
        ("soft", (2, 2), SIZE, Camera.rasterizer_default(), lights,
         dataclasses.replace(scene, v0=scene.v0 + 0.01),
         RenderConfig(width=SIZE, height=SIZE, mode="soft",
                      soft_edge_sharpness=40.0, soft_z_sharpness=40.0),
         "rasterize"),
    )
    for name, (data, model), size, cam, l0, s0, cfg, renderer in cases:
        mesh = make_mesh(data=data, model=model, devices=devs[:4])
        if name == "clean":
            ref_render = lambda s, l, _c=cfg: raytrace_full(  # noqa: E731
                s, cam, l, _c).image
            sharded_img = make_sharded_render(mesh, cfg)(scene, cam, lights)
        else:
            from raytpu.parallel.render import make_sharded_soft_render

            ref_render = lambda s, l, _c=cfg: rasterize_soft(  # noqa: E731
                s, cam, l, _c)
            sharded_img = make_sharded_soft_render(mesh, cfg, renderer)(
                scene, cam, lights)
        ref_render = jax.jit(ref_render)
        target = ref_render(scene, lights)
        d_img = float(jnp.abs(jax.device_get(sharded_img)
                              - jax.device_get(target)).max())

        opt = optax.sgd(1e-3)
        train_step, loss_fn = make_sharded_train_step(mesh, cfg, opt,
                                                      renderer=renderer)
        target_sh = jax.device_put(target, row_sharding(mesh))
        loss_sh = float(loss_fn((s0, l0), cam, target_sh))
        g_sh = jax.grad(lambda p: loss_fn(p, cam, target_sh))((s0, l0))
        state = TrainState(scene=s0, lights=l0, opt_state=opt.init((s0, l0)))
        state, _ = train_step(state, cam, target_sh)

        def ref_loss(p, _r=ref_render):
            return jnp.mean((_r(*p) - target) ** 2)

        loss_un = float(jax.jit(ref_loss)((s0, l0)))
        g_un = jax.jit(jax.grad(ref_loss))((s0, l0))
        err, where = tree_rel_err(g_sh, g_un)
        d_loss = abs(loss_sh - loss_un) / max(abs(loss_un), 1e-12)
        log(f"[sharded] {name} {size}^2 on a {data}x{model} mesh vs one "
            f"card: image max abs {d_img:.2e}, loss {loss_sh:.8f} vs "
            f"{loss_un:.8f} (rel {d_loss:.2e}), grads leaf-relative "
            f"{err:.2e} (worst {where})")
        check(d_img <= (1e-5 if name == "clean" else 1e-4),
              f"sharded {name} image off: {d_img}")
        check(d_loss <= 1e-5, f"sharded {name} loss off: {d_loss}")
        check(err <= 1e-3, f"sharded {name} grads off: {err}")
        check(all(bool(jnp.isfinite(x).all()) for x in
                  jax.tree_util.tree_leaves((state.scene, state.lights))),
              f"sharded {name} step produced non-finite params")


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4 = run the sharded train steps on four cards "
                         "and nothing else")
    args = ap.parse_args(argv)

    from raytpu.utils.device import parse_nvidia_smi, query_cards, require_gpu

    devs = require_gpu()
    from raytpu.utils.cache import enable as enable_cache

    log(f"[device] {devs[0].platform} {devs[0].device_kind} x{len(devs)}; "
        f"compile cache {enable_cache()}")
    smi = query_cards()
    log(smi)
    name, limit = parse_nvidia_smi(smi)[0]
    CARD = f"{name}, {limit}"
    t0 = time.perf_counter()
    if args.cards == 4:
        phase_sharded()
        count = 4
    else:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(3) as pool:
            oracles = start_oracles(pool)
            phase_raytrace(oracles)
            phase_rasterize(oracles)
            phase_soft()
            phase_fit()
            phase_features(oracles)
        phase_gpu_tests()
        phase_measure()
        count = len(devs)
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s "
        f"[card: {CARD}]")
    print(result_line(devs[0].platform, devs[0].device_kind, count),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
