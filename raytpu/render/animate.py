"""Frame-sequence driver — the batch analog of the reference's
realtime Update/Draw loop.

The reference is an interactive SDL app whose Update() applies
keyboard-driven camera/light motion each frame; raytpu renders to files,
so the driver takes a SCRIPT of per-frame key tokens instead of a live
keyboard and replays the exact Update() state transitions:

  raytracer  (`raytracer/Source/raytracer.cpp:346-423`)
    up/down   cameraPos += / -= 0.1 * forward        (fixed step)
    left/right yaw += / -= 0.1
    w/s       lights[0] += / -= 0.1 * forward  (jitter bank moves too,
              `raytracer.cpp:389-400`)
    a/d       lights[0] -= / += 0.1 * right

  rasteriser (`rasteriser/Source/rasteriser.cpp:330-373`, dt-scaled)
    up/down   cameraPos += / -= 0.05 * forward * (dt / 20)
    left/right yaw += / -= 0.01 * (dt / 20)
    w/s       light.z += / -= 0.05 * (dt / 20)   (world axes, unrotated)
    a/d       light.x -= / += 0.05 * (dt / 20)

`forward`/`right` are the camera rotation's third/first columns
(`raytracer.cpp:346-348` reads GLM columns; Camera.rotation() stores
M[row][col] = cameraRot[col][row], so forward = M[:, 2], right = M[:, 0]).

One jitted render is reused across every frame: RenderConfig is the only
static argument, camera/lights are traced — frame 2 onward pays zero
recompilation. The REALTIME preset reproduces `raytracer.cpp:61-65`
(150x150, focal 250, camera (0, 0, -4.3)).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Iterable

import jax.numpy as jnp
import numpy as np

from raytpu.core.types import Camera, Lights, RenderConfig, Scene

KEYS = ("none", "up", "down", "left", "right", "w", "s", "a", "d")


def realtime_preset():
    """`raytracer.cpp:61-65`: REALTIME -> 150x150, f=250, cam (0,0,-4.3)."""
    camera = Camera.make((0.0, 0.0, -4.3), focal=250.0)
    cfg = RenderConfig(width=150, height=150, mode="parity")
    return camera, cfg


def expand_script(script: str) -> list[str]:
    """'left*3,up,w*2' -> ['left','left','left','up','w','w']."""
    out = []
    for token in script.split(","):
        token = token.strip()
        if not token:
            continue
        if "*" in token:
            key, _, count = token.partition("*")
            out.extend([key.strip()] * int(count))
        else:
            out.append(token)
    for k in out:
        if k not in KEYS:
            raise ValueError(f"unknown key {k!r}; valid: {KEYS}")
    return out


def _axes(camera: Camera):
    rot = np.asarray(camera.rotation())
    return rot[:, 0], rot[:, 2]  # right, forward (GLM columns 0 / 2)


def apply_key_raytracer(camera: Camera, lights: Lights, key: str):
    """One Update() state transition, raytracer semantics (fixed 0.1
    steps; light motion shifts the jitter bank too)."""
    right, forward = _axes(camera)
    pos = np.asarray(camera.pos)
    yaw = float(camera.yaw)
    dlight = None
    if key == "up":
        pos = pos + 0.1 * forward
    elif key == "down":
        pos = pos - 0.1 * forward
    elif key == "left":
        yaw += 0.1
    elif key == "right":
        yaw -= 0.1
    elif key == "w":
        dlight = 0.1 * forward
    elif key == "s":
        dlight = -0.1 * forward
    elif key == "a":
        dlight = -0.1 * right
    elif key == "d":
        dlight = 0.1 * right
    camera = dataclasses.replace(
        camera, pos=jnp.asarray(pos, jnp.float32),
        yaw=jnp.asarray(yaw, jnp.float32),
    )
    if dlight is not None:
        d = jnp.asarray(dlight, jnp.float32)
        lights = Lights(
            position=lights.position.at[0].add(d),
            color=lights.color,
            intensity=lights.intensity,
            mask=lights.mask,
            jitter=lights.jitter.at[0].add(d[None, :]),
        )
    return camera, lights


def apply_key_rasterizer(camera: Camera, lights: Lights, key: str,
                         dt_ms: float = 20.0):
    """One Update() transition, rasteriser semantics (dt-scaled; light
    moves on WORLD x/z, `rasteriser.cpp:353-373`)."""
    _, forward = _axes(camera)
    scale = dt_ms / 20.0
    pos = np.asarray(camera.pos)
    yaw = float(camera.yaw)
    dl = np.zeros(3, np.float32)
    if key == "up":
        pos = pos + 0.05 * forward * scale
    elif key == "down":
        pos = pos - 0.05 * forward * scale
    elif key == "left":
        yaw += 0.01 * scale
    elif key == "right":
        yaw -= 0.01 * scale
    elif key == "w":
        dl[2] = 0.05 * scale
    elif key == "s":
        dl[2] = -0.05 * scale
    elif key == "a":
        dl[0] = -0.05 * scale
    elif key == "d":
        dl[0] = 0.05 * scale
    camera = dataclasses.replace(
        camera, pos=jnp.asarray(pos, jnp.float32),
        yaw=jnp.asarray(yaw, jnp.float32),
    )
    if np.any(dl):
        lights = Lights(
            position=lights.position.at[0].add(jnp.asarray(dl)),
            color=lights.color,
            intensity=lights.intensity,
            mask=lights.mask,
            jitter=lights.jitter,
        )
    return camera, lights


@dataclasses.dataclass
class AnimateResult:
    n_frames: int
    fps: float
    ms_per_frame: float
    compile_s: float
    paths: list


def animate(scene: Scene, camera: Camera, lights: Lights,
            cfg: RenderConfig, keys: Iterable[str],
            renderer: str = "raytrace", dt_ms: float = 20.0,
            out_dir: str | None = None,
            save_every: int = 1) -> AnimateResult:
    """Render one frame per key token, applying the motion BEFORE each
    frame (Update then Draw, `raytracer.cpp:165-172`). Returns timing
    stats; frames go to out_dir as frame_%04d.bmp when given."""
    import jax

    from raytpu.core.image import write_bmp

    if renderer == "raytrace":
        from raytpu.render.raytrace import raytrace_full

        render = lambda s, c, l: raytrace_full(s, c, l, cfg).image  # noqa: E731
        step = apply_key_raytracer
    elif renderer == "rasterize":
        from raytpu.render.rasterize import rasterize

        render = lambda s, c, l: rasterize(s, c, l, cfg)  # noqa: E731
        step = (lambda cam, li, k:
                apply_key_rasterizer(cam, li, k, dt_ms=dt_ms))
    else:
        raise ValueError(f"unknown renderer {renderer!r}")

    keys = list(keys)
    if not keys:
        raise ValueError("animate() needs at least one key event")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    # Warm the single executable (cfg static, camera/lights traced).
    t0 = time.time()
    jax.block_until_ready(render(scene, camera, lights))
    compile_s = time.time() - t0

    # Frames are kept on device during the timed loop (dispatches
    # pipeline); host transfer + BMP writes happen after the clock stops,
    # so fps measures render throughput — the realtime-loop analog.
    paths = []
    kept = []      # (frame index, host ndarray)
    pending = []   # (frame index, device array) — bounded, see below
    t0 = time.time()
    for i, key in enumerate(keys):
        camera, lights = step(camera, lights, key)
        img = render(scene, camera, lights)
        if out_dir and i % save_every == 0:
            pending.append((i, img))
            # Bound on-device retention: a long 500x500 script with
            # save_every=1 would otherwise hold every frame in HBM until
            # the loop ends. Draining in batches keeps the pipelining win
            # for short scripts and a constant memory footprint for long
            # ones (the transfer is timed, as presentation would be).
            if len(pending) >= 64:
                kept.extend((j, np.asarray(a)) for j, a in pending)
                pending.clear()
    jax.block_until_ready(img)
    wall = time.time() - t0
    kept.extend((j, np.asarray(a)) for j, a in pending)
    for i, arr in kept:
        path = os.path.join(out_dir, f"frame_{i:04d}.bmp")
        write_bmp(path, np.asarray(arr))
        paths.append(path)

    n = len(keys)
    return AnimateResult(
        n_frames=n, fps=n / wall, ms_per_frame=wall / n * 1e3,
        compile_s=compile_s, paths=paths,
    )
