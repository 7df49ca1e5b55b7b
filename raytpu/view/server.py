"""Live interactive viewer — the accelerator-side answer to the
reference's realtime SDL loop.

The reference is an interactive SDL 1.2 app: a main loop polls the
keyboard, mutates camera/light/toggle state, re-renders, and blits to a
window (`raytracer/Source/raytracer.cpp:113-178` main + Update + Draw;
keystate handling at 345-545; `rasteriser/Source/rasteriser.cpp:174-449`).
Without a display or SDL, this viewer keeps the render loop on-device
(one jitted function per RenderConfig, warm via the persistent compile
cache) and serves the framebuffer over localhost HTTP: a browser <img>
is the window, `fetch('/key?k=...')` is the keystate poll.

Key map (reference semantics, same latching):

  arrows        camera forward/back/yaw   (Update(), fixed 0.1 steps for
  w/s/a/d       light motion               the raytracer, dt-scaled for
                                           the rasteriser — reuses
                                           render.animate.apply_key_*)
  7             AA toggle (3x supersampling)        `raytracer.cpp:426-436`
  8             soft shadows toggle (16 samples)    `raytracer.cpp:438-448`
  9             depth-of-field toggle               `raytracer.cpp:450-460`
  0             clean <-> soft (differentiable) render   (raytpu extension)
  ] / [         focal length +/- 0.1 (px scale ~ +/-10)  `raytracer.cpp:462-473`
  2 / 3         spawn random light / delete last    `raytracer.cpp:520-539`

Run:  raytpu view [--renderer raytrace|rasterize] [--size N] [--port P]
then open http://localhost:P/ in a browser.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import jax
import numpy as np

from raytpu.core.image import encode_bmp
from raytpu.core.types import Camera, Lights, RenderConfig, Scene
from raytpu.render.animate import (
    KEYS, apply_key_rasterizer, apply_key_raytracer,
)

_MOVE_KEYS = tuple(k for k in KEYS if k != "none")


class ViewerApp:
    """Holds the mutable viewer state and renders frames on demand.

    HTTP-free core so tests can drive it directly; ``serve`` wraps it in
    a ThreadingHTTPServer. All state transitions go through
    :meth:`handle_key` under a lock (the reference mutates globals from
    a single SDL thread; here concurrent fetches must not interleave)."""

    def __init__(self, scene: Scene, camera: Camera, lights: Lights,
                 cfg: RenderConfig, renderer: str = "raytrace",
                 seed: int = 0):
        if renderer not in ("raytrace", "rasterize"):
            raise ValueError(f"unknown renderer {renderer!r}")
        self.scene = scene
        self.camera = camera
        self.lights = lights
        self.cfg = cfg
        self.renderer = renderer
        self.lock = threading.Lock()
        self.frame_n = 0
        self.last_ms = 0.0
        self._rng = np.random.default_rng(seed)
        self._jits: dict = {}
        self._frame: np.ndarray | None = None

    # -- rendering ---------------------------------------------------------

    def _render_fn(self, cfg: RenderConfig):
        fn = self._jits.get(cfg)
        if fn is None:
            if cfg.mode == "soft":
                # Key 0: the differentiable render, live (the same soft
                # renderers the training path uses).
                from raytpu.render.soft import rasterize_soft, raytrace_soft

                soft = (raytrace_soft if self.renderer == "raytrace"
                        else rasterize_soft)
                fn = jax.jit(lambda s, c, l: soft(s, c, l, cfg))
            elif self.renderer == "raytrace":
                from raytpu.render.raytrace import raytrace_full

                fn = jax.jit(
                    lambda s, c, l: raytrace_full(s, c, l, cfg).image)
            else:
                from raytpu.render.rasterize import rasterize

                fn = jax.jit(lambda s, c, l: rasterize(s, c, l, cfg))
            self._jits[cfg] = fn
        return fn

    def render(self) -> np.ndarray:
        t0 = time.time()
        # Compact at the host boundary: the shading loop unrolls over
        # light-bank capacity, so an interactive 32-slot bank with one
        # active light would pay 32x (Lights.compact docstring).
        img = np.asarray(jax.block_until_ready(
            self._render_fn(self.cfg)(self.scene, self.camera,
                                      self.lights.compact())))
        self.last_ms = (time.time() - t0) * 1e3
        self._frame = img.reshape(self.cfg.height, self.cfg.width, 3)
        self.frame_n += 1
        return self._frame

    def frame_bmp(self) -> bytes:
        with self.lock:
            if self._frame is None:
                self.render()
            return encode_bmp(self._frame)

    # -- state transitions -------------------------------------------------

    def handle_key(self, key: str) -> dict:
        """Apply one key event (reference Update() semantics), re-render,
        return the new state summary."""
        with self.lock:
            if key in _MOVE_KEYS:
                apply_ = (apply_key_raytracer
                          if self.renderer == "raytrace"
                          else apply_key_rasterizer)
                self.camera, self.lights = apply_(
                    self.camera, self.lights, key)
            elif key == "7":  # AA toggle (AA_SAMPLES=3)
                n = 1 if self.cfg.aa_samples > 1 else 3
                self.cfg = self.cfg.replace(aa_samples=n)
            elif key == "8":  # soft shadows toggle (16 samples)
                n = 1 if self.cfg.soft_shadow_samples > 1 else 16
                self.cfg = self.cfg.replace(soft_shadow_samples=n)
            elif key == "9":  # DoF toggle
                self.cfg = self.cfg.replace(
                    dof_enabled=not self.cfg.dof_enabled)
            elif key == "]":  # FOCAL_LENGTH += 0.1 (world scale) -> px
                self.camera = dataclasses.replace(
                    self.camera, focal=self.camera.focal + 10.0)
            elif key == "[":
                self.camera = dataclasses.replace(
                    self.camera, focal=self.camera.focal - 10.0)
            elif key == "2":  # spawn a random light (raytracer.cpp:522)
                u = lambda: float(self._rng.uniform(-1.0, 1.0))  # noqa: E731
                self.lights = self.lights.add(
                    position=(u() * 2.0, u() * 2.0, u() * 2.0),
                    color=(abs(u()) * 2.0 + 0.2, abs(u()) * 2.0 + 0.2,
                           abs(u()) * 2.0 + 0.2),
                    intensity=abs(u()) * 20.0,
                    key=jax.random.PRNGKey(self._rng.integers(2 ** 31)),
                )
            elif key == "3":  # delete the most recent light
                self.lights = self.lights.delete_last()
            elif key == "0":  # clean <-> soft (differentiable) render
                new_mode = "soft" if self.cfg.mode != "soft" else "clean"
                self.cfg = self.cfg.replace(mode=new_mode)
            elif key != "none":
                raise KeyError(key)
            self.render()
            return self.state()

    def state(self) -> dict:
        return {
            "frame": self.frame_n,
            "ms": round(self.last_ms, 1),
            "renderer": self.renderer,
            "camera_pos": [round(float(v), 3)
                           for v in np.asarray(self.camera.pos)],
            "yaw": round(float(self.camera.yaw), 3),
            "focal": round(float(self.camera.focal), 1),
            "lights": int(np.asarray(self.lights.mask).sum()),
            "aa": self.cfg.aa_samples > 1,
            "soft_shadows": self.cfg.soft_shadow_samples > 1,
            "dof": self.cfg.dof_enabled,
        }


_PAGE = """<!doctype html>
<html><head><title>raytpu viewer</title><style>
 body { background:#111; color:#9e9; font:13px monospace; text-align:center }
 img  { image-rendering:pixelated; width:70vmin; height:70vmin;
        border:1px solid #333; margin-top:1em }
 #hud { margin-top:.6em; white-space:pre }
</style></head><body>
<div>raytpu live viewer — arrows: move/turn · wasd: light · 7 AA · 8 soft
 shadows · 9 DoF · [ ] focal · 2/3 add/del light</div>
<img id="fb" src="/frame.bmp">
<div id="hud">connecting…</div>
<script>
 const KEYMAP = {ArrowUp:'up', ArrowDown:'down', ArrowLeft:'left',
   ArrowRight:'right', w:'w', s:'s', a:'a', d:'d', '7':'7', '8':'8',
   '9':'9', '[':'[', ']':']', '2':'2', '3':'3', '0':'0'};
 let busy = false;
 async function send(k) {
   if (busy) return; busy = true;
   try {
     const r = await fetch('/key?k=' + encodeURIComponent(k));
     const st = await r.json();
     document.getElementById('fb').src = '/frame.bmp?n=' + st.frame;
     document.getElementById('hud').textContent = JSON.stringify(st);
   } finally { busy = false; }
 }
 window.addEventListener('keydown', e => {
   const k = KEYMAP[e.key]; if (k) { e.preventDefault(); send(k); }
 });
 fetch('/state').then(r => r.json()).then(st => {
   document.getElementById('hud').textContent = JSON.stringify(st);
 });
</script></body></html>"""


def serve(app: ViewerApp, port: int = 8000, host: str = "127.0.0.1"):
    """Serve the viewer; blocks. Returns the server (for .shutdown())
    when called with block=False via serve_async below."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            try:
                if url.path == "/":
                    self._send(200, _PAGE.encode(), "text/html")
                elif url.path == "/frame.bmp":
                    self._send(200, app.frame_bmp(), "image/bmp")
                elif url.path == "/state":
                    with app.lock:
                        body = json.dumps(app.state()).encode()
                    self._send(200, body, "application/json")
                elif url.path == "/key":
                    k = parse_qs(url.query).get("k", ["none"])[0]
                    st = app.handle_key(k)
                    self._send(200, json.dumps(st).encode(),
                               "application/json")
                else:
                    self._send(404, b"not found", "text/plain")
            except KeyError:
                self._send(400, b"unknown key", "text/plain")
            except BrokenPipeError:
                pass

    server = ThreadingHTTPServer((host, port), Handler)
    return server
