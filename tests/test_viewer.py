"""Live viewer (reference realtime SDL loop analog, raytpu.view)."""

import json
import threading
import urllib.request

import numpy as np

from raytpu.core.cornell import cornell_box
from raytpu.core.image import read_bmp
from raytpu.core.types import Camera, Lights, RenderConfig
from raytpu.render.animate import apply_key_raytracer
from raytpu.view import ViewerApp, serve

SIZE = 32


def _app(renderer="raytrace", capacity=4):
    scene = cornell_box()
    camera = Camera.make((0.0, 0.0, -2.0), focal=float(SIZE) / 2)
    lights = Lights.single(capacity=capacity)
    cfg = RenderConfig(width=SIZE, height=SIZE, mode="clean")
    return ViewerApp(scene, camera, lights, cfg, renderer=renderer,
                     seed=0)


def test_viewer_movement_matches_animate():
    """Arrow keys go through the same Update() transition animate uses."""
    app = _app()
    cam0, li0 = app.camera, app.lights
    st = app.handle_key("up")
    cam_ref, _ = apply_key_raytracer(cam0, li0, "up")
    np.testing.assert_allclose(np.asarray(app.camera.pos),
                               np.asarray(cam_ref.pos))
    assert st["frame"] == 1 and st["camera_pos"][2] != -2.0


def test_viewer_toggles_and_lights():
    app = _app()
    img0 = app.render().copy()

    st = app.handle_key("8")
    assert st["soft_shadows"] is True
    assert app.cfg.soft_shadow_samples == 16
    app.handle_key("8")
    assert app.cfg.soft_shadow_samples == 1

    st = app.handle_key("9")
    assert st["dof"] is True and app.cfg.dof_enabled

    app.handle_key("9")
    st = app.handle_key("2")  # spawn a random light
    assert st["lights"] == 2
    img2 = app._frame.copy()
    assert np.abs(img2 - img0).max() > 1e-3  # new light changes the frame
    st = app.handle_key("3")
    assert st["lights"] == 1

    st = app.handle_key("]")
    assert st["focal"] == SIZE / 2 + 10.0

    try:
        app.handle_key("q")
        raise AssertionError("unknown key must raise")
    except KeyError:
        pass


def test_viewer_http_roundtrip():
    """End-to-end over a real localhost socket: page, state, key, frame."""
    app = _app()
    server = serve(app, port=0)  # ephemeral port
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{port}"
        page = urllib.request.urlopen(base + "/").read()
        assert b"raytpu live viewer" in page

        st = json.loads(urllib.request.urlopen(base + "/state").read())
        assert st["renderer"] == "raytrace"

        st = json.loads(
            urllib.request.urlopen(base + "/key?k=left").read())
        assert st["yaw"] != 0.0

        import tempfile

        bmp = urllib.request.urlopen(base + "/frame.bmp").read()
        with tempfile.NamedTemporaryFile(suffix=".bmp") as f:
            f.write(bmp)
            f.flush()
            img = read_bmp(f.name)
        assert img.shape == (SIZE, SIZE, 3)
        assert img.max() > 0  # rendered something

        # Unknown key -> 400, server stays alive.
        try:
            urllib.request.urlopen(base + "/key?k=zz")
            raise AssertionError("expected 400")
        except urllib.error.HTTPError as e:
            assert e.code == 400
        json.loads(urllib.request.urlopen(base + "/state").read())
    finally:
        server.shutdown()


def test_viewer_rasterizer_mode():
    app = _app(renderer="rasterize")
    st = app.handle_key("up")
    assert st["frame"] == 1
    assert app._frame.shape == (SIZE, SIZE, 3)


def test_soft_mode_toggle():
    """Key 0 flips the live render between clean and the differentiable
    soft path and produces finite frames."""
    import numpy as np

    from raytpu.core.cornell import cornell_box
    from raytpu.core.types import Camera, Lights, RenderConfig
    from raytpu.view.server import ViewerApp

    app = ViewerApp(
        cornell_box(pad_to=32), Camera.raytracer_default(),
        Lights.single(capacity=2), RenderConfig(width=16, height=16,
                                                mode="clean"),
    )
    st = app.handle_key("0")
    assert app.cfg.mode == "soft", st
    frame_soft = app._frame.copy()
    assert np.isfinite(frame_soft).all()
    app.handle_key("0")
    assert app.cfg.mode == "clean"
    assert np.isfinite(app._frame).all()
    # Soft and clean frames differ (relaxed visibility + optical-depth
    # shadows vs hard) but stay in the same image range.
    assert np.abs(frame_soft - app._frame).mean() < 0.5
