"""raytpu command-line interface.

Replaces the reference's keyboard-driven realtime driver
(`raytracer.cpp:329-545`, `rasteriser.cpp:174-373`): every runtime key
toggle becomes a flag with the same default (SURVEY.md §5 config row).

  raytpu render    — raytrace a scene to a BMP (ref: raytracer binary)
  raytpu rasterize — rasterize a scene to a BMP (ref: rasteriser binary)
  raytpu starfield — Lab0 starfield demo frame
  raytpu fit       — inverse-rendering fit to a target image
  raytpu bench     — single-chip benchmark
"""

from __future__ import annotations

import argparse
import sys


def _common_render_flags(p: argparse.ArgumentParser, rasterizer: bool):
    p.add_argument("-o", "--output", default="screenshot.bmp",
                   help="output BMP path (ref: SDL_SaveBMP on exit)")
    p.add_argument("--width", type=int, default=500)
    p.add_argument("--height", type=int, default=500)
    p.add_argument("--mode", choices=["parity", "clean", "soft"],
                   default="parity")
    p.add_argument("--stl", default=None,
                   help="render an ASCII STL model instead of the Cornell "
                        "box (ref CUSTOM_MODEL, `rasteriser.cpp:20`)")
    p.add_argument("--morton", action="store_true",
                   help="Morton-sort STL triangles into spatially tight "
                        "chunks (changes last-wins tie-break order, so "
                        "off by default for parity)")
    p.add_argument("--camera-pos", type=float, nargs=3, default=None)
    p.add_argument("--yaw", type=float, default=0.0)
    p.add_argument("--focal", type=float, default=None,
                   help="focal length in pixels (ref: 250 raytracer / "
                        "500 rasteriser)")
    p.add_argument("--light-pos", type=float, nargs=3,
                   default=(0.0, -0.5, -0.7))
    p.add_argument("--light-color", type=float, nargs=3,
                   default=(1.0, 1.0, 1.0))
    p.add_argument("--light-intensity", type=float, default=14.0)
    p.add_argument("--add-light", action="append", nargs=7,
                   type=float, metavar=("X", "Y", "Z", "R", "G", "B", "I"),
                   default=None,
                   help="extra light (repeatable; ref key 2)")
    p.add_argument("--dof", action="store_true",
                   help="depth-of-field blur (ref key 9)")
    p.add_argument("--dof-kernel", type=int, default=8)
    p.add_argument("--dof-focus", type=float, default=None,
                   help="DoF focus distance (ref FOCAL_LENGTH, keys [ ])")
    if rasterizer:
        p.add_argument("--no-backface-cull", action="store_true",
                       help="disable backface culling (ref key 7)")
        p.add_argument("--no-frustum-cull", action="store_true",
                       help="disable frustum culling (ref key 8)")
    else:
        p.add_argument("--aa", type=int, default=1, metavar="N",
                       help="NxN supersample AA (ref key 7, AA_SAMPLES=3)")
        p.add_argument("--soft-shadows", type=int, default=1, metavar="S",
                       help="soft-shadow samples (ref key 8, 16 samples)")


def _build_inputs(args, rasterizer: bool):
    import jax

    from raytpu.core.cornell import cornell_box
    from raytpu.core.stl import load_stl
    from raytpu.core.types import Camera, Lights, RenderConfig

    if args.stl:
        scene = load_stl(
            args.stl, reorder="morton" if args.morton else None
        )
        default_cam = (0.0, -0.5, -5.0)  # `rasteriser.cpp:109`
    else:
        scene = cornell_box()
        default_cam = (0.0, 0.0, -3.0) if rasterizer else (0.0, 0.0, -2.0)

    focal = args.focal if args.focal is not None else (
        500.0 if rasterizer else 250.0
    )
    dof_focus = args.dof_focus if args.dof_focus is not None else (
        1.9 if rasterizer else 1.3
    )
    camera = Camera.make(
        args.camera_pos or default_cam, yaw=args.yaw, focal=focal,
        y_scale=1.01 if (rasterizer and args.mode == "parity") else 1.0,
        dof_focus=dof_focus,
    )

    extra = args.add_light or []
    soft_samples = getattr(args, "soft_shadows", 1)
    lights = Lights.single(
        position=args.light_pos, color=args.light_color,
        intensity=args.light_intensity,
        capacity=1 + len(extra), soft_samples=max(soft_samples, 1),
    )
    for i, l in enumerate(extra):
        lights = lights.add(l[:3], l[3:6], l[6],
                            key=jax.random.PRNGKey(i + 1))

    cfg = RenderConfig(
        width=args.width, height=args.height, mode=args.mode,
        aa_samples=getattr(args, "aa", 1),
        soft_shadow_samples=soft_samples,
        dof_enabled=args.dof, dof_kernel_size=args.dof_kernel,
        backface_cull=not getattr(args, "no_backface_cull", False),
        frustum_cull=not getattr(args, "no_frustum_cull", False),
    )
    return scene, camera, lights, cfg


def cmd_render(args):
    import numpy as np

    from raytpu.core.image import write_bmp
    from raytpu.render.raytrace import raytrace

    scene, camera, lights, cfg = _build_inputs(args, rasterizer=False)
    img = np.asarray(raytrace(scene, camera, lights, cfg))
    write_bmp(args.output, img)
    print(f"wrote {args.output} ({cfg.width}x{cfg.height}, {cfg.mode})")


def cmd_rasterize(args):
    import numpy as np

    from raytpu.core.image import write_bmp
    from raytpu.render.rasterize import rasterize

    scene, camera, lights, cfg = _build_inputs(args, rasterizer=True)
    img = np.asarray(rasterize(scene, camera, lights, cfg))
    write_bmp(args.output, img)
    print(f"wrote {args.output} ({cfg.width}x{cfg.height}, {cfg.mode})")


def cmd_starfield(args):
    import jax
    import numpy as np

    from raytpu.core.image import write_bmp
    from raytpu.core.starfield import draw_stars, init_stars, update_stars

    stars = init_stars(jax.random.PRNGKey(args.seed), args.stars)
    for _ in range(args.frames):
        stars = update_stars(stars, args.dt)
    img = np.asarray(draw_stars(stars, args.width, args.height))
    write_bmp(args.output, img)
    print(f"wrote {args.output}")


def cmd_animate(args):
    """Frame-sequence driver (the realtime-loop analog; R9 closure).
    One jit reused across frames; reports frames/s."""
    import json as _json

    from raytpu.core.cornell import cornell_box
    from raytpu.core.types import Camera, Lights, RenderConfig
    from raytpu.render.animate import animate, expand_script, realtime_preset

    scene = cornell_box(pad_to=32)
    if args.preset == "realtime":
        camera, cfg = realtime_preset()
    else:
        camera = (Camera.rasterizer_default()
                  if args.renderer == "rasterize"
                  else Camera.raytracer_default())
        cfg = RenderConfig(width=args.width, height=args.height,
                           mode=args.mode)
    lights = Lights.single(capacity=1)
    keys = expand_script(args.script)
    res = animate(scene, camera, lights, cfg, keys,
                  renderer=args.renderer, dt_ms=args.dt,
                  out_dir=args.out_dir, save_every=args.save_every)
    print(_json.dumps({
        "frames": res.n_frames,
        "fps": round(res.fps, 1),
        "ms_per_frame": round(res.ms_per_frame, 3),
        "compile_s": round(res.compile_s, 2),
        "saved": len(res.paths),
        "out_dir": args.out_dir,
    }))


def cmd_fit(args):
    import numpy as np

    from raytpu.core.cornell import cornell_box
    from raytpu.core.image import read_bmp, write_bmp
    from raytpu.core.types import Camera, Lights, RenderConfig
    from raytpu.opt.fit import FitConfig, fit
    from raytpu.render.soft import rasterize_soft

    target = read_bmp(args.target).astype(np.float32) / 255.0
    h, w, _ = target.shape
    scene = cornell_box()
    camera = Camera.make((0.0, 0.0, -3.0), focal=float(w), y_scale=1.01)
    lights = Lights.single(capacity=1, intensity=args.init_intensity)
    cfg = RenderConfig(width=w, height=h, mode="soft")
    fit_cfg = FitConfig(
        steps=args.steps, renderer=args.renderer,
        checkpoint_dir=args.checkpoint_dir,
    )
    mesh = None
    if args.mesh:
        from raytpu.parallel.mesh import make_mesh

        data, model = (int(x) for x in args.mesh.split("x"))
        mesh = make_mesh(data=data, model=model)
    result = fit(target, scene, camera, lights, cfg, fit_cfg,
                 resume_from=args.resume, mesh=mesh)
    print(f"first loss: {result.losses[0]:.6f}")
    print(f"final loss: {result.losses[-1]:.6f}")
    if args.output:
        img = np.asarray(
            rasterize_soft(
                result.scene, camera, result.lights,
                cfg.replace(soft_edge_sharpness=400.0,
                            soft_z_sharpness=4000.0),
            )
        )
        write_bmp(args.output, img)
        print(f"wrote {args.output}")


def cmd_view(args):
    import jax

    from raytpu.core.types import Lights
    from raytpu.view import ViewerApp, serve

    scene, camera, _lights, cfg = _build_inputs(
        args, rasterizer=(args.renderer == "rasterize"))
    # Interactive 32-slot bank (reference light array, raytracer.cpp:47)
    # so key '2' can spawn lights; render() compacts at the host edge.
    lights = Lights.single(
        position=args.light_pos, color=args.light_color,
        intensity=args.light_intensity, capacity=32,
        soft_samples=max(getattr(args, "soft_shadows", 1), 1),
    )
    for i, l in enumerate(args.add_light or []):
        lights = lights.add(l[:3], l[3:6], l[6],
                            key=jax.random.PRNGKey(i + 1))
    app = ViewerApp(scene, camera, lights, cfg, renderer=args.renderer)
    print(f"compiling first frame ({cfg.width}x{cfg.height}, "
          f"{args.renderer}, mode={cfg.mode})...", flush=True)
    app.render()
    server = serve(app, port=args.port)
    print(f"raytpu viewer: http://127.0.0.1:{args.port}/  "
          f"({app.last_ms:.0f} ms/frame warm)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


def cmd_bench(args):
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "raytpu_bench",
        os.path.join(os.path.dirname(__file__), "..", "..", "bench.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main([])


def main(argv=None):
    from raytpu.utils.cache import enable as _enable_cache

    _enable_cache()
    parser = argparse.ArgumentParser(
        prog="raytpu",
        description="differentiable raytracer + rasterizer in JAX",
    )
    parser.add_argument(
        "--platform", default=None, choices=["cpu", "gpu"],
        help="force a JAX platform (default: JAX's own choice, the GPU "
             "when one is present)")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("render", help="raytrace to a BMP")
    _common_render_flags(p, rasterizer=False)
    p.set_defaults(func=cmd_render)

    p = sub.add_parser("rasterize", help="rasterize to a BMP")
    _common_render_flags(p, rasterizer=True)
    p.set_defaults(func=cmd_rasterize)

    p = sub.add_parser("starfield", help="Lab0 starfield demo")
    p.add_argument("-o", "--output", default="starfield.bmp")
    p.add_argument("--width", type=int, default=500)
    p.add_argument("--height", type=int, default=500)
    p.add_argument("--stars", type=int, default=1000)
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--dt", type=float, default=16.0)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(func=cmd_starfield)

    p = sub.add_parser("fit", help="inverse-rendering fit")
    p.add_argument("target", help="target BMP image")
    p.add_argument("-o", "--output", default="fit.bmp")
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--renderer", choices=["rasterize", "raytrace"],
                   default="rasterize")
    p.add_argument("--init-intensity", type=float, default=10.0)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--resume", default=None)
    p.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                   help="shard the fit over a device mesh, e.g. 4x2 "
                        "(rows over 'data', triangle hypotheses over "
                        "'model')")
    p.set_defaults(func=cmd_fit)

    p = sub.add_parser(
        "animate",
        help="frame-sequence driver (realtime Update/Draw analog)",
    )
    p.add_argument("--script", default="left*30,up*20,d*20,right*30",
                   help="per-frame key tokens, e.g. 'left*20,up*5,w*10' "
                        "(keys: up down left right w s a d none)")
    p.add_argument("--renderer", choices=["raytrace", "rasterize"],
                   default="raytrace")
    p.add_argument("--preset", choices=["none", "realtime"],
                   default="none",
                   help="realtime = 150x150 f=250 cam(0,0,-4.3) "
                        "(raytracer.cpp:61-65)")
    p.add_argument("--width", type=int, default=500)
    p.add_argument("--height", type=int, default=500)
    p.add_argument("--mode", choices=["parity", "clean"], default="parity")
    p.add_argument("--dt", type=float, default=20.0,
                   help="virtual frame time in ms for the rasteriser's "
                        "dt-scaled motion (rasteriser.cpp:330-373)")
    p.add_argument("--out-dir", default=None,
                   help="write frame_%%04d.bmp here (omit for pure "
                        "throughput measurement)")
    p.add_argument("--save-every", type=int, default=1)
    p.set_defaults(func=cmd_animate)

    p = sub.add_parser(
        "view", help="live interactive viewer (browser framebuffer; "
                     "the reference's realtime SDL loop)")
    _common_render_flags(p, rasterizer=False)
    p.add_argument("--renderer", default="raytrace",
                   choices=["raytrace", "rasterize"])
    p.add_argument("--port", type=int, default=8000)
    p.set_defaults(func=cmd_view)

    p = sub.add_parser("bench", help="single-chip benchmark")
    p.set_defaults(func=cmd_bench)

    args = parser.parse_args(argv)
    if args.platform is not None:
        import jax

        jax.config.update("jax_platforms", args.platform)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
