"""Multi-device scaling benchmark (BASELINE config 5 harness).

Measures sharded-render throughput across mesh shapes:

    python bench/scaling.py                  # all shapes for the device count
    python bench/scaling.py --size 1024      # 1024x1024 frame
    python bench/scaling.py --train          # fwd+bwd step instead of fwd

On N GPUs this reports rays/s at 1 device vs N devices and the scaling
efficiency. Without GPUs, run with JAX_PLATFORMS=cpu and
XLA_FLAGS=--xla_force_host_platform_device_count=8 to exercise the code
path (the numbers are then CPU-simulation artifacts, clearly labeled).

Multi-host usage: pass --multihost (each process of the launch runs the
same command; coordinator/rank come from RAYTPU_*/JAX env or cluster
auto-detection — see raytpu.parallel.distributed). `jax.devices()` then
spans hosts and the same mesh code shards over all of them; only process
0 prints the final JSON.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--train", action="store_true",
                    help="benchmark the fwd+bwd train step")
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--multihost", action="store_true",
                    help="bootstrap jax.distributed before benchmarking "
                         "(coordinator/rank from RAYTPU_*/JAX env or "
                         "cluster auto-detection)")
    args = ap.parse_args(argv)

    if args.multihost:
        from raytpu.parallel import init_distributed

        dist = init_distributed()
        print(f"# multihost: enabled={dist.enabled} "
              f"process {dist.process_id}/{dist.num_processes}",
              file=sys.stderr)

    import jax
    import jax.numpy as jnp

    from raytpu.core.cornell import cornell_box
    from raytpu.core.types import Camera, Lights, RenderConfig
    from raytpu.parallel.mesh import make_mesh, row_sharding
    from raytpu.parallel.render import (
        TrainState,
        make_sharded_render,
        make_sharded_train_step,
    )
    from raytpu.utils.cache import enable as enable_cache

    enable_cache()
    devices = jax.devices()
    n_dev = len(devices)
    backend = devices[0].platform
    print(f"# backend={backend} devices={n_dev} size={args.size}"
          + (" (CPU SIMULATION — not hardware numbers)"
             if backend == "cpu" else ""),
          file=sys.stderr)

    scene = cornell_box(pad_to=32)
    camera = Camera.raytracer_default()
    lights = Lights.single(capacity=1)
    rays_per_frame = 2 * args.size * args.size

    results = []
    shapes = []
    d = 1
    while d <= n_dev:
        if d % args.model_axis == 0 and args.size % max(
            d // args.model_axis, 1
        ) == 0 and d >= args.model_axis:
            shapes.append((d // args.model_axis, args.model_axis))
        d *= 2
    if not shapes:
        shapes = [(1, 1)]

    base_rate = None
    for data, model in shapes:
        mesh = make_mesh(data=data, model=model,
                         devices=devices[: data * model])
        cfg = RenderConfig(width=args.size, height=args.size, mode="clean")
        render = make_sharded_render(mesh, cfg)

        if args.train:
            import optax

            opt = optax.adam(1e-2)
            step_fn, _ = make_sharded_train_step(mesh, cfg, opt)
            target = jax.device_put(
                render(scene, camera, lights), row_sharding(mesh)
            )
            state = TrainState(scene=scene, lights=lights,
                               opt_state=opt.init((scene, lights)))

            def run():
                return step_fn(state, camera, target)[1]
        else:
            def run():
                return render(scene, camera, lights)

        jax.block_until_ready(run())
        t0 = time.time()
        for _ in range(args.iters):
            out = run()
        jax.block_until_ready(out)
        dt = (time.time() - t0) / args.iters
        rate = rays_per_frame / dt / 1e6
        if base_rate is None:
            base_rate = rate / (data * model)
        eff = rate / (base_rate * data * model)
        results.append({
            "mesh": f"{data}x{model}",
            "devices": data * model,
            "ms_per_frame": round(dt * 1e3, 3),
            "mrays_per_s": round(rate, 1),
            "scaling_efficiency": round(eff, 3),
        })
        print(json.dumps(results[-1]), file=sys.stderr)

    if jax.process_index() == 0:
        print(json.dumps({"metric": "scaling", "size": args.size,
                          "train": args.train, "backend": backend,
                          "processes": jax.process_count(),
                          "results": results}))


if __name__ == "__main__":
    main()
