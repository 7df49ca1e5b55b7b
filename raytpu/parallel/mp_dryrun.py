"""Multi-PROCESS dryrun: prove the cross-process code path, not just a
single-process simulation.

This module launches
N localhost processes x D virtual CPU devices each (gloo collectives, the
CPU stand-in for a cross-host network), builds the GLOBAL (data, model)
mesh spanning all
N*D devices, and runs

  1. a cross-process psum over every device (the smoke collective), and
  2. ONE full sharded inverse-rendering train step
     (parallel.render.make_sharded_train_step: forward render + backward
     + gradient psum + optimizer update),

asserting both agree across processes. Reference analog: the OpenMP
thread probe + parallel-for is the reference's entire concurrency story
(`raytracer/Source/raytracer.cpp:118-136,557`); this is its multi-host
replacement (SURVEY.md §5.8).

Usage:
  parent:  launch(num_processes=2, devices_per_process=4)
  worker:  python -m raytpu.parallel.mp_dryrun --rank R --num-processes N \
               --coordinator 127.0.0.1:PORT --devices-per-process D
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def worker_main(rank: int, num_processes: int, coordinator: str,
                devices_per_process: int) -> dict:
    """Per-process body. Must run in a FRESH interpreter (backend init
    happens after jax.distributed.initialize)."""
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags +
            f" --xla_force_host_platform_device_count={devices_per_process}"
        ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")

    from raytpu.parallel import init_distributed

    state = init_distributed(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=rank,
    )
    assert state.enabled, state
    assert jax.process_count() == num_processes
    assert jax.process_index() == rank

    import jax.numpy as jnp
    import optax
    from jax.sharding import PartitionSpec as P

    from jax import shard_map

    from raytpu.core.cornell import cornell_box
    from raytpu.core.types import Camera, Lights, RenderConfig
    from raytpu.parallel.mesh import DATA_AXIS, make_mesh
    from raytpu.parallel.render import (
        TrainState,
        make_sharded_render,
        make_sharded_train_step,
    )

    n_global = num_processes * devices_per_process
    assert len(jax.devices()) == n_global, (
        f"global device count {len(jax.devices())} != {n_global}"
    )
    assert len(jax.local_devices()) == devices_per_process

    model = 2 if n_global % 2 == 0 else 1
    mesh = make_mesh(data=n_global // model, model=model)

    # --- 1. cross-process psum over every device ------------------------
    # Each device contributes its data-axis index; the psum must see
    # devices on BOTH processes (sum over the full axis), which on CPU
    # rides gloo.
    def _contrib():
        return jax.lax.axis_index(DATA_AXIS).astype(jnp.float32)[None]

    summed = jax.jit(shard_map(
        lambda: jax.lax.psum(_contrib(), DATA_AXIS),
        mesh=mesh, in_specs=(), out_specs=P(DATA_AXIS),
        check_vma=False,
    ))()
    nd = mesh.shape[DATA_AXIS]
    expect = nd * (nd - 1) / 2
    got = float(jnp.sum(summed)) / summed.shape[0]
    assert got == expect, f"psum across processes: {got} != {expect}"

    # --- 2. one full sharded train step ---------------------------------
    rows_mult = mesh.shape[DATA_AXIS] * 2
    cfg = RenderConfig(width=16, height=max(16, rows_mult), mode="clean")
    scene = cornell_box(pad_to=32)
    camera = Camera.raytracer_default()
    lights = Lights.single(capacity=1)

    render = make_sharded_render(mesh, cfg)
    target = render(scene, camera, lights)  # globally row-sharded output

    opt = optax.adam(1e-2)
    train_step, loss_fn = make_sharded_train_step(mesh, cfg, opt)
    lights_off = Lights.single(capacity=1, intensity=10.0)
    st = TrainState(scene=scene, lights=lights_off,
                    opt_state=opt.init((scene, lights_off)))
    st, loss = train_step(st, camera, target)
    loss = float(loss)  # replicated -> addressable on every process
    assert loss == loss and loss > 0.0, f"bad loss {loss}"

    return {
        "rank": rank,
        "num_processes": num_processes,
        "global_devices": n_global,
        "mesh": dict(mesh.shape),
        "psum": got,
        "loss": loss,
    }


def launch(num_processes: int = 2, devices_per_process: int = 4,
           timeout: float = 600.0) -> list[dict]:
    """Spawn the worker processes and collect their result JSON lines."""
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coordinator = f"127.0.0.1:{port}"

    procs = []
    for rank in range(num_processes):
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)  # worker sets its own device count
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "raytpu.parallel.mp_dryrun",
             "--rank", str(rank),
             "--num-processes", str(num_processes),
             "--coordinator", coordinator,
             "--devices-per-process", str(devices_per_process)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env,
        ))

    results = []
    errors = []
    for rank, proc in enumerate(procs):
        try:
            out, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
            errors.append(f"rank {rank}: timeout; stderr: {err[-800:]}")
            continue
        if proc.returncode != 0:
            errors.append(f"rank {rank}: rc={proc.returncode}; "
                          f"stderr: {err[-800:]}")
            continue
        line = [l for l in out.splitlines() if l.startswith("{")]
        if not line:
            errors.append(f"rank {rank}: no result line; stdout: {out!r}")
            continue
        results.append(json.loads(line[-1]))
    if errors:
        raise RuntimeError("mp_dryrun failed:\n" + "\n".join(errors))

    # Replicated quantities must agree bit-for-bit across processes.
    losses = {r["loss"] for r in results}
    assert len(losses) == 1, f"loss disagrees across processes: {losses}"
    return results


def _main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--devices-per-process", type=int, default=4)
    args = ap.parse_args()
    res = worker_main(args.rank, args.num_processes, args.coordinator,
                      args.devices_per_process)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    _main()
