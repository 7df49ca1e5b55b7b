"""Device-mesh construction for raytpu.

The reference's entire "distributed backend" is OpenMP ``parallel for`` over
image rows (`raytracer/Source/raytracer.cpp:557,617`; SURVEY.md §2.5). The
JAX replacement is a `jax.sharding.Mesh` with two named axes:

  data  — image rows / ray tiles (the OpenMP-rows analog; pure data
          parallel, scales with pixel count).
  model — triangle blocks (a tensor-parallel-like split of the
          intersection work for large scenes; the closest-hit reduction is
          merged across the axis with collectives).

pp/sp/ep have no analog in this workload: there is no layer pipeline, no
sequence axis, no experts (SURVEY.md §2.5 "absent"). The scaling axes of a
renderer are pixels and triangles, and both are covered here.

Multi-host: `jax.distributed.initialize()` before mesh construction makes
`jax.devices()` span hosts; the same mesh code then shards over the
devices of every host, with gradient psums scheduled by XLA.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(data: int | None = None, model: int = 1,
              devices=None) -> Mesh:
    """Build a ('data', 'model') mesh.

    Args:
      data: size of the data axis; defaults to n_devices // model.
      model: size of the triangle-sharding axis (1 = replicate triangles).
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if data is None:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(
            f"mesh {data}x{model} != {n} available devices"
        )
    arr = np.asarray(devices).reshape(data, model)
    return Mesh(arr, (DATA_AXIS, MODEL_AXIS))


def row_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for (H, W, 3) images: rows over the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS, None, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
