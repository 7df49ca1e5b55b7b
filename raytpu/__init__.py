"""raytpu — a differentiable raytracer + rasterizer framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the reference
C++ project ``ArchDD/CPP-Raytracer-Rasterizer`` (CPU raytracer, CPU scanline
rasterizer, Lab0 starfield; see /root/reference). This is NOT a port: the
reference is triangle-major, scalar and OpenMP-threaded; raytpu is pixel-major,
batched and SPMD over a `jax.sharding.Mesh`.

Layer map (reference -> raytpu):
  L0 math (vendored GLM)            -> jax.numpy primitives
  L1 platform/framebuffer (SDL 1.2) -> raytpu.core.image (BMP/PNG IO)
  L2 scene (TestModel.h, LoadSTL)   -> raytpu.core.{types,cornell,stl}
  L3 render kernels                 -> raytpu.ops + raytpu.render (jnp/lax)
  L4 app driver / key toggles       -> raytpu.cli + RenderConfig dataclass
  L5 (new) sharding/multi-host      -> raytpu.parallel  (ref analog: OpenMP pragmas)

Public API:
  raytrace(scene, camera, lights, cfg)  -> image (H, W, 3) float32
  rasterize(scene, camera, lights, cfg) -> image (H, W, 3) float32
"""

from raytpu.core.types import (
    Camera,
    Lights,
    RenderConfig,
    Scene,
)
from raytpu.core.cornell import cornell_box
from raytpu.render.raytrace import raytrace
from raytpu.render.rasterize import rasterize

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "Lights",
    "RenderConfig",
    "Scene",
    "cornell_box",
    "raytrace",
    "rasterize",
]
