"""Core pytree types for raytpu.

The reference keeps all state in file-scope globals of one translation unit
(`raytracer/Source/raytracer.cpp:28-98`, `rasteriser/Source/rasteriser.cpp:18-80`).
raytpu replaces that with four explicit values:

  * :class:`Scene`   — struct-of-arrays triangle soup (ref: ``std::vector<Triangle>``
    of ``Triangle{v0,v1,v2,normal,color}``, `raytracer/Source/TestModel.h:11-32`).
  * :class:`Camera`  — pinhole camera (ref globals ``cameraPos/cameraRot/focalLength/yaw``,
    `raytracer.cpp:61-74`, `rasteriser.cpp:38-42`).
  * :class:`Lights`  — padded multi-light bank (ref ``Light lights[32]; int NUM_LIGHTS``,
    `raytracer.cpp:47-48`, ``Light`` class `TestModel.h:35-45`).
  * :class:`RenderConfig` — static, hashable render settings (ref: compile-time macros
    + keyboard toggles, `raytracer.cpp:33-45,426-542`).

Scene/Camera/Lights are JAX pytrees whose leaves are differentiable; RenderConfig is
deliberately NOT a pytree — it is static so it can select traced code paths under jit.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Literal

import jax
import jax.numpy as jnp
import numpy as np

Mode = Literal["parity", "clean", "soft"]


def _pytree_dataclass(cls):
    """Register a frozen dataclass as a JAX pytree (all fields are data)."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


@_pytree_dataclass
class Scene:
    """Triangle soup as struct-of-arrays, padded to a static size.

    Reference analog: ``std::vector<Triangle>`` where each Triangle caches a
    normal computed as ``normalize(cross(e2, e1))`` (`TestModel.h:26-31`).
    raytpu stores raw vertices only — normals/edges are derived inside the
    render so that gradients flow to vertex positions.

    Attributes:
      v0, v1, v2: (T, 3) float32 vertex positions.
      color:      (T, 3) float32 per-triangle albedo.
      active:     (T,)  float32 mask; 1.0 = real triangle, 0.0 = padding.
                  (Also doubles as the cull mask — the rasteriser's
                  ``isCulled`` flag, `rasteriser/Source/TestModel.h:18`.)
    """

    v0: jax.Array
    v1: jax.Array
    v2: jax.Array
    color: jax.Array
    active: jax.Array

    @property
    def num_triangles(self) -> int:
        return self.v0.shape[0]

    def edges(self):
        """e1 = v1 - v0, e2 = v2 - v0 (`raytracer.cpp:216-217`)."""
        return self.v1 - self.v0, self.v2 - self.v0

    def normals(self) -> jax.Array:
        """Per-triangle unit normals, ref orientation ``normalize(cross(e2, e1))``
        (`TestModel.h:30`). (T, 3)."""
        e1, e2 = self.edges()
        n = jnp.cross(e2, e1)
        # Padded/degenerate triangles have |n| = 0; return 0 instead of NaN.
        # Both the division AND the sqrt input are guarded — sqrt(0) has an
        # infinite derivative that turns a zero cotangent into NaN in
        # reverse-mode AD even when the forward value is masked out.
        norm2 = jnp.sum(n * n, axis=-1, keepdims=True)
        norm = jnp.sqrt(jnp.where(norm2 > 0.0, norm2, 1.0))
        return jnp.where(norm2 > 0.0, n, 0.0) / norm

    def pad_to(self, size: int) -> "Scene":
        """Pad triangle arrays to `size` with inactive degenerate triangles.

        Padding triangles are placed far outside the scene with zero area so
        they can never produce a valid intersection even without masking.
        """
        t = self.num_triangles
        if size < t:
            raise ValueError(f"pad_to({size}) smaller than {t} triangles")
        if size == t:
            return self
        pad = size - t
        far = jnp.full((pad, 3), 1e9, dtype=jnp.float32)
        zc = jnp.zeros((pad, 3), dtype=jnp.float32)
        return Scene(
            v0=jnp.concatenate([self.v0, far]),
            v1=jnp.concatenate([self.v1, far]),
            v2=jnp.concatenate([self.v2, far]),
            color=jnp.concatenate([self.color, zc]),
            active=jnp.concatenate(
                [self.active, jnp.zeros((pad,), dtype=jnp.float32)]
            ),
        )

    @staticmethod
    def from_vertices(v0, v1, v2, color) -> "Scene":
        v0 = jnp.asarray(v0, jnp.float32)
        return Scene(
            v0=v0,
            v1=jnp.asarray(v1, jnp.float32),
            v2=jnp.asarray(v2, jnp.float32),
            color=jnp.asarray(color, jnp.float32),
            active=jnp.ones((v0.shape[0],), jnp.float32),
        )


@_pytree_dataclass
class Camera:
    """Pinhole camera.

    The reference builds a yaw-only rotation matrix in-place
    (`raytracer.cpp:376-382`): columns ``[c,0,s],[0,ryy,0],[-s,0,c]`` in GLM's
    column-major storage. ``ryy`` is 1.0 for the raytracer
    (`raytracer.cpp:162`) but **1.01** for the rasteriser
    (`rasteriser.cpp:115` — a reference quirk we must reproduce for parity).

    Attributes:
      pos:       (3,) float32 camera position.
      yaw:       ()  float32 rotation about the y axis.
      focal:     ()  float32 focal length in pixels (ray gen / projection).
      y_scale:   ()  float32 the ``cameraRot[1][1]`` value (parity quirk).
      dof_focus: ()  float32 the DoF focus distance ``FOCAL_LENGTH``
                 (`raytracer.cpp:45` default 1.3; `rasteriser.cpp:31` default 1.9).
    """

    pos: jax.Array
    yaw: jax.Array
    focal: jax.Array
    y_scale: jax.Array
    dof_focus: jax.Array

    def rotation(self) -> jax.Array:
        """Row-major rotation matrix M with M[row, col].

        Matches GLM storage ``cameraRot[col][row]``: as a numpy-style matrix
        this is ``[[c, 0, -s], [0, y_scale, 0], [s, 0, c]]``.
        Raytracer ray dirs use ``M @ d`` (GLM ``cameraRot * d``,
        `raytracer.cpp:580`); the rasteriser vertex transform uses
        ``(v - pos) @ M`` (GLM ``(v - cameraPos) * cameraRot``,
        `rasteriser.cpp:535`).
        """
        c = jnp.cos(self.yaw)
        s = jnp.sin(self.yaw)
        z = jnp.zeros_like(c)
        return jnp.stack(
            [
                jnp.stack([c, z, -s]),
                jnp.stack([z, self.y_scale, z]),
                jnp.stack([s, z, c]),
            ]
        )

    @staticmethod
    def make(pos, yaw=0.0, focal=250.0, y_scale=1.0, dof_focus=1.3) -> "Camera":
        return Camera(
            pos=jnp.asarray(pos, jnp.float32),
            yaw=jnp.asarray(yaw, jnp.float32),
            focal=jnp.asarray(focal, jnp.float32),
            y_scale=jnp.asarray(y_scale, jnp.float32),
            dof_focus=jnp.asarray(dof_focus, jnp.float32),
        )

    @staticmethod
    def raytracer_default() -> "Camera":
        """Defaults of `raytracer.cpp:67-70` (non-REALTIME): 500x500, f=250,
        pos (0,0,-2), plus DoF focus 1.3 (`raytracer.cpp:45`)."""
        return Camera.make((0.0, 0.0, -2.0), focal=250.0, dof_focus=1.3)

    @staticmethod
    def rasterizer_default() -> "Camera":
        """Defaults of `rasteriser.cpp:39-41`: f=500, pos (0,0,-3),
        y_scale=1.01 (`rasteriser.cpp:115`), DoF focus 1.9 (`rasteriser.cpp:31`)."""
        return Camera.make(
            (0.0, 0.0, -3.0), focal=500.0, y_scale=1.01, dof_focus=1.9
        )


@_pytree_dataclass
class Lights:
    """Padded bank of point lights with an active mask.

    Reference analog: ``Light lights[32]; int NUM_LIGHTS`` with runtime
    add/delete (`raytracer.cpp:47-48,180-199`). The default scene light is
    position (0,-0.5,-0.7), white, intensity 14 (`raytracer.cpp:116`).

    Attributes:
      position:  (L, 3) float32.
      color:     (L, 3) float32.
      intensity: (L,)  float32.
      mask:      (L,)  float32; 1.0 = active.
      jitter:    (L, S, 3) float32 — precomputed jittered positions for soft
                 shadows (ref ``randomPositions``, `raytracer.cpp:84,186-190`:
                 uniform(-0.5, 0.5) * 0.08 per axis, fixed at AddLight time).
    """

    position: jax.Array
    color: jax.Array
    intensity: jax.Array
    mask: jax.Array
    jitter: jax.Array

    @property
    def capacity(self) -> int:
        return self.position.shape[0]

    @property
    def num_soft_samples(self) -> int:
        return self.jitter.shape[1]

    @staticmethod
    def single(
        position=(0.0, -0.5, -0.7),
        color=(1.0, 1.0, 1.0),
        intensity=14.0,
        capacity: int = 32,
        soft_samples: int = 16,
        key: jax.Array | None = None,
    ) -> "Lights":
        """One active light with the reference defaults (`raytracer.cpp:116`)."""
        lights = Lights.empty(capacity, soft_samples)
        if key is None:
            key = jax.random.PRNGKey(0)
        return lights.add(
            jnp.asarray(position, jnp.float32),
            jnp.asarray(color, jnp.float32),
            jnp.asarray(intensity, jnp.float32),
            key=key,
        )

    @staticmethod
    def empty(capacity: int = 32, soft_samples: int = 16) -> "Lights":
        return Lights(
            position=jnp.zeros((capacity, 3), jnp.float32),
            color=jnp.zeros((capacity, 3), jnp.float32),
            intensity=jnp.zeros((capacity,), jnp.float32),
            mask=jnp.zeros((capacity,), jnp.float32),
            jitter=jnp.zeros((capacity, soft_samples, 3), jnp.float32),
        )

    def add(self, position, color, intensity, key) -> "Lights":
        """Functional AddLight (`raytracer.cpp:180-193`): fills the first
        inactive slot and precomputes jittered soft-shadow positions
        ``pos + uniform(-0.5, 0.5) * 0.08`` per axis."""
        idx = jnp.argmin(self.mask).astype(jnp.int32)
        s = self.num_soft_samples
        jit_off = (
            jax.random.uniform(key, (s, 3), jnp.float32, -0.5, 0.5) * 0.08
        )
        position = jnp.asarray(position, jnp.float32)
        return Lights(
            position=self.position.at[idx].set(position),
            color=self.color.at[idx].set(jnp.asarray(color, jnp.float32)),
            intensity=self.intensity.at[idx].set(
                jnp.asarray(intensity, jnp.float32)
            ),
            mask=self.mask.at[idx].set(1.0),
            jitter=self.jitter.at[idx].set(position[None, :] + jit_off),
        )

    def compact(self) -> "Lights":
        """Strip inactive slots (host-side) so render cost scales with the
        ACTIVE light count, not the bank capacity.

        The reference light bank is a fixed 32-slot array scanned via
        ``NUM_LIGHTS`` (`raytracer.cpp:47-48`) — in raytpu the per-light
        shading loop and the shadow sweeps unroll over ``capacity``, so a
        capacity-32 bank with one active light would pay 32x the shading
        and 32 shadow sweeps. Inactive slots contribute
        exactly zero in both 'clean' and 'parity' modes (the parity run-on
        accumulation only folds in ``mask_k * ...`` terms), and compaction
        preserves the relative order of active slots, so results are
        unchanged.

        No-op under tracing (mask is abstract) — callers inside jit keep
        their static capacity; the public render wrappers compact at the
        host boundary before entering jit.
        """
        if isinstance(self.mask, jax.core.Tracer):
            return self
        mask = np.asarray(self.mask)
        keep = np.flatnonzero(mask > 0.0)
        n = max(int(keep.size), 1)
        if n == self.capacity:
            return self
        if keep.size == 0:
            keep = np.array([0])  # keep one (inactive) slot: shapes stay >0
        take = jnp.asarray(keep, jnp.int32)
        return Lights(
            position=self.position[take],
            color=self.color[take],
            intensity=self.intensity[take],
            mask=self.mask[take],
            jitter=self.jitter[take],
        )

    def delete_last(self) -> "Lights":
        """Functional DeleteLight (`raytracer.cpp:195-199`): deactivates the
        highest active slot."""
        # Highest active slot = argmax over index*mask (0 if none active).
        idx_arr = jnp.arange(self.capacity)
        last = jnp.argmax(jnp.where(self.mask > 0, idx_arr, -1))
        any_active = jnp.any(self.mask > 0)
        new_mask = jnp.where(any_active, self.mask.at[last].set(0.0), self.mask)
        return dataclasses.replace(self, mask=new_mask)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings — hashable; pass as a static arg under jit.

    Every reference runtime toggle becomes a field with the same default:

      width/height:        `raytracer.cpp:67-68` (500x500) — callers pick.
      mode:                'parity' reproduces the reference math bit-for-bit
                           including its quirks (double albedo
                           `raytracer.cpp:325,588`; multi-light accumulation
                           run-on `raytracer.cpp:322`); 'clean' fixes them;
                           'soft' is the differentiable relaxation.
      aa_samples:          AA_SAMPLES=3, disabled by default
                           (`raytracer.cpp:37-38`); 1 means off.
      soft_shadow_samples: SOFT_SHADOWS_SAMPLES=16, disabled by default
                           (`raytracer.cpp:40-41`); 1 means off.
      dof_enabled/kernel:  DOF_ENABLED=false, DOF_KERNEL_SIZE=8
                           (`raytracer.cpp:43-44`).
      backface_cull:       rasteriser BACKFACE_CULLING_ENABLED=true
                           (`rasteriser.cpp:26`).
      frustum_cull:        rasteriser FRUSTUM_CULLING_ENABLED=true
                           (`rasteriser.cpp:27`).
      ambient:             indirect light 0.2 (`raytracer.cpp:81`,
                           `rasteriser.cpp:47`).
      tri_chunk:           triangles streamed per step in the intersection
                           loop (memory knob, not semantics).
      raster_tri_chunk:    triangles per step in the rasterizer's pixel-major
                           depth resolve (materializes a (chunk, H, W) zinv
                           volume — keep small).
      soft_edge_sharpness / soft_z_sharpness: temperatures of the sigmoid
                           edge test and softmax z-resolve in 'soft' mode.
    """

    width: int = 500
    height: int = 500
    mode: Mode = "parity"
    aa_samples: int = 1
    soft_shadow_samples: int = 1
    dof_enabled: bool = False
    dof_kernel_size: int = 8
    backface_cull: bool = True
    frustum_cull: bool = True
    ambient: float = 0.2
    tri_chunk: int = 512
    raster_tri_chunk: int = 64
    soft_edge_sharpness: float = 100.0
    soft_z_sharpness: float = 100.0

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


def as_f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)
