"""ASCII STL model loader.

Replaces the reference's line-scanning parser
(`rasteriser/Source/LoadSTL.cpp:17-97`): scan for "outer" loop blocks, read
three "vertex x y z" lines each, assign a fixed gray albedo (STL carries no
color, `LoadSTL.cpp:22`), then scale by -0.05 on ALL axes
(`LoadSTL.cpp:64-77`) — the negation flips the model into the renderer's
coordinate convention.

The hot path is a vectorized numpy parse (one pass over the file with
fromstring-style splitting) rather than a per-line scalar loop; a C++
implementation for very large models lives in raytpu.native.
"""

from __future__ import annotations

import io

import numpy as np

from raytpu.core.types import Scene

DEFAULT_COLOR = (0.5, 0.5, 0.5)  # `LoadSTL.cpp:22`
DEFAULT_SCALE = 0.05  # `LoadSTL.cpp:19`
REFERENCE_MODEL = "/root/reference/rasteriser/Source/enemy1.stl"


def morton_order(v0, v1, v2, bits: int = 10) -> np.ndarray:
    """Spatial sort permutation by centroid Morton code (numpy, load-time).

    Makes streaming triangle chunks spatially tight. Stable sort keeps the
    reference last-wins tie-break deterministic for equal codes.
    """
    c = (np.asarray(v0) + np.asarray(v1) + np.asarray(v2)) / 3.0
    lo = c.min(axis=0)
    span = np.maximum(c.max(axis=0) - lo, 1e-12)
    q = np.minimum(
        ((c - lo) / span * (2**bits - 1)).astype(np.uint64), 2**bits - 1
    )

    def spread(x):
        x &= np.uint64(0x3FF)
        x = (x | (x << np.uint64(16))) & np.uint64(0x030000FF)
        x = (x | (x << np.uint64(8))) & np.uint64(0x0300F00F)
        x = (x | (x << np.uint64(4))) & np.uint64(0x030C30C3)
        x = (x | (x << np.uint64(2))) & np.uint64(0x09249249)
        return x

    code = (
        spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
        | (spread(q[:, 2]) << np.uint64(2))
    )
    return np.argsort(code, kind="stable")


def parse_ascii_stl(text: str) -> np.ndarray:
    """Parse ASCII STL text into a (T, 3, 3) float32 vertex array.

    Mirrors the reference's tolerance: only "outer" blocks and their
    following 3 vertex lines matter (`LoadSTL.cpp:32-61`); facet normals in
    the file are ignored (the reference recomputes them, `LoadSTL.cpp:79`).
    """
    verts = []
    lines = iter(text.splitlines())
    for line in lines:
        if "outer" in line:
            tri = []
            for _ in range(3):
                vline = next(lines, "")
                parts = [
                    tok for tok in vline.split(" ")
                    if tok and tok != "vertex"
                ]
                tri.append([float(parts[0]), float(parts[1]),
                            float(parts[2])])
            verts.append(tri)
    if not verts:
        raise ValueError("no 'outer loop' facets found — not an ASCII STL?")
    return np.asarray(verts, dtype=np.float32)


def load_stl(path: str, scale: float = DEFAULT_SCALE,
             color=DEFAULT_COLOR, pad_to: int | None = None,
             use_native: bool | None = None,
             reorder: str | None = None) -> Scene:
    """Load an ASCII STL file as a :class:`Scene`.

    Applies the reference transform ``v *= -scale`` on every axis
    (`LoadSTL.cpp:64-77`). Raises on missing/invalid files — the reference
    had no error handling at all (SURVEY.md §5).

    use_native: None = auto (C++ parser from raytpu.native when the shared
    library is buildable, python otherwise).

    reorder: None keeps file order (bit-parity with the reference's
    last-wins tie-break depends on it); "morton" sorts triangles by
    centroid Morton code so streaming triangle chunks are spatially
    tight.
    """
    from raytpu import native

    if use_native is None:
        use_native = native.available()
    if use_native:
        tris = native.parse_stl(path)
    else:
        with open(path, "r", errors="replace") as f:
            tris = parse_ascii_stl(f.read())
    tris = tris * np.float32(-scale)
    if reorder == "morton":
        perm = morton_order(tris[:, 0], tris[:, 1], tris[:, 2])
        tris = tris[perm]
    elif reorder is not None:
        raise ValueError(f"unknown reorder {reorder!r}")
    T = tris.shape[0]
    colors = np.broadcast_to(
        np.asarray(color, np.float32), (T, 3)
    ).copy()
    scene = Scene.from_vertices(
        tris[:, 0], tris[:, 1], tris[:, 2], colors
    )
    if pad_to is not None:
        scene = scene.pad_to(pad_to)
    return scene


def load_reference_model(pad_to: int | None = None,
                         reorder: str | None = None) -> Scene:
    """The reference's 9,028-triangle `enemy1.stl` stress model."""
    return load_stl(REFERENCE_MODEL, pad_to=pad_to, reorder=reorder)
