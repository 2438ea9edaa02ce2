"""Software framebuffer renderer: the shape renderer's draw calls
rasterized in numpy.

Counterpart of ``slamrs_tpu/viz/framebuffer.py``, byte for byte: the
camera's orthographic world-to-pixel transform, point plotting, lines
sampled at ``ceil(len) + 1`` points, half-space triangle fill, and
per-vertex RGBA alpha-blended in submission order.  ``render(calls,
camera)`` gives a ``u8[H, W, 4]`` framebuffer and :func:`save_png` writes
it (through matplotlib, imported there only).
"""

from __future__ import annotations

import numpy as np

from slamrs_tpu_torch.viz.shapes import (Camera, DrawCall, PrimitiveType,
                                         require_matplotlib)


def _to_pixels(v: np.ndarray, camera: Camera, w: int, h: int) -> np.ndarray:
    """World [N, 2] -> float pixel coords (y down), the vertex-shader
    transform (orthographic projection, shader.rs uniform)."""
    x0, x1, y0, y1 = camera.extent()
    px = (v[:, 0] - x0) / (x1 - x0) * w
    py = (y1 - v[:, 1]) / (y1 - y0) * h
    return np.stack([px, py], -1)


def _blend(fb: np.ndarray, ys: np.ndarray, xs: np.ndarray,
           color: np.ndarray) -> None:
    """Alpha-blend one RGBA color into the framebuffer at (ys, xs)."""
    h, w, _ = fb.shape
    keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    ys, xs = ys[keep], xs[keep]
    if not len(ys):
        return
    a = float(color[3])
    fb[ys, xs, :3] = ((1.0 - a) * fb[ys, xs, :3]
                      + a * (color[:3] * 255.0)).astype(np.uint8)
    fb[ys, xs, 3] = 255


def _draw_points(fb, pts, colors):
    xs = np.round(pts[:, 0]).astype(int)
    ys = np.round(pts[:, 1]).astype(int)
    for i in range(len(xs)):
        _blend(fb, ys[i:i + 1], xs[i:i + 1], colors[i])


def _draw_lines(fb, pts, colors):
    """All segments via vectorized DDA: sample each segment at
    ceil(len)+1 points (GL_LINES semantics, 1-px width)."""
    n = len(pts) // 2
    if n == 0:
        return
    a = pts[0:2 * n:2]
    b = pts[1:2 * n:2]
    steps = np.maximum(np.abs(b - a).max(axis=1), 1.0)
    m = int(np.ceil(steps.max())) + 1
    t = np.linspace(0.0, 1.0, m)[None, :, None]
    samples = a[:, None, :] + (b - a)[:, None, :] * t  # [n, m, 2]
    for i in range(n):
        k = int(np.ceil(steps[i])) + 1
        xs = np.round(samples[i, :k, 0]).astype(int)
        ys = np.round(samples[i, :k, 1]).astype(int)
        _blend(fb, ys, xs, colors[2 * i])


def _draw_triangles(fb, pts, colors):
    """Half-space scanline fill, one triangle per 3 vertices
    (PrimitiveType::Filled semantics)."""
    n = len(pts) // 3
    h, w, _ = fb.shape
    for i in range(n):
        tri = pts[3 * i:3 * i + 3]
        color = colors[3 * i]
        lo = np.floor(tri.min(axis=0)).astype(int)
        hi = np.ceil(tri.max(axis=0)).astype(int)
        x0, y0 = np.maximum(lo, 0)
        x1 = min(hi[0] + 1, w)
        y1 = min(hi[1] + 1, h)
        if x1 <= x0 or y1 <= y0:
            continue
        xs, ys = np.meshgrid(np.arange(x0, x1), np.arange(y0, y1))
        p = np.stack([xs + 0.5, ys + 0.5], -1)
        (ax, ay), (bx, by), (cx, cy) = tri
        # signed edge functions; accept either winding
        e0 = (p[..., 0] - ax) * (by - ay) - (p[..., 1] - ay) * (bx - ax)
        e1 = (p[..., 0] - bx) * (cy - by) - (p[..., 1] - by) * (cx - bx)
        e2 = (p[..., 0] - cx) * (ay - cy) - (p[..., 1] - cy) * (ax - cx)
        inside = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0)) | \
                 ((e0 <= 0) & (e1 <= 0) & (e2 <= 0))
        _blend(fb, ys[inside], xs[inside], color)


def render(calls: list[DrawCall], camera: Camera | None = None,
           width: int = 800, height: int = 600,
           background=(1.0, 1.0, 1.0)) -> np.ndarray:
    """Rasterize draw calls to an RGBA u8 framebuffer [height, width, 4]
    in submission order (the reference renders batches in order too)."""
    camera = camera or Camera(width, height)
    camera.resize(width, height)
    fb = np.empty((height, width, 4), np.uint8)
    fb[..., :3] = (np.asarray(background) * 255).astype(np.uint8)
    fb[..., 3] = 255
    for call in calls:
        pts = _to_pixels(np.asarray(call.vertices, np.float64), camera,
                         width, height)
        colors = np.asarray(call.colors, np.float64)
        if call.primitive == PrimitiveType.POINT:
            _draw_points(fb, pts, colors)
        elif call.primitive == PrimitiveType.LINE:
            _draw_lines(fb, pts, colors)
        elif call.primitive == PrimitiveType.FILLED:
            _draw_triangles(fb, pts, colors)
    return fb


def save_png(fb: np.ndarray, path: str) -> None:
    """Write the framebuffer as PNG (matplotlib's png writer, no figure
    machinery)."""
    matplotlib = require_matplotlib("save_png")
    matplotlib.use("Agg")
    import matplotlib.image

    matplotlib.image.imsave(path, fb)
