"""Headless shape renderer and 2D camera.

Counterpart of ``slamrs_tpu/viz/shapes.py`` (numpy, as there): the same
API, producing the same vertex arrays (position and RGBA, grouped by
primitive type into draw calls) for line, rect, circle, arrow and
covariance-ellipse shapes, an orthographic pan/zoom camera with
``unproject``, and :func:`render_draw_calls`, which rasterizes draw calls
to a PNG through matplotlib.  matplotlib is imported only there, and a
missing matplotlib stops it with an error that says so.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field

import numpy as np


class PrimitiveType(enum.Enum):
    """primitiverenderer.rs PrimitiveType {Point, Line, Filled}."""

    POINT = "point"
    LINE = "line"
    FILLED = "filled"


@dataclass(frozen=True)
class Color:
    """Packed RGBA color (primitiverenderer.rs Color)."""

    r: float
    g: float
    b: float
    a: float = 1.0

    def rgba(self):
        return (self.r, self.g, self.b, self.a)


Color.BLACK = Color(0, 0, 0)
Color.WHITE = Color(1, 1, 1)
Color.RED = Color(1, 0, 0)
Color.GREEN = Color(0, 1, 0)
Color.BLUE = Color(0, 0, 1)


@dataclass
class DrawCall:
    primitive: PrimitiveType
    vertices: np.ndarray  # f32[N, 2]
    colors: np.ndarray  # f32[N, 4]


class ShapeRenderer:
    """Vertex-batching shape renderer (shaperenderer.rs:17-266).

    Usage mirrors the reference: ``begin(ptype)``, emit shapes, ``end()``;
    ``flush()`` returns and clears the accumulated draw calls.
    """

    def __init__(self, max_vertices: int = 1_000_000):
        self.max_vertices = max_vertices  # shaperenderer.rs:20
        self._calls: list[DrawCall] = []
        self._current: PrimitiveType | None = None
        self._verts: list = []
        self._cols: list = []
        self._batches: list = []  # (verts [N,2], cols [N,4]) fast-path
        self._batch_count = 0

    # -- batch control ------------------------------------------------------

    def begin(self, primitive: PrimitiveType) -> None:
        if self._current is not None:
            raise RuntimeError("begin() while a batch is open")
        self._current = primitive

    def end(self) -> None:
        if self._current is None:
            raise RuntimeError("end() without begin()")
        chunks_v = []
        chunks_c = []
        if self._verts:
            chunks_v.append(np.asarray(self._verts, np.float32))
            chunks_c.append(np.asarray(self._cols, np.float32))
        chunks_v += [v for v, _ in self._batches]
        chunks_c += [c for _, c in self._batches]
        if chunks_v:
            self._calls.append(DrawCall(
                self._current,
                np.concatenate(chunks_v, axis=0),
                np.concatenate(chunks_c, axis=0)))
        self._current = None
        self._verts, self._cols = [], []
        self._batches = []
        self._batch_count = 0

    def flush(self) -> list[DrawCall]:
        calls, self._calls = self._calls, []
        return calls

    def _emit(self, x, y, color: Color):
        if len(self._verts) + self._batch_count >= self.max_vertices:
            return  # reference renderer drops beyond the buffer budget
        self._verts.append((float(x), float(y)))
        self._cols.append(color.rgba())

    def _emit_batch(self, verts: np.ndarray, cols: np.ndarray) -> None:
        """Vectorized emit: verts f32[N, 2], cols f32[N, 4] (budget-capped).

        Host-side fast path for dense emitters (grid-cell fields) — the
        reference pushes the same vertices one at a time into its GL
        buffer (primitiverenderer.rs vertex batching); a python loop at
        240k vertices/frame is not viable, one array append is.  Within a
        begin/end pair, batch vertices sort after scalar ones.
        """
        room = self.max_vertices - len(self._verts) - self._batch_count
        if room <= 0:
            return
        verts = np.asarray(verts, np.float32)[:room]
        cols = np.asarray(cols, np.float32)[:room]
        self._batches.append((verts, cols))
        self._batch_count += len(verts)

    # -- shapes (shaperenderer.rs) -------------------------------------------

    def line(self, x1, y1, x2, y2, color: Color) -> None:
        self._emit(x1, y1, color)
        self._emit(x2, y2, color)

    def point(self, x, y, color: Color) -> None:
        self._emit(x, y, color)

    def rect(self, x, y, w, h, color: Color) -> None:
        """Axis-aligned rect, mode-aware like shaperenderer.rs:60-107:
        two triangles under FILLED, a 4-segment outline under LINE."""
        if self._current is PrimitiveType.FILLED:
            for vx, vy in ((x, y), (x + w, y), (x + w, y + h),
                           (x, y), (x + w, y + h), (x, y + h)):
                self._emit(vx, vy, color)
            return
        for (a, b), (c, d) in (((x, y), (x + w, y)),
                               ((x + w, y), (x + w, y + h)),
                               ((x + w, y + h), (x, y + h)),
                               ((x, y + h), (x, y))):
            self.line(a, b, c, d, color)

    def circle(self, x, y, radius, color: Color, segments: int = 32) -> None:
        """Mode-aware circle (shaperenderer.rs:109-160): triangle fan
        under FILLED, a closed polyline under LINE."""
        ang = np.linspace(0, 2 * np.pi, segments + 1)
        xs = x + radius * np.cos(ang)
        ys = y + radius * np.sin(ang)
        if self._current is PrimitiveType.FILLED:
            for i in range(segments):
                self._emit(x, y, color)
                self._emit(xs[i], ys[i], color)
                self._emit(xs[i + 1], ys[i + 1], color)
            return
        for i in range(segments):
            self.line(xs[i], ys[i], xs[i + 1], ys[i + 1], color)

    def arrow(self, x, y, angle, radius, color: Color) -> None:
        """Heading arrow (shaperenderer.rs arrow): a triangle pointing
        along ``angle`` — filled under FILLED, outlined under LINE."""
        tip = (x + radius * math.cos(angle), y + radius * math.sin(angle))
        left = (x + 0.5 * radius * math.cos(angle + 2.5),
                y + 0.5 * radius * math.sin(angle + 2.5))
        right = (x + 0.5 * radius * math.cos(angle - 2.5),
                 y + 0.5 * radius * math.sin(angle - 2.5))
        if self._current is PrimitiveType.FILLED:
            for vx, vy in (tip, left, right):
                self._emit(vx, vy, color)
            return
        for a, b in ((tip, left), (left, right), (right, tip)):
            self.line(*a, *b, color)

    def lines_batch(self, segments: np.ndarray, colors: np.ndarray) -> None:
        """Vectorized line segments: segments f32[N, 2, 2] (endpoint
        pairs), colors f32[N, 4] or one RGBA row — the dense-emitter
        form of :meth:`line` (scene geometry, scan-ray fans)."""
        segments = np.asarray(segments, np.float32)
        n = len(segments)
        if n == 0:
            return
        colors = np.asarray(colors, np.float32)
        if colors.ndim == 1:
            colors = np.broadcast_to(colors, (n, 4))
        self._emit_batch(segments.reshape(-1, 2),
                         np.repeat(colors, 2, axis=0))

    def rects_batch(self, xy: np.ndarray, w: float, h: float,
                    colors: np.ndarray) -> None:
        """Vectorized axis-aligned rect field (one rect per ``xy`` row,
        uniform size, per-rect RGBA) — the dense-emitter form of
        :meth:`rect` used for grid-cell fields and point markers
        (visualize.rs draws those as per-cell/per-point ``sr.rect``
        calls; semantics identical, emission batched)."""
        xy = np.asarray(xy, np.float32)
        colors = np.asarray(colors, np.float32)
        n = len(xy)
        if n == 0:
            return
        if colors.ndim == 1:
            colors = np.broadcast_to(colors, (n, 4))
        x, y = xy[:, 0], xy[:, 1]
        if self._current is PrimitiveType.FILLED:
            # two CCW triangles per rect, 6 vertices
            corners = np.stack([
                np.stack([x, y], -1), np.stack([x + w, y], -1),
                np.stack([x + w, y + h], -1),
                np.stack([x, y], -1), np.stack([x + w, y + h], -1),
                np.stack([x, y + h], -1)], axis=1)  # [N, 6, 2]
            cols = np.repeat(colors, 6, axis=0)
            self._emit_batch(corners.reshape(-1, 2), cols)
            return
        # 4 outline segments per rect, 8 vertices
        corners = np.stack([
            np.stack([x, y], -1), np.stack([x + w, y], -1),
            np.stack([x + w, y], -1), np.stack([x + w, y + h], -1),
            np.stack([x + w, y + h], -1), np.stack([x, y + h], -1),
            np.stack([x, y + h], -1), np.stack([x, y], -1)], axis=1)
        cols = np.repeat(colors, 8, axis=0)
        self._emit_batch(corners.reshape(-1, 2), cols)

    def gaussian2d_confidence(self, mean, covariance, p: float = 0.95,
                              segments: int = 25) -> None:
        """The reference's standalone confidence ellipse
        (shaperenderer.rs:225-260): a filled blue 0.01-radius center dot
        plus a black outline ellipse scaled by ``s = -2 ln(1 - p)``.
        Manages its own begin/end pairs, exactly like the reference."""
        mean = np.asarray(mean, np.float64).reshape(2)
        cov = np.asarray(covariance, np.float64).reshape(2, 2)
        self.begin(PrimitiveType.FILLED)
        self.circle(mean[0], mean[1], 0.01, Color.BLUE)
        self.end()
        s = -2.0 * math.log(max(1.0 - p, 1e-12))
        vals, vecs = np.linalg.eigh(cov * s)
        vals = np.maximum(vals, 0.0)
        vd = vecs @ np.diag(np.sqrt(vals))
        ang = np.linspace(0, 2 * np.pi, segments + 1)
        pts = vd @ np.stack([np.cos(ang), np.sin(ang)])
        self.begin(PrimitiveType.LINE)
        for i in range(segments):
            self.line(mean[0] + pts[0, i], mean[1] + pts[1, i],
                      mean[0] + pts[0, i + 1], mean[1] + pts[1, i + 1],
                      Color.BLACK)
        self.end()

    def gaussian2d(self, mean, covariance, color: Color, n_std: float = 2.0,
                   segments: int = 32) -> None:
        """Covariance ellipse via eigendecomposition
        (shaperenderer.rs:243-247)."""
        cov = np.asarray(covariance, np.float64).reshape(2, 2)
        vals, vecs = np.linalg.eigh(cov)
        vals = np.maximum(vals, 0.0)
        ang = np.linspace(0, 2 * np.pi, segments + 1)
        pts = (vecs @ np.stack([np.sqrt(vals[0]) * np.cos(ang),
                                np.sqrt(vals[1]) * np.sin(ang)]) * n_std)
        xs = mean[0] + pts[0]
        ys = mean[1] + pts[1]
        for i in range(segments):
            self.line(xs[i], ys[i], xs[i + 1], ys[i + 1], color)


class WorldObj:
    """Draw context handed to node draw hooks.

    Parity: ``WorldObj { sr, last_mouse_pos }`` (common/src/world.rs:4-7).
    Forwards unknown attributes to the shape renderer so draw hooks can
    use it interchangeably with a bare :class:`ShapeRenderer`.
    """

    def __init__(self, sr: "ShapeRenderer",
                 last_mouse_pos=None):
        self.sr = sr
        self.last_mouse_pos = last_mouse_pos

    def __getattr__(self, name):
        return getattr(self.sr, name)


class Camera:
    """2D orthographic pan/zoom camera (camera.rs:4-138).

    World viewport width is a fixed 10 units at zoom 1 (camera.rs:52).
    ``unproject`` maps screen pixels to world coordinates.
    """

    VIEWPORT_WIDTH = 10.0

    def __init__(self, screen_w: int = 800, screen_h: int = 600):
        self.center = np.zeros(2, np.float64)
        self.zoom = 1.0
        self.resize(screen_w, screen_h)

    def resize(self, screen_w: int, screen_h: int) -> None:
        self.screen_w = screen_w
        self.screen_h = screen_h

    def pan(self, dx_pixels: float, dy_pixels: float) -> None:
        scale = self.world_width() / self.screen_w
        self.center[0] -= dx_pixels * scale
        self.center[1] += dy_pixels * scale  # screen y is flipped

    def zoom_by(self, factor: float) -> None:
        self.zoom = max(self.zoom * factor, 1e-6)

    def world_width(self) -> float:
        return self.VIEWPORT_WIDTH / self.zoom

    def world_height(self) -> float:
        return self.world_width() * self.screen_h / self.screen_w

    def extent(self) -> tuple[float, float, float, float]:
        hw = self.world_width() / 2
        hh = self.world_height() / 2
        return (self.center[0] - hw, self.center[0] + hw,
                self.center[1] - hh, self.center[1] + hh)

    def unproject(self, px: float, py: float) -> np.ndarray:
        """Screen pixel -> world coordinates (camera.rs unproject)."""
        x0, x1, y0, y1 = self.extent()
        wx = x0 + (px / self.screen_w) * (x1 - x0)
        wy = y1 - (py / self.screen_h) * (y1 - y0)
        return np.array([wx, wy])


def require_matplotlib(what: str):
    """The ``matplotlib`` module, or a ``RuntimeError`` naming ``what``
    when it is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError(f"{what} writes PNG files through matplotlib, "
                           "which is not installed") from e
    return matplotlib


def render_draw_calls(calls: list[DrawCall], path: str,
                      camera: Camera | None = None, dpi: int = 120) -> None:
    """Rasterize draw calls to a PNG through matplotlib."""
    matplotlib = require_matplotlib("render_draw_calls")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from matplotlib.collections import LineCollection, PolyCollection

    fig, ax = plt.subplots(figsize=(7, 7))
    ax.set_aspect("equal")
    for call in calls:
        v, c = call.vertices, call.colors
        if call.primitive == PrimitiveType.POINT:
            ax.scatter(v[:, 0], v[:, 1], s=2, c=c)
        elif call.primitive == PrimitiveType.LINE:
            n = len(v) // 2
            segs = v[:2 * n].reshape(n, 2, 2)
            ax.add_collection(LineCollection(
                segs, colors=c[:2 * n:2], linewidths=0.8))
        elif call.primitive == PrimitiveType.FILLED:
            # every 3 vertices form one triangle, exactly the GL
            # semantics of primitiverenderer.rs PrimitiveType::Filled
            n = len(v) // 3
            tris = v[:3 * n].reshape(n, 3, 2)
            # antialiasing off: abutting cell quads would otherwise show
            # seams (the GL reference rasterizes exact coverage)
            ax.add_collection(PolyCollection(
                tris, facecolors=c[:3 * n:3], edgecolors="none",
                antialiaseds=False))
    ax.autoscale_view()
    if camera is not None:
        x0, x1, y0, y1 = camera.extent()
        ax.set_xlim(x0, x1)
        ax.set_ylim(y0, y1)
    fig.savefig(path, dpi=dpi, bbox_inches="tight")
    plt.close(fig)
