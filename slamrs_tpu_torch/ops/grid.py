"""Log-odds occupancy grid: geometry, the inverse sensor model, the DDA
and dense integrators, and the endpoint likelihood.

Counterpart of ``slamrs_tpu/ops/grid.py``, with the JAX package's names
and signatures, batched over a leading particle axis where the JAX
package lifts one map with ``vmap``: ``grid`` is ``[P, H, W]`` and
``pose`` ``[P, 3]``.  The scan is one ``[B]`` set of beam lanes shared by
every particle, or ``[P, B]``, one row per particle: a fleet of worlds
runs as one call over its ``W*P`` particles with each world's scan
repeated for its particles.  A ``[B]`` scan gives the same bits as before
the ``[P, B]`` form existed.  The JAX package computes them in plain
``jnp``, with no Pallas kernel; here the dda integrator runs one
hand-written kernel on the card, the rest is plain PyTorch.

- :func:`traverse_ray` is the integer DDA walk of the reference's
  ``GridRayIterator``, a Python loop of ``max_steps`` steps carrying the
  same sequential float32 error accumulator as the JAX package's
  ``lax.scan`` (no cumulative sum or closed form: those round otherwise).
- :func:`grid_integrate_reference` adds every visited cell's log-odds
  increment with one ``index_put_(accumulate=True)`` on a flattened int64
  index.  On the card that is PyTorch's sort-based accumulate, the same
  sum for the same inputs on every call (``index_add_`` and
  ``scatter_add_`` use float atomics in arbitrary order and are not
  used).  Masked lanes add 0.0 at their particle's cell (0, 0), as the
  JAX package does, so no boolean compaction waits for the device.  The
  lanes it adds (the walk's emitted cells of present beams) are summed on
  the device into the counter ``dda.cells``
  (``utils/trace.device_counter``).  :func:`grid_integrate` runs it on
  CPU tensors; on the card it launches ``csrc/dda_integrate.cu`` once,
  which walks, models and sums each cell in that accumulate's order: the
  same bits and count.
- :func:`grid_integrate_dense` is the scatter-free polar update over a
  window around each pose; the beam lookup indexes the ``[B]`` tables
  directly (the JAX package's ``ops/lookup.radix_lookup`` is a TPU
  gather workaround and is not ported).

Divisions by the cell size and by 2*pi go through a 0-dim tensor on the
inputs' device: PyTorch's CUDA true divide by a Python scalar multiplies
by its reciprocal, which can move a ``floor`` by one cell.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math as pymath

import numpy as np
import torch

from slamrs_tpu_torch.utils import trace

Tensor = torch.Tensor

# Inverse sensor model constants (same values as the JAX package).
P_FREE = 0.30
P_OCCUPIED = 0.9
P_PRIOR = 0.5
Z_HIT = 0.9
SENSOR_MAXDIST = 1.0  # meters
TOLERANCE_CELLS = 2.0
ADDITIONAL_STEPS = 2

L_FREE = pymath.log(P_FREE / (1.0 - P_FREE))
L_OCCUPIED = pymath.log(P_OCCUPIED / (1.0 - P_OCCUPIED))
L_PRIOR = 0.0

_TWO_PI = 2.0 * pymath.pi


def _f32_scalar(v, device) -> Tensor:
    """``v`` as a 0-dim f32 tensor on ``device``; a Python number becomes
    a fill, so no synchronizing host-to-device copy is made."""
    if isinstance(v, Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.full((), float(v), dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class GridSpec2D:
    """Static geometry of an occupancy grid: cell counts are
    ceil(extent / resolution); ``position`` is the lower-left corner."""

    position_x: float
    position_y: float
    width: float  # meters
    height: float  # meters
    resolution: float  # meters per cell

    @property
    def cols(self) -> int:
        return int(pymath.ceil(self.width / self.resolution))

    @property
    def rows(self) -> int:
        return int(pymath.ceil(self.height / self.resolution))

    @property
    def shape(self) -> tuple[int, int]:
        return (self.rows, self.cols)

    def world_to_grid(self, xy: Tensor) -> Tensor:
        """Continuous world coordinates ``f32[..., 2]`` to grid ones."""
        res = _f32_scalar(self.resolution, xy.device)
        return torch.stack([(xy[..., 0] - self.position_x) / res,
                            (xy[..., 1] - self.position_y) / res], dim=-1)

    def new_grid(self, batch_shape=(), dtype=torch.float32,
                 device=None) -> Tensor:
        """A fresh log-odds grid at the prior (probability 0.5 is log-odds
        0), ``[*batch_shape, rows, cols]``."""
        return torch.zeros((*batch_shape, self.rows, self.cols), dtype=dtype,
                           device=device)

    def max_ray_steps(self, max_range_m: float) -> int:
        """Static bound on DDA steps for rays up to ``max_range_m``."""
        cells = max_range_m / self.resolution
        return int(pymath.ceil(cells * pymath.sqrt(2.0))) + ADDITIONAL_STEPS + 3


def traverse_ray(x0, y0, x1, y1, cols: int, rows: int, max_steps: int,
                 additional_steps: int = ADDITIONAL_STEPS):
    """Integer DDA walk from (x0, y0) to (x1, y1) in grid coordinates
    (``slamrs_tpu/ops/grid.py:109-185``): the step budget, the error
    accumulator (y moves when error > 0), +0.5 cell centers, and a stop
    at the first out-of-bounds cell.  The coordinates broadcast together.

    When both deltas are 0 the error is ``inf - inf = NaN``; ``NaN > 0``
    is false, so the walk steps in x by 0 and stays on its cell.

    Returns ``cols_idx i32[..., T]``, ``rows_idx i32[..., T]``,
    ``centers f32[..., T, 2]`` and ``mask bool[..., T]`` with ``T =
    max_steps``.
    """
    x0, y0, x1, y1 = torch.broadcast_tensors(
        *(torch.as_tensor(v, dtype=torch.float32) for v in (x0, y0, x1, y1)))
    i32 = torch.int32
    dx = torch.abs(x1 - x0)
    dy = torch.abs(y1 - y0)
    fx0, fy0 = torch.floor(x0), torch.floor(y0)
    fx1, fy1 = torch.floor(x1), torch.floor(y1)
    x = fx0.to(i32)
    y = fy0.to(i32)

    # step budget (ray.rs:36-66)
    zero = torch.zeros_like(x)
    n = (1 + additional_steps
         + torch.where(dx == 0.0, zero,
                       torch.where(x1 > x0, (fx1 - fx0).to(i32),
                                   (fx0 - fx1).to(i32)))
         + torch.where(dy == 0.0, zero,
                       torch.where(y1 > y0, (fy1 - fy0).to(i32),
                                   (fy0 - fy1).to(i32))))
    one = torch.ones_like(x)
    x_inc = torch.where(dx == 0.0, zero, torch.where(x1 > x0, one, -one))
    y_inc = torch.where(dy == 0.0, zero, torch.where(y1 > y0, one, -one))
    inf = torch.full_like(dx, float("inf"))
    err_x = torch.where(dx == 0.0, inf,
                        torch.where(x1 > x0, (fx0 + 1.0 - x0) * dy,
                                    (x0 - fx0) * dy))
    err_y = torch.where(dy == 0.0, inf,
                        torch.where(y1 > y0, (fy0 + 1.0 - y0) * dx,
                                    (y0 - fy0) * dx))
    error = err_x - err_y

    xs, ys, masks = [], [], []
    alive = torch.ones_like(x, dtype=torch.bool)
    for _ in range(max_steps):
        emit = (alive & (n > 0) & (x >= 0) & (x < cols) & (y >= 0)
                & (y < rows))  # ray.rs:85-90
        xs.append(x)
        ys.append(y)
        masks.append(emit)
        # advance (ray.rs:96-102): move in y when error > 0, else in x
        go_y = error > 0.0
        x = torch.where(go_y, x, x + x_inc)
        y = torch.where(go_y, y + y_inc, y)
        error = torch.where(go_y, error - dx, error + dy)
        n = n - 1
        alive = emit
    xs = torch.stack(xs, dim=-1)
    ys = torch.stack(ys, dim=-1)
    mask = torch.stack(masks, dim=-1)
    centers = torch.stack([xs.to(torch.float32) + 0.5,
                           ys.to(torch.float32) + 0.5], dim=-1)
    return xs, ys, centers, mask


def inverse_sensor_model_log_odds(distance: Tensor, measured_distance: Tensor,
                                  was_hit: Tensor,
                                  tolerance: float = TOLERANCE_CELLS
                                  ) -> Tensor:
    """Log-odds increment for a visited cell (map.rs:148-172); distances
    in cells, ``was_hit`` the beam's valid flag."""
    half = tolerance / 2.0
    hit_val = torch.where(
        distance < measured_distance - half, L_FREE,
        torch.where(distance > measured_distance + half, L_PRIOR,
                    L_OCCUPIED))
    miss_val = torch.where(distance < measured_distance, L_FREE, L_PRIOR)
    return torch.where(was_hit, hit_val, miss_val).to(torch.float32)


def scan_endpoints(pose: Tensor, angles: Tensor, distances: Tensor) -> Tensor:
    """World-frame beam endpoints ``pose.xy + R(theta) polar(angle,
    dist)``: pose ``f32[..., 3]``, angles/distances ``f32[..., B]`` ->
    ``f32[..., B, 2]``."""
    a = pose[..., 2:3] + angles
    ex = pose[..., 0:1] + torch.cos(a) * distances
    ey = pose[..., 1:2] + torch.sin(a) * distances
    return torch.stack([ex, ey], dim=-1)


def endpoint_cells(spec: GridSpec2D, pose: Tensor, angles: Tensor,
                   distances: Tensor) -> tuple[Tensor, Tensor]:
    """Each beam's endpoint in grid coordinates, ``x`` and ``y``
    ``f32[..., B]``: ``spec.world_to_grid(scan_endpoints(...))``'s values,
    with no ``[..., B, 2]`` stack made and taken apart again."""
    a = pose[..., 2:3] + angles
    res = _f32_scalar(spec.resolution, pose.device)
    return ((pose[..., 0:1] + torch.cos(a) * distances - spec.position_x)
            / res,
            (pose[..., 1:2] + torch.sin(a) * distances - spec.position_y)
            / res)


def grid_integrate(grid: Tensor, spec: GridSpec2D, pose: Tensor,
                   angles: Tensor, distances: Tensor, valid: Tensor,
                   present: Tensor, max_steps: int) -> Tensor:
    """Integrate one scan into each particle's map (map.rs:71-106): every
    present beam (valid or not) walks the DDA from the robot's cell to its
    endpoint cell (+2 overshoot) and adds the inverse-sensor-model
    log-odds; invalid beams mark free space only.

    grid ``f32[P, H, W]``; pose ``f32[P, 3]``; the scan ``[B]`` or
    ``[P, B]`` lanes; ``max_steps`` the static DDA bound
    (``spec.max_ray_steps(range)``).  Returns the updated maps in a new
    tensor.  Adds the lanes it scatters (``mask & present``) to the
    device counter ``dda.cells``, so the first call on a device must not
    fall inside a CUDA graph capture.

    CPU tensors run :func:`grid_integrate_reference`.  CUDA tensors
    (float32 ``[P, H, W]`` maps) launch ``dda_integrate_kernel`` once,
    counted in ``grid_integrate.launches``: the same bits as
    :func:`grid_integrate_reference` on the card, or raise.
    """
    if grid.device.type == "cpu":
        return grid_integrate_reference(grid, spec, pose, angles, distances,
                                        valid, present, max_steps)
    if grid.device.type != "cuda":
        raise ValueError(f"grid_integrate runs on cuda or cpu, not "
                         f"{grid.device}")
    if grid.dtype != torch.float32 or grid.dim() != 3:
        raise ValueError(f"grid_integrate takes f32[P, H, W] maps on the "
                         f"card, got {grid.dtype}{list(grid.shape)}")
    res = _f32_scalar(spec.resolution, pose.device)
    start = ((pose[:, 0] - spec.position_x) / res,
             (pose[:, 1] - spec.position_y) / res)  # [P] each
    ends = endpoint_cells(spec, pose, angles, distances)  # [P, B] each
    measured = distances / res  # [B] or [P, B]
    return _integrate_on_card(grid, start, ends, measured, valid, present,
                              max_steps)


grid_integrate.launches = 0


def grid_integrate_reference(grid: Tensor, spec: GridSpec2D, pose: Tensor,
                             angles: Tensor, distances: Tensor,
                             valid: Tensor, present: Tensor,
                             max_steps: int) -> Tensor:
    """:func:`grid_integrate` in plain PyTorch, on any device: the walk
    (:func:`traverse_ray`) of every ``[P, B, T]`` lane, the inverse sensor
    model, and one ``index_put_(accumulate=True)`` on a flattened int64
    index (the masked lanes add 0.0 at their particle's cell (0, 0))."""
    p, h, w = grid.shape
    start = spec.world_to_grid(pose[..., 0:2])  # [P, 2]
    ends = spec.world_to_grid(scan_endpoints(pose, angles,
                                             distances))  # [P, B, 2]
    measured = distances / _f32_scalar(spec.resolution,
                                       distances.device)  # [B] or [P, B]
    sx, sy = start[:, 0:1], start[:, 1:2]
    xs, ys, centers, mask = traverse_ray(sx, sy, ends[..., 0], ends[..., 1],
                                         spec.cols, spec.rows, max_steps)
    mask = mask & present[..., None]  # [P, B, T]
    # an int32 sum casts the mask to half the bytes of the default int64
    trace.device_counter("dda.cells", grid.device).add_(
        mask.sum(dtype=torch.int32))
    ddx = centers[..., 0] - sx[..., None]
    ddy = centers[..., 1] - sy[..., None]
    d = torch.sqrt(ddx * ddx + ddy * ddy)
    vals = inverse_sensor_model_log_odds(d, measured[..., None],
                                         valid[..., None])
    vals = torch.where(mask, vals, 0.0)
    cell = torch.where(mask, ys.long() * w + xs.long(), 0)
    flat = cell + (torch.arange(p, device=grid.device) * (h * w))[:, None,
                                                                   None]
    out = grid.clone(memory_format=torch.contiguous_format)
    out.view(-1).index_put_((flat.reshape(-1),), vals.reshape(-1),
                            accumulate=True)
    return out


class _DdaParams(ctypes.Structure):
    """``csrc/dda_integrate.cu``'s ``DdaIntegrateParams`` (the entry sets
    the window, ``win_rows`` and ``win_cols``)."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "particles", "beams", "steps", "rows", "cols", "win_rows",
        "win_cols", "budget0", "measured_stride", "valid_stride",
        "present_stride")] + [(name, ctypes.c_float) for name in (
            "l_free", "l_occupied", "half_tolerance")]


def _lanes(t: Tensor, p: int, b: int, dtype) -> tuple[Tensor, int]:
    """A ``[B]`` or ``[P, B]`` lane tensor as the kernel reads it: one
    contiguous row (stride 0) or ``P`` rows (stride ``B``)."""
    t = t.to(dtype).expand(p, b)
    if t.stride(0) == 0:
        return t[0].contiguous(), 0
    return t.contiguous(), b


def _ptr(t: Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _integrate_on_card(grid: Tensor, start: tuple[Tensor, Tensor],
                       ends: tuple[Tensor, Tensor], measured: Tensor,
                       valid: Tensor, present: Tensor,
                       max_steps: int) -> Tensor:
    """:func:`grid_integrate`'s kernel route from the grid coordinates
    (the start's ``x, y`` ``[P]``, the endpoints' ``[P, B]``): one launch
    of ``dda_integrate_kernel`` on the current stream into a new map
    set."""
    from slamrs_tpu_torch import kernels

    p, h, w = grid.shape
    b = ends[0].shape[-1]
    dev = grid.device
    old = grid.contiguous()
    out = torch.empty_like(old)
    start = [t.expand(p).contiguous() for t in start]
    ends = [t.expand(p, b).contiguous() for t in ends]
    measured, ms = _lanes(measured, p, b, torch.float32)
    valid, vs = _lanes(valid, p, b, torch.bool)
    present, ps = _lanes(present, p, b, torch.bool)
    counter = trace.device_counter("dda.cells", dev)
    prm = _DdaParams(
        particles=p, beams=b, steps=max_steps, rows=h, cols=w,
        budget0=1 + ADDITIONAL_STEPS, measured_stride=ms,
        valid_stride=vs, present_stride=ps,
        l_free=float(np.float32(L_FREE)),
        l_occupied=float(np.float32(L_OCCUPIED)),
        half_tolerance=float(np.float32(TOLERANCE_CELLS / 2.0)))
    lib = kernels.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.slamrs_dda_integrate(
            _ptr(old), *map(_ptr, start), *map(_ptr, ends), _ptr(measured),
            _ptr(valid), _ptr(present), _ptr(out), _ptr(counter),
            ctypes.byref(prm), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"dda_integrate kernel launch failed: CUDA error {rc} (1: the "
            f"{b} beams x {max_steps} steps on {h} x {w} maps are past its "
            f"shared-memory plan)")
    grid_integrate.launches += 1
    return out


def grid_integrate_dense(grid: Tensor, spec: GridSpec2D, pose: Tensor,
                         angles: Tensor, distances: Tensor, valid: Tensor,
                         present: Tensor, window: int,
                         multiplicity: bool = True) -> Tensor:
    """Scatter-free scan integration (``slamrs_tpu/ops/grid.py:253-350``).

    Every cell of a ``window x window`` region around each particle's pose
    (the whole grid when ``window^2 * 2 >= rows * cols``) takes its polar
    coordinates relative to the pose, looks up the covering beam of the
    uniform angle table (spacing ``angles[1] - angles[0]``), and applies
    the inverse sensor model; with ``multiplicity`` the increment is
    scaled by ``max(1, 1 / (r * dphi))``, the DDA's beam visits per cell
    near the robot.  The window origin is per particle, clipped to the
    grid.  The scan is ``[B]`` or ``[P, B]`` (each particle's own table
    and spacing).  Returns the updated maps in a new tensor.
    """
    p, rows, cols = grid.shape
    dev = grid.device
    b = angles.shape[-1]
    # one row of beam lanes per particle ([B] rows broadcast): the lookup
    # gathers from the particle's row, the same values as indexing [B]
    angles, distances, valid, present = (
        t.expand(p, b) for t in (angles, distances, valid, present))
    dphi = (angles[:, 1] - angles[:, 0] if b > 1
            else _f32_scalar(_TWO_PI, dev).expand(p))[:, None, None]
    start = spec.world_to_grid(pose[..., 0:2])  # [P, 2]
    sx, sy = start[:, 0, None, None], start[:, 1, None, None]

    full = window * window * 2 >= spec.rows * spec.cols
    wh, ww = (spec.rows, spec.cols) if full else (window, window)
    if full:
        ox = torch.zeros(p, dtype=torch.int32, device=dev)
        oy = torch.zeros(p, dtype=torch.int32, device=dev)
    else:
        ox = torch.clamp(torch.floor(start[:, 0]).to(torch.int32) - ww // 2,
                         0, max(spec.cols - ww, 0))
        oy = torch.clamp(torch.floor(start[:, 1]).to(torch.int32) - wh // 2,
                         0, max(spec.rows - wh, 0))
    wy = torch.arange(wh, dtype=torch.int32, device=dev)[None, :, None]
    wx = torch.arange(ww, dtype=torch.int32, device=dev)[None, None, :]
    cx = (ox[:, None, None] + wx).to(torch.float32) + 0.5  # [P, 1, ww]
    cy = (oy[:, None, None] + wy).to(torch.float32) + 0.5  # [P, wh, 1]
    dx = cx - sx
    dy = cy - sy
    r = torch.sqrt(dx * dx + dy * dy)  # [P, wh, ww], cell units

    # beam lookup: the cell's angle relative to the first beam, wrapped
    # to [0, 2 pi); cells past the last beam wrap to beam 0 (full-circle
    # tables) or fall outside the swept sector (absent)
    phi = torch.atan2(dy, dx) - pose[:, 2, None, None]
    rel = phi - angles[:, 0, None, None]
    rel = rel - _TWO_PI * torch.floor(rel / _f32_scalar(_TWO_PI, dev))
    beam_f = torch.round(rel / dphi)
    # a tensor numerator: ``float / tensor`` is reciprocal-then-multiply
    wrap = beam_f >= _f32_scalar(_TWO_PI, dev) / dphi - 0.5
    in_sector = wrap | (beam_f <= b - 1)
    beam = torch.where(wrap | ~in_sector, 0.0, beam_f).long()

    def lookup(lanes):  # lanes[particle, beam] for every window cell
        return torch.gather(lanes, 1, beam.reshape(p, -1)).reshape(
            beam.shape)

    d_meas = lookup(distances / _f32_scalar(spec.resolution, dev))
    pres = lookup(present) & in_sector

    inc = inverse_sensor_model_log_odds(r, d_meas, lookup(valid))
    if multiplicity:
        inc = inc * torch.clamp_min(
            1.0 / (torch.clamp_min(r, 0.5) * dphi), 1.0)
    inc = torch.where(pres, inc, 0.0)

    if full:
        return grid + inc
    pidx = torch.arange(p, device=dev)[:, None, None]
    ri = (oy.long()[:, None] + torch.arange(wh, device=dev))[:, :, None]
    ci = (ox.long()[:, None] + torch.arange(ww, device=dev))[:, None, :]
    out = grid.clone()
    out[pidx, ri, ci] = grid[pidx, ri, ci] + inc
    return out


def dense_window_for(spec: GridSpec2D, max_range_m: float,
                     align: int = 8) -> int:
    """Static window size covering the scan range (+tolerance) each side."""
    cells = int(pymath.ceil(max_range_m / spec.resolution)) \
        + ADDITIONAL_STEPS + 2
    w = min(2 * cells + 1, min(spec.rows, spec.cols))
    return max((w + align - 1) // align * align, align)


def grid_log_likelihood(grid: Tensor, spec: GridSpec2D, pose: Tensor,
                        angles: Tensor, distances: Tensor, valid: Tensor,
                        present: Tensor) -> Tensor:
    """log p(z | m, x) per particle (map.rs:113-145): for each valid beam
    whose endpoint lies in the grid, the log of ``Z_HIT * p + (1 - Z_HIT)
    / maxdist``, or of the uniform ``1 / maxdist`` where the cell is
    untouched (log-odds exactly 0), summed over the beams.

    grid ``f32[P, H, W]``, pose ``f32[P, 3]``, the scan ``[B]`` or
    ``[P, B]`` -> ``f32[P]``.
    """
    p, h, w = grid.shape
    gx, gy = endpoint_cells(spec, pose, angles, distances)  # [P, B]
    in_bounds = (gx >= 0.0) & (gy >= 0.0) & (gx < spec.cols) \
        & (gy < spec.rows)
    use = valid & present & in_bounds
    # astype(int32) truncates toward zero, then the clip
    xi = torch.clamp(gx.to(torch.int32), 0, spec.cols - 1).long()
    yi = torch.clamp(gy.to(torch.int32), 0, spec.rows - 1).long()
    odds = torch.gather(grid.reshape(p, h * w), 1, yi * w + xi)
    prob = 1.0 - 1.0 / (1.0 + torch.exp(odds))
    mixture = Z_HIT * prob + (1.0 - Z_HIT) / SENSOR_MAXDIST
    factor = torch.where(odds == 0.0,
                         torch.full_like(odds, 1.0 / SENSOR_MAXDIST), mixture)
    return torch.sum(torch.where(use, torch.log(factor), 0.0), dim=-1)
