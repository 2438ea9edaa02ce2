"""Point-to-normal ICP scan matching, fixed iteration count.

Counterpart of ``slamrs_tpu/ops/icp.py``.  Per iteration: transform the
source points by the accumulated pose, find each one's nearest neighbour
in the reference cloud, accumulate the 3-DoF Gauss-Newton normal
equations of the point-to-normal errors, solve them in closed form and
renormalize the angle.  Normals are central differences of neighbouring
reference points; weights are uniform or a step on the squared error.

Every function takes leading batch dims, so one call serves a single
world (``p [Np, 2]``) and a batch of problems (``p [B, Np, 2]``).
Point clouds are fixed-capacity buffers: reference lanes at or past
``q_count`` are pushed out of the argmin, masked source lanes get
weight 0, and the reference's endpoint lanes have zero normals.

Correspondence is K4: :func:`nearest_neighbors_fused` is the wrapper of
the hand-written CUDA kernel ``csrc/nn_argmin.cu``, which replaces the
Pallas kernel ``slamrs_tpu/ops/icp.py::nearest_neighbors_fused``.  On a
CPU tensor it runs :func:`nearest_neighbors_reference`, the plain
PyTorch version of the same per-pair arithmetic; on a CUDA tensor it
launches the kernel, one launch a call, or raises.
:func:`nearest_neighbors_chunked_reference` is the kernel's split of the
q axis and its in-order merge, and :func:`nn_plan` its launch shape.
The JAX package's XLA form
(``icp.py:158``, a ``[Np, Nq]`` distance matrix through device memory)
has no counterpart in the port: :func:`nearest_neighbors` keeps its
contract and routes through K4.

The rest of an iteration (the gathers, the normals where they are read,
the residuals, the weighted 3x3 normal equations, their closed-form
solve, the angle wrap and the source under the new pose) is
:func:`icp_solve`, the wrapper of the hand-written CUDA kernel
``csrc/icp_solve.cu``, one launch an iteration on the card;
:func:`solve_step_reference` is its plain version, which CPU tensors
run.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from slamrs_tpu_torch.utils import trace

Tensor = torch.Tensor

_BIG = 1e30  # pushes reference lanes at or past q_count out of the argmin


class IcpResult(NamedTuple):
    transformation: Tensor  # f32[..., 3] (x, y, theta)
    transformed_points: Tensor  # f32[..., Np, 2] source under the final pose
    chi_values: Tensor  # f32[..., iterations]


def rot2(theta: Tensor) -> Tensor:
    """R(theta), f32[..., 2, 2]."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)


def drot2(theta: Tensor) -> Tensor:
    """dR/dtheta, f32[..., 2, 2]."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([-s, -c], -1), torch.stack([c, -s], -1)],
                       -2)


def transform_points(points: Tensor, x: Tensor) -> Tensor:
    """R(x2) p + (x0, x1).  points [..., N, 2], x [..., 3]."""
    return points @ rot2(x[..., 2]).transpose(-1, -2) + x[..., None, 0:2]


def nearest_neighbors_reference(p: Tensor, q: Tensor,
                                q_count: Tensor) -> Tensor:
    """Plain PyTorch version of K4 (any leading batch dims): per pair
    ``d2 = q2 - 2 (px qx + py qy)`` with ``q2 = qx qx + qy qy`` plus
    ``1e30`` on lanes at or past ``q_count``, each product and sum
    rounded on its own; the first index of the minimum (``torch.argmin``
    breaks ties to the first), clamped to ``Nq - 1``, and 0 where
    ``q_count == 0``.  p [..., Np, 2], q [..., Nq, 2] -> i32[..., Np]."""
    nq = q.shape[-2]
    qx, qy = q[..., 0], q[..., 1]
    valid = torch.arange(nq, device=q.device) < q_count[..., None]
    q2 = qx * qx + qy * qy + torch.where(valid, 0.0, _BIG)
    px, py = p[..., :, None, 0], p[..., :, None, 1]
    d2 = q2[..., None, :] - 2.0 * (px * qx[..., None, :]
                                   + py * qy[..., None, :])
    idx = torch.clamp_max(torch.argmin(d2, dim=-1), nq - 1).to(torch.int32)
    return torch.where(q_count[..., None] > 0, idx, 0)


def nearest_neighbors_chunked_reference(p: Tensor, q: Tensor,
                                        q_count: Tensor,
                                        chunk: int) -> Tensor:
    """K4's split and merge in PyTorch (tests and ``chip_smoke.py``
    only): the lanes ``[0, q_count)`` in chunks of ``chunk``, each chunk's
    partial the first index of its minimum, the partials merged in chunk
    order with a strict ``<``; lanes at or past ``q_count`` are skipped,
    not pushed out by ``1e30``.  Equal to
    :func:`nearest_neighbors_reference` while every valid ``|d2|`` is far
    below ``1e30``.  p [..., Np, 2], q [..., Nq, 2] -> i32[..., Np]."""
    nq = q.shape[-2]
    qv = torch.clamp(q_count, 0, nq)[..., None, None]
    qx, qy = q[..., None, :, 0], q[..., None, :, 1]
    px, py = p[..., :, None, 0], p[..., :, None, 1]
    d2 = (qx * qx + qy * qy) - 2.0 * (px * qx + py * qy)
    lane = torch.arange(nq, device=q.device)
    d2 = torch.where(lane < qv, d2, torch.inf)
    best = torch.full(d2.shape[:-1], torch.inf, device=q.device)
    idx = torch.zeros(d2.shape[:-1], dtype=torch.int64, device=q.device)
    for j0 in range(0, nq, chunk):
        part = d2[..., j0:j0 + chunk]
        at = torch.argmin(part, dim=-1)  # the first index of its minimum
        val = torch.gather(part, -1, at[..., None])[..., 0]
        take = val < best
        best = torch.where(take, val, best)
        idx = torch.where(take, at + j0, idx)
    idx = torch.clamp_max(idx, nq - 1).to(torch.int32)
    return torch.where(q_count[..., None] > 0, idx, 0)


_LANES = 4  # p lanes per thread of K4
_SMS = 132  # streaming multiprocessors of an H100 SXM
_MAX_CHUNK = 2048  # q points a K4 CTA stages: 32 KB of shared memory


@functools.lru_cache(maxsize=64)
def nn_plan(b: int, n_p: int, nq: int, sms: int = _SMS
            ) -> tuple[int, int, int]:
    """K4's launch shape for ``b`` problems of ``n_p`` x ``nq`` lanes on a
    card of ``sms`` streaming multiprocessors: (threads per group ``L``,
    groups per CTA ``G``, q chunks ``C``).  A CTA holds ``4 L`` p lanes;
    with enough of those tiles to fill the card twice, two groups of up
    to three warps, each over half the q axis (bench.py's batch);
    otherwise 128-lane tiles of eight one-warp groups and the q axis
    split until the tiles times the chunks fill the SMs (the ICP mapper's
    one problem, or an ICP fleet's ``b = W``)."""
    wide = min(96, -(-n_p // (_LANES * 32)) * 32)
    tiles = b * -(-n_p // (wide * _LANES))
    min_chunks = -(-nq // _MAX_CHUNK)
    if tiles >= 2 * sms:
        return wide, 2, min_chunks
    tiles = b * -(-n_p // (32 * _LANES))
    return 32, 8, min(max(-(-sms // tiles), min_chunks), nq)


@functools.lru_cache(maxsize=16)
def _sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


_COUNTERS: dict[tuple[int, int], Tensor] = {}


def _arrival_counters(device: torch.device, stream: int, n: int) -> Tensor:
    """K4's per-tile arrival counters on ``device`` for ``stream``: zeros
    that the kernel leaves at zero, kept across calls (grown, never
    shrunk), one set per stream so that concurrent calls do not share.
    A CUDA graph captured on ``stream`` keeps the set's address, so the
    set must exist before the capture (``graph/capture.py`` runs a frame
    eagerly on the capture stream first); making one inside it raises."""
    key = (device.index, stream)
    cnt = _COUNTERS.get(key)
    if cnt is None or cnt.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "K4's arrival counters for this stream must be made before "
                "a CUDA graph capture (run the call once on the stream)")
        cnt = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[key] = cnt
    return cnt


def _ptr(t: Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def check_inputs(p: Tensor, q: Tensor, q_count: Tensor) -> None:
    """What K4 takes: contiguous, 8-byte-aligned f32 ``p [B, Np, 2]`` and
    ``q [B, Nq, 2]`` with ``Nq > 0`` and contiguous i32 ``q_count [B]``,
    on one device.  Raises otherwise."""
    if p.dim() != 3 or q.dim() != 3 or p.shape[-1] != 2 or q.shape[-1] != 2 \
            or p.shape[0] != q.shape[0]:
        raise ValueError(f"p and q must be [B, N, 2] of one B, got "
                         f"{list(p.shape)} and {list(q.shape)}")
    if q.shape[1] == 0:
        raise ValueError("q must hold at least one lane")
    if q.shape[1] >= 2**31 - 1 or p.shape[0] * p.shape[1] >= 2**31:
        raise ValueError("K4 indexes lanes with 32-bit integers")
    for name, t in (("p", p), ("q", q)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous f32, got {t.dtype}")
    if q_count.shape != (p.shape[0],) or q_count.dtype != torch.int32 \
            or not q_count.is_contiguous():
        raise ValueError(f"q_count must be contiguous i32[{p.shape[0]}], "
                         f"got {q_count.dtype}{list(q_count.shape)}")
    for name, t in (("q", q), ("q_count", q_count)):
        if t.device != p.device:
            raise ValueError(f"{name} is on {t.device}, p on {p.device}")
    if p.data_ptr() % 8 or q.data_ptr() % 8:
        raise ValueError("p and q must be 8-byte aligned (read as float2)")


def nearest_neighbors_fused(p: Tensor, q: Tensor, q_count: Tensor) -> Tensor:
    """Index into q of the closest point for every p lane: p [B, Np, 2],
    q [B, Nq, 2], q_count i32[B] -> i32[B, Np] (the contract of the
    JAX package's Pallas kernel).  On CUDA the kernel reads ``q_count``
    on the device, so the host never waits."""
    if p.device.type == "cpu":
        return nearest_neighbors_reference(p, q, q_count)
    check_inputs(p, q, q_count)
    if p.device.type != "cuda":
        raise ValueError(f"nearest_neighbors_fused runs on cuda or cpu, not "
                         f"{p.device}")
    return launch_kernel(p, q, q_count)


def launch_kernel(p: Tensor, q: Tensor, q_count: Tensor) -> Tensor:
    """Launch K4 on validated inputs (see :func:`nearest_neighbors_fused`)
    on the current stream; counts the launch in
    ``nearest_neighbors_fused.launches``."""
    from slamrs_tpu_torch import kernels

    lib = kernels.library()
    b, n_p, nq = p.shape[0], p.shape[1], q.shape[1]
    threads, groups, chunks = nn_plan(
        b, n_p, nq, _sm_count(p.device.index if p.device.index is not None
                              else torch.cuda.current_device()))
    out = torch.empty((b, n_p), dtype=torch.int32, device=p.device)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        partials = counters = None
        if chunks > 1:  # (d2, index) per lane and chunk, merged on the card
            tiles = b * -(-n_p // (threads * _LANES))
            partials = torch.empty(tiles * chunks * threads * _LANES * 2,
                                   dtype=torch.float32, device=p.device)
            counters = _arrival_counters(p.device, stream, tiles)
        rc = lib.slamrs_nn_argmin(_ptr(p), _ptr(q), _ptr(q_count),
                                  _ptr(partials), _ptr(counters), _ptr(out),
                                  b, n_p, nq, threads, groups, chunks,
                                  ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"nn_argmin kernel launch failed: CUDA error {rc}")
    nearest_neighbors_fused.launches += 1
    return out


nearest_neighbors_fused.launches = 0


def nearest_neighbors(p: Tensor, q: Tensor, q_count: Tensor) -> Tensor:
    """Index into q of the closest point for every p lane, over any
    leading batch dims (the contract of the JAX package's XLA form):
    p [..., Np, 2], q [..., Nq, 2], q_count i32[...] -> i32[..., Np].
    The batch is flattened into K4's ``B``."""
    batch = p.shape[:-2]
    out = nearest_neighbors_fused(
        p.reshape(-1, *p.shape[-2:]).contiguous(),
        q.reshape(-1, *q.shape[-2:]).contiguous(),
        q_count.reshape(-1).to(torch.int32).contiguous())
    return out.reshape(*batch, p.shape[-2])


def icp_point_to_normal(p: Tensor, p_mask: Tensor, q: Tensor,
                        q_count: Tensor, initial_pose: Tensor,
                        iterations: int = 10,
                        step_threshold: float | None = None,
                        pallas_nn: bool = False) -> IcpResult:
    """Fixed-iteration point-to-normal ICP.

    p f32[..., Np, 2] source points (padded), p_mask bool[..., Np];
    q f32[..., Nq, 2] reference points (padded, ordered), q_count
    i32[...]; initial_pose f32[..., 3].  ``step_threshold`` None gives
    uniform weights, a float the step weight ``e*e < threshold**2``.

    ``pallas_nn`` is kept for the JAX package's signature and changes
    nothing: in the port every correspondence step goes through K4
    (:func:`nearest_neighbors`), on the card the kernel.

    On CPU tensors each iteration is K4's plain version and
    :func:`solve_step_reference`; on CUDA tensors a call is a prologue
    launch of :func:`icp_solve` (the source under the initial pose), then
    per iteration one K4 launch and one :func:`icp_solve` launch, or it
    raises.

    The pairs K4 compares, ``iterations x Np x q_count`` summed over the
    batch, are added on the device to the counter ``k4.pairs``
    (``utils/trace.device_counter``), once a call.
    """
    del pallas_nn
    pairs = q_count if q_count.dim() == 0 else q_count.sum()
    trace.device_counter("k4.pairs", q.device).add_(
        pairs, alpha=iterations * p.shape[-2])
    if p.device.type != "cpu":
        return _icp_on_card(p, p_mask, q, q_count, initial_pose, iterations,
                            step_threshold)
    x = initial_pose
    p_t = transform_points(p, x)
    chis = []
    for _ in range(iterations):
        corr = nearest_neighbors(p_t, q, q_count)
        x, p_t, chi = solve_step_reference(p, p_mask, q, q_count, x, p_t,
                                           corr, step_threshold)
        chis.append(chi)
    return IcpResult(transformation=x, transformed_points=p_t,
                     chi_values=torch.stack(chis, dim=-1))


def normals_at(q: Tensor, q_count: Tensor, idx: Tensor) -> Tensor:
    """Central-difference normals of an ordered point sequence at the
    lanes ``idx``: ``normalize(perp(q[i+1] - q[i-1]))`` on interior lanes,
    zero at the endpoints and everywhere for sequences shorter than 3
    (icp.rs:226-254), computed only where they are read.  q [..., Nq, 2],
    q_count i32[...] real (leading) lanes, idx [..., Np] integer lanes in
    ``[0, Nq)`` -> f32[..., Np, 2].  The neighbours ``q[idx +- 1]`` wrap
    at ``Nq`` (``icp_solve_kernel`` repeats this)."""
    nq = q.shape[-2]
    idx = idx.long()

    def at(j: Tensor) -> Tensor:
        return torch.gather(q, -2, j[..., None].expand(*j.shape, 2))

    diff = at((idx + 1) % nq) - at((idx - 1) % nq)
    perp = torch.stack([-diff[..., 1], diff[..., 0]], dim=-1)
    norm = torch.sqrt(torch.sum(perp * perp, dim=-1, keepdim=True))
    normal = torch.where(norm > 0.0,
                         perp / torch.where(norm > 0.0, norm, 1.0), 0.0)
    qc = q_count[..., None]
    interior = (idx >= 1) & (idx < qc - 1) & (qc > 2)
    return torch.where(interior[..., None], normal, 0.0)


def solve_step_reference(p: Tensor, p_mask: Tensor, q: Tensor,
                         q_count: Tensor, x: Tensor, p_t: Tensor,
                         corr: Tensor, step_threshold: float | None
                         ) -> tuple[Tensor, Tensor, Tensor]:
    """The plain version of one ``icp_solve_kernel`` iteration, after K4:
    from the pose ``x [..., 3]``, the source under it ``p_t`` and K4's
    indices ``corr [..., Np]`` into ``q``, the Gauss-Newton step of the
    point-to-normal errors.  Returns ``(x', p under x', chi)``, chi the
    masked sum of ``e * e``."""
    corr = corr.long()
    qc = torch.gather(q, -2, corr[..., None].expand(*corr.shape, 2))
    nc = normals_at(q, q_count, corr)

    # e_i = n_i . (R p_i + t - q_i), J_i = n_i^T [I | dR p_i]
    e = torch.sum(nc * (p_t - qc), dim=-1)
    d_rp = p @ drot2(x[..., 2]).transpose(-1, -2)
    jac = torch.cat([nc, torch.sum(nc * d_rp, dim=-1, keepdim=True)], -1)

    if step_threshold is None:
        w = torch.ones_like(e)
    else:
        w = (e * e < step_threshold * step_threshold).to(e.dtype)
    w = w * p_mask.to(e.dtype)

    h = torch.einsum("...ni,...nj->...ij", jac * w[..., None], jac)
    g = torch.einsum("...ni,...n->...i", jac, w * e)
    chi = torch.sum(torch.where(p_mask, e * e, 0.0), dim=-1)

    x = x + _pinv_solve(h, -g)
    theta = torch.atan2(torch.sin(x[..., 2]), torch.cos(x[..., 2]))
    x = torch.cat([x[..., 0:2], theta[..., None]], dim=-1)
    return x, transform_points(p, x), chi


def check_solve_inputs(p: Tensor, p_mask: Tensor, q: Tensor,
                       q_count: Tensor, x: Tensor) -> None:
    """What ``icp_solve_kernel`` takes besides K4's inputs
    (:func:`check_inputs`): contiguous bool ``p_mask [B, Np]`` and f32
    ``x [B, 3]`` on ``p``'s device.  Raises otherwise."""
    check_inputs(p, q, q_count)
    b, n_p = p.shape[:2]
    if p_mask.shape != (b, n_p) or p_mask.dtype != torch.bool \
            or not p_mask.is_contiguous():
        raise ValueError(f"p_mask must be contiguous bool[{b}, {n_p}], got "
                         f"{p_mask.dtype}{list(p_mask.shape)}")
    if x.shape != (b, 3) or x.dtype != torch.float32 \
            or not x.is_contiguous():
        raise ValueError(f"the pose must be contiguous f32[{b}, 3], got "
                         f"{x.dtype}{list(x.shape)}")
    for name, t in (("p_mask", p_mask), ("the pose", x)):
        if t.device != p.device:
            raise ValueError(f"{name} is on {t.device}, p on {p.device}")


def _icp_on_card(p: Tensor, p_mask: Tensor, q: Tensor, q_count: Tensor,
                 initial_pose: Tensor, iterations: int,
                 step_threshold: float | None) -> IcpResult:
    """:func:`icp_point_to_normal` on CUDA tensors: the leading dims
    flattened into ``B`` problems, a prologue, then K4 and
    ``icp_solve_kernel`` per iteration, the pose and the source carried in
    place on the device."""
    batch = p.shape[:-2]
    if p_mask.shape[:-1] != batch or q.shape[:-2] != batch \
            or q_count.shape != batch or initial_pose.shape[:-1] != batch:
        raise ValueError(
            f"ICP on the card takes one leading shape for every input, got "
            f"p {list(p.shape)}, p_mask {list(p_mask.shape)}, q "
            f"{list(q.shape)}, q_count {list(q_count.shape)} and the pose "
            f"{list(initial_pose.shape)}")
    n_p, nq = p.shape[-2], q.shape[-2]
    p = p.reshape(-1, n_p, 2).contiguous()
    p_mask = p_mask.reshape(-1, n_p).contiguous()
    q = q.reshape(-1, nq, 2).contiguous()
    q_count = q_count.reshape(-1).to(torch.int32).contiguous()
    x0 = initial_pose.reshape(-1, 3).contiguous()
    check_solve_inputs(p, p_mask, q, q_count, x0)
    if p.device.type != "cuda":
        raise ValueError(f"icp_point_to_normal runs on cuda or cpu, not "
                         f"{p.device}")
    x = torch.empty_like(x0)
    p_t = torch.empty_like(p)
    chi = torch.empty((p.shape[0], iterations), dtype=torch.float32,
                      device=p.device)
    icp_solve(p, p_mask, q, q_count, None, x0, x, p_t, chi, 0,
              step_threshold)
    for k in range(iterations):
        corr = nearest_neighbors(p_t, q, q_count)
        icp_solve(p, p_mask, q, q_count, corr, x, x, p_t, chi, k,
                  step_threshold)
    return IcpResult(transformation=x.reshape(*batch, 3),
                     transformed_points=p_t.reshape(*batch, n_p, 2),
                     chi_values=chi.reshape(*batch, iterations))


def icp_solve(p: Tensor, p_mask: Tensor, q: Tensor, q_count: Tensor,
              corr: Tensor | None, x_in: Tensor, x_out: Tensor, p_t: Tensor,
              chi: Tensor, k: int, step_threshold: float | None) -> None:
    """Launch ``icp_solve_kernel`` (``csrc/icp_solve.cu``) once on the
    current stream, on inputs :func:`check_solve_inputs` passed: with
    ``corr`` (K4's i32 ``[B, Np]``) iteration ``k`` of
    :func:`solve_step_reference`, writing the pose to ``x_out`` (which may
    be ``x_in``), the source under it to ``p_t`` in place and ``chi[:,
    k]``; without, the prologue ``x_out = x_in``, ``p_t = R p + t``.
    Counts the launch in ``icp_solve.launches``."""
    from slamrs_tpu_torch import kernels

    b, n_p, nq = p.shape[0], p.shape[1], q.shape[1]
    if p_t.shape != p.shape or x_out.shape != x_in.shape \
            or chi.shape[0] != b or not (0 <= k < max(chi.shape[1], 1)) \
            or (corr is not None and (corr.shape != (b, n_p)
                                      or corr.dtype != torch.int32)):
        raise ValueError("icp_solve's outputs or indices do not fit its "
                         "inputs")
    lib = kernels.library()
    thr = 0.0 if step_threshold is None else step_threshold * step_threshold
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        rc = lib.slamrs_icp_solve(
            _ptr(p), _ptr(p_mask), _ptr(q), _ptr(q_count), _ptr(corr),
            _ptr(x_in), _ptr(x_out), _ptr(p_t), _ptr(chi), b, n_p, nq,
            chi.shape[1], k, int(step_threshold is not None),
            ctypes.c_float(thr), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"icp_solve kernel launch failed: CUDA error {rc}")
    icp_solve.launches += 1


icp_solve.launches = 0


def _pinv_solve(h: Tensor, b: Tensor, rcond: float = 1e-8) -> Tensor:
    """Solve the symmetric PSD 3x3 system ``h dx = b`` in closed form:
    the adjugate (Cramer) solve with a relative Tikhonov floor
    ``rcond * trace`` on the diagonal, which only acts when ``h`` is
    numerically singular (``icp.py:256-286``)."""
    tr = h[..., 0, 0] + h[..., 1, 1] + h[..., 2, 2]
    lam = (rcond * torch.clamp_min(tr, 1e-30))[..., None, None]
    a_mat = h + lam * torch.eye(3, dtype=h.dtype, device=h.device)

    a, bb, c = a_mat[..., 0, 0], a_mat[..., 0, 1], a_mat[..., 0, 2]
    d, e, f = a_mat[..., 1, 1], a_mat[..., 1, 2], a_mat[..., 2, 2]
    # cofactors of the symmetric matrix [[a, b, c], [b, d, e], [c, e, f]]
    c00 = d * f - e * e
    c01 = c * e - bb * f
    c02 = bb * e - c * d
    c11 = a * f - c * c
    c12 = bb * c - a * e
    c22 = a * d - bb * bb
    det = a * c00 + bb * c01 + c * c02
    inv_det = torch.where(torch.abs(det) > 1e-30, 1.0 / det, 0.0)
    x0 = c00 * b[..., 0] + c01 * b[..., 1] + c02 * b[..., 2]
    x1 = c01 * b[..., 0] + c11 * b[..., 1] + c12 * b[..., 2]
    x2 = c02 * b[..., 0] + c12 * b[..., 1] + c22 * b[..., 2]
    return torch.stack([x0, x1, x2], dim=-1) * inv_det[..., None]
