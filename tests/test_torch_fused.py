"""slamrs_tpu_torch.ops.fused against slamrs_tpu.ops.fused.

The port's ``fused_update`` on CPU tensors runs its plain PyTorch
version; it is held against the JAX Pallas kernel (interpret mode, with
the lineage ``ancestors``) and against the JAX ``fused_update_reference``
on the maps gathered by lineage.  Gates as in ``tests/test_fused.py``:
the fraction of cells with |diff| > 0.01 below 1e-4 (rare atan2 bin
flips: the TPU kernel uses a minimax polynomial, the port the library
atan2), and the likelihood within rtol 1e-5 / atol 1e-4 (sums taken in
another order).  The CUDA kernel itself runs only on a GPU; chip_smoke.py
holds it against this plain version there.

The kernel computes only the scan disc's bounding box
(``cell_pass_box``); the box tests show that the plain version, and the
JAX reference it copies, change no cell outside that box, by value (a
``-0.0`` cell is the one difference bits could show: the full-width pass
turns it into ``+0.0``; no map grown from a ``+0`` prior holds one).
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from slamrs_tpu.ops import fused as jf  # noqa: E402
from slamrs_tpu.ops.grid import GridSpec2D as JSpec  # noqa: E402
from slamrs_tpu_torch.ops import fused as tf  # noqa: E402
from slamrs_tpu_torch.ops import grid as tgrid  # noqa: E402
from slamrs_tpu_torch.ops.grid import GridSpec2D as TSpec  # noqa: E402

SPEC_ARGS = (-2.0, -2.0, 4.0, 4.0, 0.05)
P = 16
FLIP_GATE = 1e-4
LIK_RTOL, LIK_ATOL = 1e-5, 1e-4
DPHI = math.radians(1.0)


def _flip(a, b):
    a = np.asarray(jnp.asarray(a, jnp.float32)) if not isinstance(
        a, torch.Tensor) else a.float().numpy()
    b = np.asarray(jnp.asarray(b, jnp.float32)) if not isinstance(
        b, torch.Tensor) else b.float().numpy()
    return float((np.abs(a - b) > 0.01).mean())


def _case(num_beams, seed=0):
    """16 maps holding log-odds (~30 % exact zeros), poses inside the map,
    non-identity ancestors, a scan with mixed present/valid flags."""
    rng = np.random.default_rng(seed)
    grids = rng.normal(scale=1.5, size=(P, 80, 128)).astype(np.float32)
    grids[rng.uniform(size=grids.shape) < 0.3] = 0.0
    poses = np.stack([rng.uniform(-1.3, 1.3, P), rng.uniform(-1.3, 1.3, P),
                      rng.uniform(-3.0, 3.0, P)], -1).astype(np.float32)
    anc = rng.integers(0, P, P).astype(np.int32)
    anc[0] = P - 1  # never the identity
    dist = rng.uniform(0.1, 1.0, num_beams).astype(np.float32)
    valid = rng.uniform(size=num_beams) < 0.8
    present = rng.uniform(size=num_beams) < 0.9
    if num_beams == 360:
        present[350:] = False
    return grids, poses, anc, dist, valid, present


@pytest.mark.parametrize("num_beams", [360, 90])
@pytest.mark.parametrize("static", [True, False], ids=["static", "traced"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_update_matches_jax(num_beams, static, dtype):
    grids, poses, anc, dist, valid, present = _case(num_beams)
    jspec, tspec = JSpec(*SPEC_ARGS), TSpec(*SPEC_ARGS)
    jg = jnp.asarray(grids).astype(dtype)
    tg = torch.from_numpy(grids).to(getattr(torch, dtype))
    a0 = np.float32(0.1)
    jdphi = DPHI if static else jnp.float32(DPHI)
    tdphi = DPHI if static else torch.tensor(DPHI, dtype=torch.float32)

    g_k, l_k = jf.fused_update(jg, poses, a0, dist, valid, present, jspec,
                               num_beams, 1.0, interpret=True,
                               ancestors=jnp.asarray(anc), dphi=jdphi)
    g_r, l_r = jf.fused_update_reference(jg[anc], poses, a0, dist, valid,
                                         present, jspec, num_beams, 1.0,
                                         dphi=jdphi)
    g_t, l_t = tf.fused_update(tg, torch.from_numpy(poses), torch.tensor(a0),
                               torch.from_numpy(dist), torch.from_numpy(valid),
                               torch.from_numpy(present), tspec, num_beams,
                               1.0, ancestors=torch.from_numpy(anc),
                               dphi=tdphi)
    assert g_t.dtype == tg.dtype and g_t.shape == tg.shape
    for name, g_j, l_j in (("kernel", g_k, l_k), ("reference", g_r, l_r)):
        flip = _flip(g_j, g_t)
        assert flip < FLIP_GATE, f"{name}: flip fraction {flip}"
        np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j),
                                   rtol=LIK_RTOL, atol=LIK_ATOL)
    # the input maps are left as they were
    assert torch.equal(tg, torch.from_numpy(grids).to(tg.dtype))


def test_identity_lineage_is_the_default():
    grids, poses, _, dist, valid, present = _case(360, seed=1)
    spec = TSpec(*SPEC_ARGS)
    args = (torch.from_numpy(grids), torch.from_numpy(poses), 0.0,
            torch.from_numpy(dist), torch.from_numpy(valid),
            torch.from_numpy(present), spec, 360, 1.0)
    g0, l0 = tf.fused_update(*args)
    g1, l1 = tf.fused_update(*args, ancestors=torch.arange(P,
                                                           dtype=torch.int32))
    assert torch.equal(g0, g1) and torch.equal(l0, l1)


@pytest.mark.parametrize("res,rng_m", [(0.05, 1.0), (0.02, 1.0), (0.1, 5.0),
                                        (0.02, 4.0)])
def test_static_helpers(res, rng_m):
    j, t = JSpec(-2.0, -2.0, 4.0, 4.0, res), TSpec(-2.0, -2.0, 4.0, 4.0, res)
    assert (t.rows, t.cols) == (j.rows, j.cols)
    assert tf.window_rows(t, rng_m) == jf.window_rows(j, rng_m)
    assert tf.pack3_quantum(rng_m / res) == jf.pack3_quantum(rng_m / res)


def test_quantize_d_enc():
    enc = np.array([0.0, -0.0, 1e-6, -1e-6, 0.3, -7.77, 20.06, 70.0, -80.0],
                   np.float32)
    for qu in (0.125, 0.25):
        j = np.asarray(jf.quantize_d_enc(jnp.asarray(enc), qu))
        t = tf.quantize_d_enc(torch.from_numpy(enc), qu).numpy()
        np.testing.assert_array_equal(t, j)
        np.testing.assert_array_equal(np.signbit(t), np.signbit(j))


@pytest.mark.parametrize("with_angles", [True, False])
def test_encode_beam_table(with_angles):
    _, _, _, dist, valid, present = _case(90, seed=2)
    dist[:3] = 0.0  # zero-distance valid hits get the tiny floor
    kw_j = dict(angles0=np.float32(0.1), dphi=np.float32(DPHI)) \
        if with_angles else {}
    kw_t = dict(angles0=0.1, dphi=DPHI) if with_angles else {}
    j = np.asarray(jf.encode_beam_table(jnp.asarray(dist / 0.05), valid,
                                        present, **kw_j))
    t = tf.encode_beam_table(torch.from_numpy(dist / 0.05),
                             torch.from_numpy(valid),
                             torch.from_numpy(present), **kw_t).numpy()
    assert t.shape == j.shape == (8, tf.BEAM_PAD)
    exact = [0, 1, 4, 5, 6, 7] if with_angles else list(range(8))
    np.testing.assert_array_equal(t[exact], j[exact])
    np.testing.assert_array_equal(np.signbit(t[0]), np.signbit(j[0]))
    # cos/sin rows: one float32 ulp between the libraries
    np.testing.assert_allclose(t[2:4], j[2:4], rtol=0, atol=1e-6)


def test_kernel_constants_match_python():
    """The float32 constants written into the CUDA source (the device code
    K1 and K3 share) equal the float32 roundings of the Python constants
    they stand for."""
    src = (Path(tf.__file__).parents[1] / "csrc"
           / "fused_common.cuh").read_text()
    consts = dict(re.findall(r"constexpr float (k\w+) = ([-0-9.e]+)f;", src))
    want = {"kTwoPi": 2 * math.pi, "kInvTwoPi": 1 / (2 * math.pi),
            "kLFree": tgrid.L_FREE, "kLOccupied": tgrid.L_OCCUPIED,
            "kZHit": tgrid.Z_HIT,
            "kMissMix": (1.0 - tgrid.Z_HIT) / tgrid.SENSOR_MAXDIST,
            "kInvMaxDist": 1.0 / tgrid.SENSOR_MAXDIST,
            "kHalfTol": tgrid.TOLERANCE_CELLS / 2.0}
    assert set(want) <= set(consts)
    for name, value in want.items():
        assert np.float32(float(consts[name])) == np.float32(value), name
    # and the JAX package's constants are the same numbers
    from slamrs_tpu.ops import grid as jgrid
    for name in ("L_FREE", "L_OCCUPIED", "Z_HIT", "SENSOR_MAXDIST",
                 "TOLERANCE_CELLS", "ADDITIONAL_STEPS", "P_FREE",
                 "P_OCCUPIED"):
        assert getattr(tgrid, name) == getattr(jgrid, name), name


def test_wrapper_rejects_other_devices():
    """No fallback: a tensor that is neither on the CPU nor on CUDA is
    refused instead of being moved."""
    grids = torch.zeros(2, 80, 128, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tf.fused_update(grids, torch.zeros(2, 3, device="meta"), 0.0,
                        torch.zeros(360, device="meta"),
                        torch.zeros(360, dtype=torch.bool, device="meta"),
                        torch.zeros(360, dtype=torch.bool, device="meta"),
                        TSpec(*SPEC_ARGS), 360, 1.0)


def test_prepare_rejects_unsupported_geometry():
    grids, poses, _, dist, valid, present = _case(360)
    spec = TSpec(*SPEC_ARGS)
    with pytest.raises(ValueError, match="padded to 128"):
        tf.fused_update(torch.from_numpy(grids[:, :, :100].copy()),
                        torch.from_numpy(poses), 0.0, torch.from_numpy(dist),
                        torch.from_numpy(valid), torch.from_numpy(present),
                        spec, 360, 1.0)


BOX_SPEC = (-3.2, -3.2, 12.8, 6.4, 0.05)  # 128 x 256 cells
CONFIG3 = (-25.0, -25.0, 50.0, 50.0, 0.05)  # 1,000 x 1,000 cells
P_BOX = 8


def _box_case(scan, seed=5):
    """Maps, poses and a scan for the box tests.  ``within``: beams inside
    the 1 m range; ``over_range``: a third of them out to 5 m, past the
    range and the quantizer's cap (511 x 0.125 cells); ``unquantized``:
    382 beams (no quantization) with one 4 m beam; ``edges``: poses on the
    grid's column and row edges and corners; ``config3``: BASELINE config
    3's 50 x 50 m grid."""
    x, y, w, h, res = geom = CONFIG3 if scan == "config3" else BOX_SPEC
    spec = TSpec(*geom)
    rng = np.random.default_rng(seed)
    nb = 382 if scan == "unquantized" else 360
    cols = (spec.cols + 127) // 128 * 128
    grids = rng.normal(scale=1.5, size=(P_BOX, spec.rows, cols)).astype(
        np.float32)
    grids[rng.uniform(size=grids.shape) < 0.3] = 0.0
    poses = np.stack([rng.uniform(x + 0.3, x + w - 0.3, P_BOX),
                      rng.uniform(y + 0.3, y + h - 0.3, P_BOX),
                      rng.uniform(-3.0, 3.0, P_BOX)], -1).astype(np.float32)
    dist = rng.uniform(0.1, 1.0, nb).astype(np.float32)
    valid = rng.uniform(size=nb) < 0.8
    present = rng.uniform(size=nb) < 0.9
    if scan == "over_range":
        dist[::3] = rng.uniform(1.0, 5.0, dist[::3].shape)
    if scan == "unquantized":
        dist[7], valid[7], present[7] = 4.0, True, True
    if scan == "edges":
        poses[0, 0], poses[1, 0] = x + 0.01, x + w - 0.01
        poses[2, 1], poses[3, 1] = y + 0.01, y + h - 0.01
        poses[4, :2] = x + 0.01, y + 0.01
        poses[5, :2] = x + w - 0.01, y + h - 0.01
    dphi = 2 * math.pi / nb if scan == "unquantized" else DPHI
    return spec, geom, grids, poses, dist, valid, present, nb, dphi


def _box_mask(prep, shape, align=1):
    """[P, rows, cols] True on the cells of ``cell_pass_box``."""
    p, rows, cols = shape
    y0, y1, x0, x1 = tf.cell_pass_box(prep, cols, align)
    gy = torch.arange(rows)[None, :] - prep.r0.long()[:, None]
    gx = torch.arange(cols)[None, :]
    in_y = (gy >= y0.long()[:, None]) & (gy < y1.long()[:, None])
    in_x = (gx >= x0.long()[:, None]) & (gx < x1.long()[:, None])
    return in_y[:, :, None] & in_x[:, None, :]


@pytest.mark.parametrize("scan", ["within", "over_range", "unquantized",
                                  "edges", "config3"])
@pytest.mark.parametrize("static", [True, False], ids=["static", "traced"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_update_changes_only_the_box(scan, static, dtype):
    spec, geom, grids, poses, dist, valid, present, nb, dphi = _box_case(scan)
    tdphi = dphi if static else torch.tensor(dphi, dtype=torch.float32)
    g = torch.from_numpy(grids).to(getattr(torch, dtype))
    scan_args = (torch.from_numpy(poses), 0.1, torch.from_numpy(dist),
                 torch.from_numpy(valid), torch.from_numpy(present))
    out, _ = tf.fused_update(g, *scan_args, spec, nb, 1.0, dphi=tdphi)
    prep = tf.prepare(g.shape[1], g.shape[2], *scan_args, spec, nb, 1.0,
                      tdphi)
    box = _box_mask(prep, g.shape)
    changed = out != g
    assert changed.any() and not (changed & ~box).any()

    # the kernels' 16-byte columns hold the box and are whole words
    align = 16 // g.element_size()
    x0 = tf.cell_pass_box(prep, g.shape[2], align)[2]
    assert not (x0 % align).any()
    assert not (box & ~_box_mask(prep, g.shape, align)).any()
    # the box follows the scan: past the range it is wider than the disc
    # that max_range_m gives, and cells out there change
    cx = prep.pp[:, 0]
    dx = (torch.arange(g.shape[2])[None, :] + 0.5 - cx[:, None]).abs()
    far = dx[:, None, :] > tf.disc_half(spec, 1.0) + 1
    assert bool((changed & far).any()) == (scan in ("over_range",
                                                    "unquantized"))
    if scan == "config3":
        window = P_BOX * prep.wr * g.shape[2]
        cells = int(_box_mask(prep, g.shape, align).sum())
        assert cells * 10 <= window, (cells, window)
        return
    # the JAX reference the plain version copies changes no other cell
    jdphi = dphi if static else jnp.float32(dphi)
    jg = jnp.asarray(grids).astype(dtype)
    jout, _ = jf.fused_update_reference(jg, poses, np.float32(0.1), dist,
                                        valid, present, JSpec(*geom), nb,
                                        1.0, dphi=jdphi)
    j_changed = np.asarray(jout.astype(jnp.float32)) != \
        np.asarray(jg.astype(jnp.float32))
    assert j_changed.any() and not (j_changed & ~box.numpy()).any()
