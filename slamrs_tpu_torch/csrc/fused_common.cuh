// Device code shared by the fused update kernels (fused_update.cu, K1, and
// fused_update_tiled.cu, K3): the endpoint likelihood with its block
// reductions, the scan disc's bounding box, the per-cell inverse sensor
// model of the cell pass, and the 16-byte copies around the box.
//
// Both kernels run one CTA of kThreads threads per particle and call the
// same functions in the same order, so for the same window they produce
// the same bits: K3 on tiled maps is bitwise K1 on the materialized maps.
// The arithmetic is that of the plain PyTorch version
// (slamrs_tpu_torch/ops/fused.py::update_window); build with --fmad=false
// so products and sums stay separately rounded, as PyTorch rounds them.
//
// What bounds the cell pass on the H100, and what the design does about
// it.  A window cell costs an atan2f, a sqrtf, a divide and the bin
// pipeline, ~60 float32 operations with no products to batch, so tensor
// cores do not apply; at ~120 G cells/s a full-width [wr, cols] window
// (58.7 M cells at config 3) took the kernels' whole time.  Yet a cell's
// increment is 0 unless r^2 < a^2 or r^2 <= b^2 for its covering beam,
// and both are at most (|d| + 1)^2.  So each CTA takes dmax = max |d_enc|
// over the staged beam row (folded into the likelihood's barrier: no
// launch, no host input) and runs the cell pass only over the box
// |dx| < dmax + 2, |dy| < dmax + 2 (the extra cell covers the float32
// rounding of r^2), clipped to the window and widened to 16-byte columns
// (cell_box; ops/fused.py::cell_pass_box is the same box in PyTorch).  The
// box follows the scan, not max_range_m: a beam past the range (a replayed
// capture) widens it up to the whole window, as the plain version's
// full-width pass would mark it.  Outside the box the increment is 0, so
// a cell there is either left alone (in place) or copied (a fresh map or
// tile), bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace slamrs {

constexpr int kThreads = 256;
constexpr int kBeamPad = 512;
// float32 roundings of the Python constants of slamrs_tpu_torch/ops/grid.py
// and ops/fused.py (checked by tests/test_torch_fused.py)
constexpr float kTwoPi = 6.2831854820251465f;
constexpr float kInvTwoPi = 0.15915493667125702f;
constexpr float kLFree = -0.8472978472709656f;     // L_FREE
constexpr float kLOccupied = 2.1972246170043945f;  // L_OCCUPIED
constexpr float kZHit = 0.9f;                      // Z_HIT
constexpr float kMissMix = 0.10000000149011612f;   // (1 - Z_HIT) / SENSOR_MAXDIST
constexpr float kInvMaxDist = 1.0f;                // 1 / SENSOR_MAXDIST
constexpr float kHalfTol = 1.0f;                   // TOLERANCE_CELLS / 2

__device__ __forceinline__ float load_cell(const float* p) { return *p; }
__device__ __forceinline__ float load_cell(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_cell(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_cell(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Static scan and bin-pipeline constants, the same for every particle.
struct ScanConsts {
  const float* table;  // [8, kBeamPad] beam table, row 0 quantized d_enc
  int wr, cols, logical_rows, logical_cols, num_beams, static_bins;
  float inv_s, nbf, inv_nbf;  // static bin-units constants
};

// Per-particle window geometry and pose terms, from the host-prepared
// pp row [cx, cy, theta, ta-or-T, cos, sin, dphi, 1/dphi] and the window
// row origin r0.
struct Particle {
  float cx, cy, ta, ct, st, dphi, inv_dphi;
  int r0;
};

__device__ __forceinline__ Particle load_particle(const float* pp, int r0) {
  return Particle{pp[0], pp[1], pp[3], pp[4], pp[5], pp[6], pp[7], r0};
}

// Stages row 0 of the beam table (quantized d_enc) in shared memory, made
// visible by the __syncthreads() inside block_likelihood, and returns this
// thread's share of dmax = max |d_enc| over the lanes (absent lanes are
// +-0; fmaxf drops a NaN, whose beam changes no cell).
__device__ __forceinline__ float stage_denc(const ScanConsts& c, float* s_denc) {
  float m = 0.f;
  for (int b = threadIdx.x; b < kBeamPad; b += kThreads) {
    const float v = c.table[b];
    s_denc[b] = v;
    m = fmaxf(m, fabsf(v));
  }
  return m;
}

// Endpoint log-likelihood of the scan on the pre-update window, summed over
// the block; thread 0 writes it to *out.  `cell(wy, wx)` returns the
// pre-update log-odds of window cell (wy, wx).  A beam whose endpoint lies
// outside the logical grid or the window adds nothing.  Contains the
// __syncthreads() that orders every likelihood read before the caller's
// first write; the same barrier reduces the threads' `dmax_part` (from
// stage_denc), and every thread gets the block's dmax back.  s_red holds
// 2 * kThreads / 32 floats.
template <typename CellAt>
__device__ __forceinline__ float block_likelihood(const ScanConsts& c,
                                                  const Particle& q,
                                                  CellAt cell, float dmax_part,
                                                  float* s_red, float* out) {
  const int tid = threadIdx.x;
  float acc = 0.f;
  for (int b = tid; b < kBeamPad; b += kThreads) {
    if (!(c.table[4 * kBeamPad + b] > 0.5f)) continue;
    const float d = c.table[kBeamPad + b];
    const float ca = c.table[2 * kBeamPad + b];
    const float sa = c.table[3 * kBeamPad + b];
    const float ex = q.cx + (q.ct * ca - q.st * sa) * d;
    const float ey = q.cy + (q.st * ca + q.ct * sa) * d;
    if (!(ex >= 0.f && ey >= 0.f && ex < static_cast<float>(c.logical_cols) &&
          ey < static_cast<float>(c.logical_rows)))
      continue;
    const int xi = static_cast<int>(floorf(ex));
    const int yi = static_cast<int>(floorf(ey)) - q.r0;
    if (yi < 0 || yi >= c.wr || xi < 0 || xi >= c.cols) continue;
    const float odds = cell(yi, xi);
    float factor = kInvMaxDist;
    if (odds != 0.f) {
      const float p_end = 1.f - 1.f / (1.f + expf(odds));
      factor = kZHit * p_end + kMissMix;
    }
    acc += logf(factor);
  }
  float m = dmax_part;
  for (int o = 16; o > 0; o >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  }
  constexpr int kWarps = kThreads / 32;
  if ((tid & 31) == 0) {
    s_red[tid >> 5] = acc;
    s_red[kWarps + (tid >> 5)] = m;
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += s_red[w];
    *out = s;
  }
  float dmax = 0.f;
  for (int w = 0; w < kWarps; ++w) dmax = fmaxf(dmax, s_red[kWarps + w]);
  return dmax;
}

// The cell pass's box in window coordinates: rows [y0, y1), columns
// [x0, x1).  The window cells with |dx| < dmax + 2 and |dy| < dmax + 2
// (dx, dy the cell offsets of make_cell_pass) lie in rows
// [floor(cy - e), ceil(cy + e)) - r0 and columns [floor(cx - e),
// ceil(cx + e)), e = dmax + 2; clipped to the window, columns widened to
// multiples of `align` cells (16 bytes).  Clamped as floats first, so an
// infinite dmax gives the whole window.  ops/fused.py::cell_pass_box
// computes the same box.
struct Box {
  int y0, y1, x0, x1;
};

__device__ __forceinline__ Box cell_box(const ScanConsts& c, const Particle& q,
                                        float dmax, int align) {
  const float e = dmax + 2.f;
  const float r0f = static_cast<float>(q.r0);
  const float wrf = static_cast<float>(c.wr);
  const float colsf = static_cast<float>(c.cols);
  const int x0 = static_cast<int>(fminf(fmaxf(floorf(q.cx - e), 0.f), colsf));
  const int x1 = static_cast<int>(fminf(fmaxf(ceilf(q.cx + e), 0.f), colsf));
  return Box{static_cast<int>(fminf(fmaxf(floorf(q.cy - e) - r0f, 0.f), wrf)),
             static_cast<int>(fminf(fmaxf(ceilf(q.cy + e) - r0f, 0.f), wrf)),
             x0 / align * align, (x1 + align - 1) / align * align};
}

// The cell pass's per-particle constants (window offsets folded in).
struct CellPass {
  float ox, oy, ta, ta_inv, nb_f, wrap_k, beams_m1, rows_lim, cols_lim;
  float dphi, inv_dphi;
};

__device__ __forceinline__ CellPass make_cell_pass(const ScanConsts& c,
                                                   const Particle& q) {
  const float r0f = static_cast<float>(q.r0);
  return CellPass{0.5f - q.cx,
                  r0f + (0.5f - q.cy),
                  q.ta,
                  q.ta * q.inv_dphi,
                  kTwoPi * q.inv_dphi,
                  q.dphi * kInvTwoPi,
                  static_cast<float>(c.num_beams - 1),
                  static_cast<float>(c.logical_rows) - r0f,
                  static_cast<float>(c.logical_cols),
                  q.dphi,
                  q.inv_dphi};
}

// Inverse-sensor-model increment of window cell (wy, wx): atan2 picks the
// covering beam (static bin-units or traced pipeline), the squared-space
// interval test picks free / occupied / nothing, scaled by the beam density.
__device__ __forceinline__ float cell_increment(const ScanConsts& c,
                                                const CellPass& k,
                                                const float* s_denc, int wy,
                                                int wx) {
  const float dx = static_cast<float>(wx) + k.ox;
  const float dy = static_cast<float>(wy) + k.oy;
  const float r2 = dx * dx + dy * dy;
  const float r = sqrtf(r2);
  const float phi = atan2f(dy, dx);
  float bf;
  if (c.static_bins) {
    // bin units: ta holds T = (theta + angles0)/dphi - 0.5
    float b0 = phi * c.inv_s - k.ta;
    b0 = b0 - c.nbf * floorf(b0 * c.inv_nbf);
    bf = floorf(b0);
  } else {
    float b0 = phi * k.inv_dphi - k.ta_inv;
    b0 = b0 - k.nb_f * floorf(b0 * k.wrap_k);
    bf = rintf(b0);  // half to even, as torch.round / jnp.round
    const bool wrap = bf >= k.nb_f - 0.5f;
    const bool absent = bf > k.beams_m1 && !wrap;
    bf = wrap ? 0.f : bf;
    bf = absent ? static_cast<float>(c.num_beams) : bf;
  }
  const int bin = min(max(static_cast<int>(bf), 0), kBeamPad - 1);
  const float d_enc = s_denc[bin];
  const bool was_hit = d_enc > 0.f;
  const bool present = d_enc != 0.f;  // -0.0 is absent too
  const float d = fabsf(d_enc);
  const float dm = fmaxf(d - kHalfTol, 0.f);
  const float a_sq = was_hit ? dm * dm : d * d;
  const float dp = d + kHalfTol;
  const float b_sq = was_hit ? dp * dp : -1.f;
  const float inc = r2 < a_sq ? kLFree : (r2 <= b_sq ? kLOccupied : 0.f);
  const float dens = fmaxf(1.f / (fmaxf(r, 0.5f) * k.dphi), 1.f);
  const bool in_b = static_cast<float>(wy) < k.rows_lim &&
                    static_cast<float>(wx) < k.cols_lim;
  return (present && in_b) ? inc * dens : 0.f;
}

// Runs `cell(wy, wx, inc)` for every cell of the box, threads striding
// over its cells in row-major order.
template <typename Cell>
__device__ __forceinline__ void box_pass(const ScanConsts& c,
                                         const CellPass& k,
                                         const float* s_denc, const Box& b,
                                         Cell cell) {
  const int bw = b.x1 - b.x0;
  const int n = (b.y1 - b.y0) * bw;
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const int oy = idx / bw;
    const int wy = b.y0 + oy;
    const int wx = b.x0 + idx - oy * bw;
    cell(wy, wx, cell_increment(c, k, s_denc, wy, wx));
  }
}

// 16-byte copy of words [begin, end) by the whole block, two loads in
// flight a thread.
__device__ __forceinline__ void block_copy16(const uint4* __restrict__ s,
                                             uint4* __restrict__ d, int begin,
                                             int end) {
  int k = begin + threadIdx.x;
  for (; k + kThreads < end; k += 2 * kThreads) {
    const uint4 a = s[k];
    const uint4 b = s[k + kThreads];
    d[k] = a;
    d[k + kThreads] = b;
  }
  if (k < end) d[k] = s[k];
}

// 16-byte copy by the whole block of a region of `rows` rows of `per_row`
// words, except the box words: rows [y0, y1) x words [v0, v1).  Rows
// outside [y0, y1) are two contiguous runs; inside, the words left and
// right of the box are walked as one run of per_row - (v1 - v0) words a
// row (the right part of a row and the left part of the next lie side by
// side), two loads in flight a thread.
__device__ __forceinline__ void copy_outside_box(const uint4* __restrict__ s,
                                                 uint4* __restrict__ d,
                                                 int rows, int per_row, int y0,
                                                 int y1, int v0, int v1) {
  block_copy16(s, d, 0, y0 * per_row);
  block_copy16(s, d, y1 * per_row, rows * per_row);
  const int bw = v1 - v0;
  const int g = per_row - bw;  // words a row outside the box
  const int n = (y1 - y0) * g;
  if (n <= 0) return;
  const int dr = kThreads / g, dc = kThreads - dr * g;
  int r = threadIdx.x / g, col = threadIdx.x - r * g;
  auto next = [&]() {  // this thread's next word, then one stride on
    const int k = (y0 + r) * per_row + (col < v0 ? col : col + bw);
    col += dc;
    r += dr;
    if (col >= g) {
      col -= g;
      ++r;
    }
    return k;
  };
  for (int j = threadIdx.x; j < n; j += 2 * kThreads) {
    const int k0 = next();
    if (j + kThreads < n) {
      const int k1 = next();
      const uint4 a = s[k0];
      const uint4 b = s[k1];
      d[k0] = a;
      d[k1] = b;
    } else {
      d[k0] = s[k0];
    }
  }
}

}  // namespace slamrs
