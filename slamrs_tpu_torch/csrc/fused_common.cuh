// Device code shared by the fused update kernels (fused_update.cu, K1, and
// fused_update_tiled.cu, K3): the endpoint likelihood with its block
// reduction, and the per-cell inverse sensor model of the cell pass.
//
// Both kernels run one CTA of kThreads threads per particle and call the
// same functions in the same order, so for the same window they produce
// the same bits: K3 on tiled maps is bitwise K1 on the materialized maps.
// The arithmetic is that of the plain PyTorch version
// (slamrs_tpu_torch/ops/fused.py::update_window); build with --fmad=false
// so products and sums stay separately rounded, as PyTorch rounds them.

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

// Stages row 0 of the beam table (quantized d_enc) in shared memory.  Made
// visible by the __syncthreads() inside block_likelihood.
__device__ __forceinline__ void stage_denc(const ScanConsts& c, float* s_denc) {
  for (int b = threadIdx.x; b < kBeamPad; b += kThreads) s_denc[b] = c.table[b];
}

// Endpoint log-likelihood of the scan on the pre-update window, summed over
// the block; thread 0 writes it to *out.  `cell(wy, wx)` returns the
// pre-update log-odds of window cell (wy, wx).  A beam whose endpoint lies
// outside the logical grid or the window adds nothing.  Contains the
// __syncthreads() that orders every likelihood read before the caller's
// first write.
template <typename CellAt>
__device__ __forceinline__ void block_likelihood(const ScanConsts& c,
                                                 const Particle& q,
                                                 CellAt cell, float* s_warp,
                                                 float* out) {
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
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if ((tid & 31) == 0) s_warp[tid >> 5] = acc;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) s += s_warp[w];
    *out = s;
  }
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

// 16-byte copy of `n` uint4 words by the whole block.
__device__ __forceinline__ void block_copy16(const uint4* __restrict__ s,
                                             uint4* __restrict__ d, size_t n) {
  for (size_t k = threadIdx.x; k < n; k += kThreads) d[k] = s[k];
}

}  // namespace slamrs
