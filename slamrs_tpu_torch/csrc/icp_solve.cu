// One point-to-normal ICP iteration after the correspondence step, for
// Hopper (sm_90a): for every problem b, given each source lane's nearest
// reference point corr (K4, csrc/nn_argmin.cu), the Gauss-Newton update of
// the pose x = (tx, ty, theta) and the source under the new pose.
//
// Replaces no Pallas kernel: on the TPU this is the XLA body of
// slamrs_tpu/ops/icp.py::icp_point_to_normal (the loop around the Pallas
// argmin).  In PyTorch that body is ~100 small ATen kernels an iteration
// (stacks of rot2/drot2, gathers, four float32 products, the 3 x 3 solve's
// elementwise steps, the angle wrap) and a whole-map compute_normals an
// update; here it is one launch.  It computes what the plain version
// slamrs_tpu_torch/ops/icp.py::solve_step_reference computes, in float32,
// built with --fmad=false, per lane:
//   n    = the central-difference normal at corr (ops/icp.normals_at: the
//          perpendicular of q[c+1] - q[c-1], lanes wrapping at Nq,
//          normalized; zero at lane 0, at lanes >= q_count - 1 and
//          everywhere when q_count <= 2), the same roundings as
//          compute_normals, so the same bits;
//   e    = n . (p_t - q[c]),   J = [n, n . dR(theta) p];
//   w    = (e e < threshold^2, or 1 without a threshold) x p_mask;
// summed over the lanes: H = sum (J w) J^T (its 6 unique entries),
// g = sum J (w e), chi = sum over p_mask of e e.  Then the closed-form
// solve of H dx = -g (the adjugate with the floor 1e-8 x trace on the
// diagonal, dx = 0 where |det| <= 1e-30), x += dx, theta wrapped by
// atan2(sin, cos), and p_t = R(theta) p + t for the next K4 launch (after
// the last iteration, IcpResult.transformed_points).
//
// Order of the float32 arithmetic.  The plain version's products run in
// cuBLAS; the kernel repeats the order in which cuBLAS (CUDA 12.8, H100)
// computes them at the ICP mapper's shape, one problem of 360 lanes:
//   R p and dR p (a [360, 2] x [2, 2] sgemm): fma(p_y, r_1j, p_x r_0j);
//   H (a split-K SIMT sgemm over the lanes, 30 slices of 12): per chunk of
//          12 consecutive lanes a chain of fma(J_i w, J_j, acc) in lane
//          order, then the chunks' partials added in chunk order;
//   g (a gemv, one warp an output): lane t of a warp chains fma(J_i,
//          w e, acc) over the lanes t, t + 32, ..., then the warp adds
//          the 32 chains in a shuffle-down tree (16, 8, 4, 2, 1).
// Every other step is one rounding per ATen operation, as the plain
// version's elementwise kernels round (hence --fmad=false), so at that
// shape the pose and the source are the plain version's bits (the card
// tests hold this).  At other shapes cuBLAS may pick other orders; the
// kernel keeps its own, and agrees with the plain version to float32
// rounding.  chi (a torch.sum, read by nothing downstream) is summed in
// g's order, not torch.sum's.
//
// Modes.  With corr == nullptr the launch only transforms: x_out = x_in and
// p_t = R(x_in) p + t (a call's prologue, before the first K4 launch).
// Otherwise it reads corr and the p_t that K4 read, and writes x_out,
// chi[b, k] and the new p_t in place.  x_in and x_out may be one buffer:
// every thread reads x_in before the block's first barrier and thread 0
// writes x_out after it.
//
// Layout.  One CTA of kThreads threads per problem.  The lanes go through
// shared memory a tile of kTile at a time: every thread computes lanes
// (n, J, w, w e, the masked e e) into the tile, then the threads of warps
// 0-1 each chain one chunk of 12 lanes into H's partials, while warp 2
// chains g and chi; threads 0-5 add the tile's partials to H's six unique
// entries in chunk order.  No float atomics, so a call gives the same bits
// every time, eager or replayed.  Thread 0 solves and publishes the new
// rotation and translation through shared memory; every thread then
// writes its lanes of p_t.
//
// What bounds it on the H100.  Latency: at the ICP mapper's shape (360
// lanes against a 16,384-point map) an iteration reads ~16 KB (corr, p,
// p_t, the mask and three map points a lane), a few ns of bandwidth; the
// time is the launch, two dependent global reads (corr, then the map
// points it names), H's chains of 12 dependent fmas, the chunk sums and
// one thread's solve.  The design keeps that to one launch an iteration
// with one round trip per dependent read, so a scan's ICP is 21 launches
// (a prologue and ten of K4 and this kernel) where the ATen body was
// ~1,000.  At bench.py's batch
// (2,048 problems) the grid fills the card with 2,048 CTAs.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 384;            // the mapper's 360 lanes in one pass
constexpr int kChunk = 12;                // lanes of one partial of H
constexpr int kTile = 768;                // lanes staged at a time
constexpr int kChunks = kTile / kChunk;   // H's chains: warps 0-1
constexpr int kGWarp = kChunks / 32;      // g's and chi's warp: warp 2
static_assert(kTile % kChunk == 0 && kTile % 32 == 0 && kChunks % 32 == 0,
              "a tile holds whole chunks and whole warp strides");
static_assert((kGWarp + 1) * 32 <= kThreads, "g's warp is in the block");

// R(theta) p + t as the plain version's [N, 2] x [2, 2] product rounds it
__device__ __forceinline__ float2 rotate(float2 v, float c, float s,
                                         float tx, float ty) {
  return make_float2(__fmaf_rn(v.y, -s, v.x * c) + tx,
                     __fmaf_rn(v.y, c, v.x * s) + ty);
}

__global__ void __launch_bounds__(kThreads)
icp_solve_kernel(const float2* __restrict__ p,
                 const unsigned char* __restrict__ p_mask,
                 const float2* __restrict__ q, const int* __restrict__ q_count,
                 const int* __restrict__ corr, const float* x_in,
                 float* x_out, float2* p_t, float* __restrict__ chi, int np,
                 int nq, int iterations, int k, int has_threshold,
                 float threshold_sq) {
  // the tile's lanes: normal (x, y), J's third entry, w, w e, masked e e
  __shared__ float s_nx[kTile], s_ny[kTile], s_j2[kTile], s_w[kTile],
      s_we[kTile], s_ee[kTile];
  __shared__ float part[kChunks][6];
  __shared__ float sums[10];  // h00 h01 h02 h11 h12 h22 g0 g1 g2 chi
  __shared__ float pose[4];   // cos, sin, tx, ty of the new pose
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(b) * np;
  const float2* pb = p + base;
  float2* tb = p_t + base;
  const float x0 = x_in[3 * b], x1 = x_in[3 * b + 1], x2 = x_in[3 * b + 2];
  const float c = cosf(x2), s = sinf(x2);

  if (corr == nullptr) {  // the prologue: the source under x_in
    __syncthreads();  // every thread has read x_in
    if (tid < 3) x_out[3 * b + tid] = x_in[3 * b + tid];
    for (int i = tid; i < np; i += kThreads)
      tb[i] = rotate(pb[i], c, s, x0, x1);
    return;
  }

  const int qcount = q_count[b];
  const float2* qb = q + static_cast<size_t>(nq) * b;
  float h = 0.0f;                            // threads 0-5: H's entry tid
  float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f, ch = 0.0f;  // warp kGWarp
  for (int t0 = 0; t0 < np; t0 += kTile) {
    const int n = min(kTile, np - t0);
    for (int l = tid; l < n; l += kThreads) {
      const int i = t0 + l;
      const int ci = min(max(corr[base + i], 0), nq - 1);
      const float2 pt = tb[i];
      const float2 v = pb[i];
      const float m = p_mask[base + i] ? 1.0f : 0.0f;
      const float2 qc = qb[ci];
      // compute_normals at lane ci: perp(q[ci+1] - q[ci-1]) normalized
      const float2 qn = qb[ci + 1 < nq ? ci + 1 : 0];
      const float2 qp = qb[ci > 0 ? ci - 1 : nq - 1];
      const float dx = qn.x - qp.x, dy = qn.y - qp.y;
      const float px = -dy, py = dx;
      const float norm = sqrtf(px * px + py * py);
      const bool interior = ci >= 1 && ci < qcount - 1 && qcount > 2;
      const float nx = interior && norm > 0.0f ? px / norm : 0.0f;
      const float ny = interior && norm > 0.0f ? py / norm : 0.0f;

      const float e = nx * (pt.x - qc.x) + ny * (pt.y - qc.y);
      // dR(theta) p, dR = [[-s, -c], [c, -s]], as the [N, 2] x [2, 2]
      // product rounds it
      const float drx = __fmaf_rn(v.y, -c, v.x * -s);
      const float dry = __fmaf_rn(v.y, -s, v.x * c);
      const float ee = e * e;
      const float w = (has_threshold ? (ee < threshold_sq ? 1.0f : 0.0f)
                                     : 1.0f) * m;
      s_nx[l] = nx;
      s_ny[l] = ny;
      s_j2[l] = nx * drx + ny * dry;
      s_w[l] = w;
      s_we[l] = w * e;
      s_ee[l] = m != 0.0f ? ee : 0.0f;
    }
    __syncthreads();
    if (tid < kChunks) {
      const int lo = tid * kChunk;
      if (lo < n) {
        float a[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        for (int l = lo; l < min(lo + kChunk, n); ++l) {
          const float j0 = s_nx[l], j1 = s_ny[l], j2 = s_j2[l], w = s_w[l];
          const float jw0 = j0 * w, jw1 = j1 * w, jw2 = j2 * w;
          a[0] = __fmaf_rn(jw0, j0, a[0]);
          a[1] = __fmaf_rn(jw0, j1, a[1]);
          a[2] = __fmaf_rn(jw0, j2, a[2]);
          a[3] = __fmaf_rn(jw1, j1, a[3]);
          a[4] = __fmaf_rn(jw1, j2, a[4]);
          a[5] = __fmaf_rn(jw2, j2, a[5]);
        }
#pragma unroll
        for (int j = 0; j < 6; ++j) part[tid][j] = a[j];
      }
    } else if (tid / 32 == kGWarp) {
      for (int l = tid % 32; l < n; l += 32) {
        const float we = s_we[l];
        g0 = __fmaf_rn(s_nx[l], we, g0);
        g1 = __fmaf_rn(s_ny[l], we, g1);
        g2 = __fmaf_rn(s_j2[l], we, g2);
        ch += s_ee[l];
      }
    }
    __syncthreads();
    if (tid < 6) {  // the loads of 8 partials in flight, the adds in order
      const int chunks = (n + kChunk - 1) / kChunk;
      for (int j0 = 0; j0 < chunks; j0 += 8) {
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          v[u] = j0 + u < chunks ? part[j0 + u][tid] : 0.0f;
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (j0 + u < chunks) h += v[u];
      }
    }
    // the next tile writes part[] only after its staging barrier, which
    // threads 0-5 reach after these reads
  }
  if (tid < 6) sums[tid] = h;
  if (tid / 32 == kGWarp) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      g0 += __shfl_down_sync(0xffffffffu, g0, off);
      g1 += __shfl_down_sync(0xffffffffu, g1, off);
      g2 += __shfl_down_sync(0xffffffffu, g2, off);
      ch += __shfl_down_sync(0xffffffffu, ch, off);
    }
    if (tid % 32 == 0) {
      sums[6] = g0;
      sums[7] = g1;
      sums[8] = g2;
      sums[9] = ch;
    }
  }
  __syncthreads();

  if (tid == 0) {
    const float* t = sums;
    // ops/icp._pinv_solve on [[a, bb, cc], [bb, d, ee], [cc, ee, f]]
    const float tr = (t[0] + t[3]) + t[5];
    const float lam = 1e-8f * (tr < 1e-30f ? 1e-30f : tr);
    const float a = t[0] + lam, bb = t[1], cc = t[2];
    const float d = t[3] + lam, ee = t[4], f = t[5] + lam;
    const float c00 = d * f - ee * ee;
    const float c01 = cc * ee - bb * f;
    const float c02 = bb * ee - cc * d;
    const float c11 = a * f - cc * cc;
    const float c12 = bb * cc - a * ee;
    const float c22 = a * d - bb * bb;
    const float det = (a * c00 + bb * c01) + cc * c02;
    const float inv_det = fabsf(det) > 1e-30f ? 1.0f / det : 0.0f;
    const float r0 = -t[6], r1 = -t[7], r2 = -t[8];
    const float n0 = x0 + ((c00 * r0 + c01 * r1) + c02 * r2) * inv_det;
    const float n1 = x1 + ((c01 * r0 + c11 * r1) + c12 * r2) * inv_det;
    const float n2 = x2 + ((c02 * r0 + c12 * r1) + c22 * r2) * inv_det;
    const float theta = atan2f(sinf(n2), cosf(n2));
    x_out[3 * b] = n0;
    x_out[3 * b + 1] = n1;
    x_out[3 * b + 2] = theta;
    chi[static_cast<size_t>(b) * iterations + k] = t[9];
    pose[0] = cosf(theta);
    pose[1] = sinf(theta);
    pose[2] = n0;
    pose[3] = n1;
  }
  __syncthreads();
  const float c1 = pose[0], s1 = pose[1], tx = pose[2], ty = pose[3];
  for (int i = tid; i < np; i += kThreads)
    tb[i] = rotate(pb[i], c1, s1, tx, ty);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 when the launch
// was accepted).  p: f32[b, np, 2]; p_mask: bool[b, np]; q: f32[b, nq, 2]
// (nq > 0); q_count: i32[b]; corr: i32[b, np] (K4's indices), or null for
// the transform-only prologue; x_in, x_out: f32[b, 3] (may alias); p_t:
// f32[b, np, 2], read (with corr) and written; chi: f32[b, iterations],
// entry k written (with corr; may be null without).  has_threshold 0 gives
// uniform weights, else the Step weight e * e < threshold_sq.
extern "C" int slamrs_icp_solve(const void* p, const void* p_mask,
                                const void* q, const void* q_count,
                                const void* corr, const void* x_in,
                                void* x_out, void* p_t, void* chi, int b,
                                int np, int nq, int iterations, int k,
                                int has_threshold, float threshold_sq,
                                void* stream) {
  if (b <= 0) return static_cast<int>(cudaGetLastError());
  if (np < 0 || nq <= 0 ||
      (corr != nullptr && (chi == nullptr || k < 0 || k >= iterations)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  icp_solve_kernel<<<b, kThreads, 0, st>>>(
      static_cast<const float2*>(p), static_cast<const unsigned char*>(p_mask),
      static_cast<const float2*>(q), static_cast<const int*>(q_count),
      static_cast<const int*>(corr), static_cast<const float*>(x_in),
      static_cast<float*>(x_out), static_cast<float2*>(p_t),
      static_cast<float*>(chi), np, nq, iterations, k, has_threshold,
      threshold_sq);
  return static_cast<int>(cudaGetLastError());
}
