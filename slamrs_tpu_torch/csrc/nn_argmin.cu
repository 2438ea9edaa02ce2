// ICP nearest-neighbour correspondences for Hopper (sm_90a): for every
// source point p of problem b, the index of the closest reference point q.
//
// Replaces the Pallas TPU kernel slamrs_tpu/ops/icp.py::nearest_neighbors_fused
// (body _nn_kernel).  It computes what the plain version
// slamrs_tpu_torch/ops/icp.py::nearest_neighbors_reference computes, with
// the same float32 roundings per pair (built with --fmad=false), so the
// indices agree bitwise:
//   q2 = qx*qx + qy*qy,  s = px*qx + py*qy  (each product and sum rounded)
//   d2 = q2 - 2 s                           (the p*p term is constant per p)
//   idx = first j < q_count of the minimum d2, then min(idx, Nq - 1), and 0
//   where q_count <= 0.
// d2 is one fmaf(-2, s, q2): 2 s is exact (doubling never rounds short of
// overflow), so the plain version's q2 - (2 s) and the fused form round
// the same exact value once.
//
// Precondition (q_count).  The plain version also scans the lanes at or
// past q_count, with 1e30 added to q2; this kernel skips them.  The indices
// are the same while every valid |d2| is far below 1e30: finite
// coordinates well below ~1e14 m (the ICP maps are metres wide).
//
// Layout.  A CTA holds a tile of TL = 4 L p lanes of one problem: each
// thread keeps kLanes = 4 p lanes in registers (lanes u, u + L, u + 2L,
// u + 3L of the tile), so one broadcast shared-memory load of {qx, qy, q2,
// index bits} feeds four pairs, and the index (the fourth word) and the
// loop control are shared by the four.  The CTA stages its whole q range in
// shared memory once, behind one barrier; its G groups of L threads each
// take a contiguous part of that range.  The q axis of a problem is split
// over C CTAs (blockIdx.y) of ceil(qv / C) lanes each, qv = clamp(q_count,
// 0, Nq), read on the device: the split follows the filled part of the
// map, and CTAs past it exit at once.  ops/icp.py::nn_plan picks (L, G, C):
// at bench.py's batch (2,048 problems of 360 x 360) (96, 2, 1), 2,048 CTAs
// of six warps, no chunk merge; at the ICP mapper's shape (one problem,
// 360 x 16,384) (32, 8, 44), three 128-lane tiles x 44 chunks = 132 CTAs of
// eight warps, one a SM.
//
// Merge, deterministic by construction.  Every running minimum starts at
// +inf with its range's first index and takes a pair only when d2 < best
// (strict), so it holds the first index of its range's minimum.  Ranges are
// merged in index order with the same strict '<': the G groups through
// shared memory, then the C chunks of a tile in chunk order.  For the
// chunks each CTA writes its per-lane (d2, index) to scratch and counts
// itself in on the tile's arrival counter (one acquire-release atomic,
// after a barrier); the CTA that arrives last reads every partial from L2,
// merges them in chunk order (at the mapper's shape two threads a lane,
// each over one half of the chunks, then the halves in order), writes the
// clamped indices and puts the counter back to 0.  So the first index wins
// whatever order the CTAs run in, and a call is one launch: no memset, no
// second kernel.  The wrapper allocates the scratch per call and keeps
// zeroed counters per device and stream.  (A thread block cluster merging
// through distributed shared memory caps the split at 8 CTAs, 16 with a
// non-portable size: too few to spread 360 x 16,384 over 132 SMs in
// 128-lane tiles.)
//
// Tensor cores do not apply: the product has depth 2, and TF32 (or any
// reordered sum) rounds d2 otherwise than the float32 contract, which
// changes indices on near-ties.  For the same reason q is not pre-scaled
// by -2 at staging, which would save a multiply per pair but rounds
// otherwise where the products are subnormal (coordinates near 1e-20 m
// change indices).
//
// What bounds it on the H100.  At bench.py's batch, instruction issue: per
// pair two multiplies, an add, the fused doubling and subtraction, the
// compare and two selects (7), plus a shared load and the loop per four
// pairs, ~7.5 issue slots a pair; at the 44-48 registers ptxas gives it
// (kernel_times.py prints them) seven CTAs (42 warps) fit a SM.
// chip_smoke.py measures ~12 slot-times a pair, so the SM sustains ~60 %
// of its issue rate on this mix, against the 6 operations a pair of the
// float32 bound.  At the mapper's shape, latency: one launch, the q_count
// read, the staging, and the merge's store, atomic and loads through L2
// (kernel_times.py times q_count 0, 44 and 10,000 there).

#include <cuda/atomic>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 4;  // p lanes per thread

__global__ void nn_argmin_kernel(const float2* __restrict__ p,
                                 const float2* __restrict__ q,
                                 const int* __restrict__ q_count,
                                 float2* __restrict__ partials,
                                 int* __restrict__ counters,
                                 int* __restrict__ out, int np, int nq, int L,
                                 int G, int C, int ptiles, int chunk_max) {
  extern __shared__ float4 smem[];
  __shared__ int is_last;
  const int T = blockDim.x;  // G * L
  const int TL = L * kLanes;
  const int tile = blockIdx.x;  // problem * ptiles + p tile
  const int b = tile / ptiles;
  const int pt = tile % ptiles;
  const int c = blockIdx.y;
  const int qv = min(max(q_count[b], 0), nq);
  const int per = qv > 0 ? (qv + C - 1) / C : 0;
  const int live = qv > 0 ? (qv + per - 1) / per : 1;  // chunks with lanes
  if (c >= live) return;
  const int j0 = c * per;
  const int n = min(j0 + per, qv) - j0;

  float4* sq = smem;                                         // [chunk_max]
  float2* red = reinterpret_cast<float2*>(sq + chunk_max);  // [G][TL]

  const float2* qb = q + static_cast<size_t>(b) * nq + j0;
  for (int k = threadIdx.x; k < n; k += T) {
    const float2 v = qb[k];
    sq[k] = make_float4(v.x, v.y, v.x * v.x + v.y * v.y,
                        __int_as_float(j0 + k));
  }

  const int g = threadIdx.x / L;
  const int u = threadIdx.x % L;
  const int gs = (n + G - 1) / G;
  const int k0 = min(g * gs, n);
  const int k1 = min(k0 + gs, n);
  float px[kLanes], py[kLanes], best[kLanes];
  int bj[kLanes];
#pragma unroll
  for (int r = 0; r < kLanes; ++r) {
    const int i = pt * TL + u + r * L;
    const float2 pp = i < np ? p[static_cast<size_t>(b) * np + i]
                             : make_float2(0.0f, 0.0f);
    px[r] = pp.x;
    py[r] = pp.y;
    best[r] = __int_as_float(0x7f800000);  // +inf
    bj[r] = j0 + k0;
  }
  __syncthreads();
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const float4 v = sq[k];
#pragma unroll
    for (int r = 0; r < kLanes; ++r) {
      // q2 - 2 s with 2 s exact: one rounding either way
      const float d2 = __fmaf_rn(-2.0f, px[r] * v.x + py[r] * v.y, v.z);
      if (d2 < best[r]) {
        best[r] = d2;
        bj[r] = __float_as_int(v.w);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kLanes; ++r)
    red[g * TL + u + r * L] = make_float2(best[r], __int_as_float(bj[r]));
  __syncthreads();

  // the CTA's minimum per lane, its groups in index order: the result, or
  // with several chunks this chunk's partial
  int* ob = out + static_cast<size_t>(b) * np + pt * TL;
  const int lanes = min(TL, np - pt * TL);
  float2* tp = partials + static_cast<size_t>(tile) * C * TL;
  for (int l = threadIdx.x; l < TL; l += T) {
    float2 m = red[l];
    for (int h = 1; h < G; ++h) {
      const float2 v = red[h * TL + l];
      if (v.x < m.x) m = v;
    }
    if (live > 1)
      tp[c * TL + l] = m;
    else if (l < lanes)
      ob[l] = qv > 0 ? min(__float_as_int(m.y), nq - 1) : 0;
  }
  if (live == 1) return;

  // several chunks: count in; the last to arrive merges them in order
  __syncthreads();
  if (threadIdx.x == 0) {  // release this CTA's partial, acquire the others'
    cuda::atomic_ref<int, cuda::thread_scope_device> arrived(counters[tile]);
    is_last = arrived.fetch_add(1, cuda::memory_order_acq_rel) == live - 1;
  }
  __syncthreads();
  if (!is_last) return;
  // H threads a lane where the CTA has them, each over a run of chunks
  // (more loads in flight), then the runs in order
  const int H = max(1, min(T / TL, live));
  for (int s = threadIdx.x; s < H * TL; s += T) {
    const int l = s % TL;
    const int h = s / TL;
    const int c1 = (h + 1) * live / H;
    float2 m = __ldcg(tp + h * live / H * TL + l);
#pragma unroll 16
    for (int cc = h * live / H + 1; cc < c1; ++cc) {
      const float2 v = __ldcg(tp + cc * TL + l);
      if (v.x < m.x) m = v;
    }
    if (H == 1) {
      if (l < lanes) ob[l] = min(__float_as_int(m.y), nq - 1);
    } else {
      red[h * TL + l] = m;
    }
  }
  if (H > 1) {
    __syncthreads();
    for (int l = threadIdx.x; l < lanes; l += T) {
      float2 m = red[l];
      for (int h = 1; h < H; ++h) {
        const float2 v = red[h * TL + l];
        if (v.x < m.x) m = v;
      }
      ob[l] = min(__float_as_int(m.y), nq - 1);
    }
  }
  if (threadIdx.x == 0) counters[tile] = 0;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 when the launch
// was accepted).  p: f32[b, np, 2]; q: f32[b, nq, 2] (nq > 0); q_count:
// i32[b]; out: i32[b, np].  threads_per_group (L), groups (G) and chunks
// (C) as ops/icp.py::nn_plan gives them.  With chunks > 1: partials is
// f32[b * ptiles * chunks * L * 4 * 2] scratch and counters i32[b * ptiles]
// holding zeros (left at zero), ptiles = ceil(np / (L * 4)); else both
// may be null.
extern "C" int slamrs_nn_argmin(const void* p, const void* q,
                                const void* q_count, void* partials,
                                void* counters, void* out, int b, int np,
                                int nq, int threads_per_group, int groups,
                                int chunks, void* stream) {
  if (b <= 0 || np <= 0 || nq <= 0) return static_cast<int>(cudaGetLastError());
  const int L = threads_per_group;
  const int TL = L * kLanes;
  const long long ptiles = (np + TL - 1) / TL;
  const int chunk_max = (nq + chunks - 1) / chunks;
  const size_t smem = static_cast<size_t>(chunk_max) * sizeof(float4) +
                      static_cast<size_t>(groups) * TL * sizeof(float2);
  if (L <= 0 || groups <= 0 || chunks <= 0 || chunks > 65535 ||
      L * groups > 1024 || smem > 48 * 1024 ||
      b * ptiles > 0x7fffffffLL ||
      (chunks > 1 && (partials == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(b * ptiles), chunks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  nn_argmin_kernel<<<grid, L * groups, smem, st>>>(
      static_cast<const float2*>(p), static_cast<const float2*>(q),
      static_cast<const int*>(q_count), static_cast<float2*>(partials),
      static_cast<int*>(counters), static_cast<int*>(out), np, nq, L, groups,
      chunks, static_cast<int>(ptiles), chunk_max);
  return static_cast<int>(cudaGetLastError());
}
