// ICP nearest-neighbour correspondences for Hopper (sm_90a): for every
// source point p of problem b, the index of the closest reference point q.
//
// Replaces the Pallas TPU kernel slamrs_tpu/ops/icp.py::nearest_neighbors_fused
// (body _nn_kernel).  It computes what the plain version
// slamrs_tpu_torch/ops/icp.py::nearest_neighbors_reference computes, with
// the same float32 arithmetic per pair (built with --fmad=false, so each
// product and sum is rounded on its own and the indices agree bitwise):
//   q2 = qx*qx + qy*qy + (j < q_count ? 0 : 1e30)
//   d2 = q2 - 2 * (px*qx + py*qy)          (the p*p term is constant per p)
//   idx = first j of the minimum d2, then min(idx, Nq - 1), 0 if q_count == 0.
//
// Layout: a grid of (problem x p-tile, q-chunk).  A block of kThreads
// threads holds one p lane per thread and walks its q chunk through shared
// memory, kTile reference points at a time, as float4 {qx, qy, q2, 0}
// (one broadcast load per pair).  Each thread keeps a running minimum with
// a strict '<', so it keeps the first index of its chunk's minimum.  When
// the q axis is split over several chunks, the chunk results merge by
// atomicMin on a 64-bit key (order-preserving bits of d2) << 32 | index:
// d2 can be negative (the p*p term is dropped), so the float-to-key map
// keeps the order of negative values too; equal distances then compare by
// index, so the first index wins whatever order the blocks run in.  A
// second small kernel turns the keys into the clamped i32 indices.  With
// one chunk the main kernel writes the indices itself.  No [Np, Nq] matrix
// is ever written, and q_count is read on the device (no host sync).
//
// What bounds it on the H100: operations.  At bench.py's batch (2,048
// problems of 360 x 360) it covers 265 M pairs, ~6 float32 operations each
// (23.8 us at 67 TFLOP/s), against 14.8 MB of inputs and outputs (4.4 us
// at 3.35 TB/s).  At the ICP mapper's shape (360 x 16,384 lanes) the
// q-chunk split gives ~200 blocks, so the card is not left with 3 blocks
// looping over 16,384 points each; launch latency sets the time there.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // p lanes per block
constexpr int kTile = 256;     // q points staged in shared memory at a time
constexpr int kTargetBlocks = 132 * 16;  // enough blocks to fill 132 SMs
constexpr float kBig = 1e30f;

// Monotone map of a float to an unsigned key: a < b (as floats, no NaN)
// iff key(a) < key(b).  Adding +0 first maps -0 to +0, so equal floats
// give equal keys and the index decides.
__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t u = __float_as_uint(f + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ int finish_index(int idx, int nq, int qc) {
  return qc > 0 ? min(idx, nq - 1) : 0;
}

template <bool kSplit>
__global__ void __launch_bounds__(kThreads)
    nn_argmin_kernel(const float2* __restrict__ p, const float2* __restrict__ q,
                     const int* __restrict__ q_count,
                     unsigned long long* __restrict__ keys,
                     int* __restrict__ out, int np, int nq, int ptiles,
                     int chunk) {
  __shared__ float4 tile[kTile];
  const int b = blockIdx.x / ptiles;
  const int i = (blockIdx.x % ptiles) * kThreads + threadIdx.x;
  const int qc = q_count[b];
  const int j0 = blockIdx.y * chunk;
  const int j1 = min(j0 + chunk, nq);
  const float2* qb = q + static_cast<size_t>(b) * nq;

  float px = 0.0f, py = 0.0f;
  if (i < np) {
    const float2 pt = p[static_cast<size_t>(b) * np + i];
    px = pt.x;
    py = pt.y;
  }
  float best = 0.0f;
  int best_j = -1;
  for (int t0 = j0; t0 < j1; t0 += kTile) {
    const int n = min(kTile, j1 - t0);
    __syncthreads();  // the previous tile is fully read
    for (int k = threadIdx.x; k < n; k += kThreads) {
      const int j = t0 + k;
      const float2 v = qb[j];
      const float q2 = v.x * v.x + v.y * v.y + (j < qc ? 0.0f : kBig);
      tile[k] = make_float4(v.x, v.y, q2, 0.0f);
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float4 v = tile[k];
      const float d2 = v.z - 2.0f * (px * v.x + py * v.y);
      if (best_j < 0 || d2 < best) {
        best = d2;
        best_j = t0 + k;
      }
    }
  }
  if (i >= np || best_j < 0) return;
  const size_t o = static_cast<size_t>(b) * np + i;
  if (kSplit) {
    const unsigned long long key =
        (static_cast<unsigned long long>(order_key(best)) << 32) |
        static_cast<unsigned>(best_j);
    atomicMin(keys + o, key);
  } else {
    out[o] = finish_index(best_j, nq, qc);
  }
}

__global__ void nn_finish_kernel(const unsigned long long* __restrict__ keys,
                                 const int* __restrict__ q_count,
                                 int* __restrict__ out, int np, int nq,
                                 long long n) {
  const long long o = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (o >= n) return;
  const int idx = static_cast<int>(keys[o] & 0xffffffffull);
  out[o] = finish_index(idx, nq, q_count[o / np]);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 when every launch
// was accepted).  p: f32[b, np, 2]; q: f32[b, nq, 2] (nq > 0); q_count:
// i32[b]; keys: i64[b, np] scratch; out: i32[b, np].
extern "C" int slamrs_nn_argmin(const void* p, const void* q,
                                const void* q_count, void* keys, void* out,
                                int b, int np, int nq, void* stream) {
  if (b <= 0 || np <= 0 || nq <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ptiles = (np + kThreads - 1) / kThreads;
  const long long blocks = static_cast<long long>(b) * ptiles;
  // split q into chunks of whole tiles until the grid fills the card
  const long long max_chunks = (nq + kTile - 1) / kTile;
  long long want = (kTargetBlocks + blocks - 1) / blocks;
  if (want > max_chunks) want = max_chunks;
  if (want > 65535) want = 65535;
  int chunk = static_cast<int>((nq + want - 1) / want);
  chunk = (chunk + kTile - 1) / kTile * kTile;
  const int chunks = (nq + chunk - 1) / chunk;
  const dim3 grid(static_cast<unsigned>(blocks), chunks);
  const float2* p2 = static_cast<const float2*>(p);
  const float2* q2 = static_cast<const float2*>(q);
  const int* qc = static_cast<const int*>(q_count);
  int* o = static_cast<int*>(out);
  auto* k = static_cast<unsigned long long*>(keys);
  if (chunks == 1) {
    nn_argmin_kernel<false><<<grid, kThreads, 0, s>>>(p2, q2, qc, k, o, np, nq,
                                                     ptiles, chunk);
    return static_cast<int>(cudaGetLastError());
  }
  const long long n = static_cast<long long>(b) * np;
  cudaError_t err = cudaMemsetAsync(k, 0xff, n * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  nn_argmin_kernel<true><<<grid, kThreads, 0, s>>>(p2, q2, qc, k, o, np, nq,
                                                  ptiles, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kFinish = 256;
  nn_finish_kernel<<<static_cast<unsigned>((n + kFinish - 1) / kFinish),
                     kFinish, 0, s>>>(k, qc, o, np, nq, n);
  return static_cast<int>(cudaGetLastError());
}
