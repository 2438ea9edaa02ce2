// The selection step of one grid SLAM update, for Hopper (sm_90a): the
// weight carry, normalization, argmax, N_eff, the N_eff-gated systematic
// resample, and the pose gathers, for one world's particles.
//
// Replaces no Pallas kernel: on the TPU this is the XLA body of
// slamrs_tpu/models/gridslam.py::_weigh_and_select and update's gathers.
// In PyTorch that body is ~31 small ATen kernels an update
// (_weigh_and_select 10, systematic_resample 9, normalize_log_weights 5,
// effective_particles 4, the gathers 3); here it is one launch.  It
// computes what the plain version
// slamrs_tpu_torch/ops/select.py::slam_select_reference computes, in
// float32, one rounding per ATen operation, and every sum in the order
// the card's ATen kernels sum, so the same bits:
//
//   log_w = (logf(prev_weights) + log_lik) + log_motion
//   e = expf(log_w - amax(log_w)),  w = e / sum(e)
//   best = argmax(w): the lowest index among equal maxima, NaN first
//   n_eff = (1 / sum(w * w)) * 1          (`1.0 / t` is reciprocal * 1)
//   fire = n_eff <= gate                   (gate: float32(frac * P))
//   u_m = u01 * (1 / P) + m * (1 / P)     (ATen's division of a tensor by
//         a host scalar multiplies by the float32 reciprocal)
//   cum = cumsum(w),  a_m = clamp(#(cum_i < u_m), 0, P - 1)
//   ancestors = fire ? a : identity,  weights = fire ? float32(1 / P) : w
//   best_pose = poses[best],  poses_out[m] = poses[ancestors[m]]
//
// The orders, proven on the card against torch 2.11 (cu128) with inputs
// whose sums differ under any other order (tests/test_torch_cuda.py,
// chip_smoke.aten_row_sum_model and cub_scan_model):
//
//   sum over one contiguous row of n (ATen Reduce.cuh, vt0 = 4, four
//     floats a vector load, 512 threads at most): for n >= 128 the row is
//     read as n / 4 vectors by bw = last_pow2(n / 4) threads, thread t
//     keeping four accumulators (lane i of vectors t, t + bw, ...) from
//     0.0, the tail (n % 4 floats) added to accumulator 0 of threads 0..;
//     below 128 bw = last_pow2(n) threads, accumulator i of thread t
//     holding x[t + i * bw] (a strided pass of four); then ((a0 + a1) +
//     a2) + a3, a shared-memory tree v[t] += v[t + off] for off = bw / 2
//     down to 32, and a warp tree with offsets 16 (or bw / 2) down to 1.
//   cumsum of a tensor whose numel is its length (CUB's inclusive scan,
//     one tile while n <= 1,920): thread t holds items 15t .. 15t + 14,
//     sums them left to right, a Kogge-Stone warp scan (offsets 1 .. 16)
//     of those sums, warp w's prefix the left-to-right sum of warps 0 ..
//     w - 1's totals, then each thread's items scanned left to right from
//     its exclusive prefix (thread 0 from its first item).
//   amax and argmax are order-free; the ancestor count is an integer sum.
//
// Inputs: prev_weights, log_lik, log_motion f32[P], u01 f32[1], the
// sampled poses f32[P, 3]; host scalars in a SlamSelectParams.  Outputs:
// weights f32[P], ancestors i32[P], best_idx i32[], n_eff f32[],
// do_resample bool[], best_pose f32[3], and, where asked, the gathered
// poses f32[P, 3].
//
// Layout.  One CTA of P threads rounded up to a warp, P <= 1,024 (the
// entry refuses more), one thread a particle; every row lives in shared
// memory.  The count is #(cum_i < u_m) for every i: a float cumsum is not
// monotone under every association, so nothing searches cum.  The offsets
// u_m are non-decreasing in m (u01 * (1/P) plus a monotone rounding of
// m * (1/P), rounded), so cum_i < u_m holds for m from some k_i on; thread
// i finds k_i by bisecting u, adds 1 to a shared histogram at k_i, and
// a_m is the histogram's integer prefix sum at m.  That is the count's
// value exactly (integers, in any order), at ~10 steps a particle where
// comparing every pair takes P^2 compares on one SM (32.3 us at 1,024,
// measured).  The only atomics are those integer adds, so a call gives
// the same bits every time, eager or replayed.
//
// What bounds it on the H100.  Latency: it reads 24 B and writes 24 B a
// particle (~49 KB at 1,024) and bisects ~10 steps a particle on one SM;
// the design keeps the selection to one launch.

#include <cuda_runtime.h>
#include <math.h>

// Host scalars of one call; the layout is ops/select.py::_Params'.
struct SlamSelectParams {
  int particles;
  int gather;     // 1: write the gathered poses
  float gate;     // float32(frac * P)
  float inv_n;    // float32 1 / float32(P)
  float uniform;  // float32 of the double 1 / P
};

namespace {

constexpr int kMaxParticles = 1024;
constexpr int kWarp = 32;
constexpr int kScanItems = 15;        // CUB's items a thread (float, sm_90)
constexpr int kSumVector = 4;         // ATen's vt0 and input_vec_size
constexpr int kSumThreads = kMaxParticles / kSumVector;  // bw's ceiling
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int last_pow2(int n) {
  return 1 << (31 - __clz(n));
}

// ATen's max_propagate_nan
__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

// ATen's argmax preference: NaN first, then the larger, ties the lower index
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  if (isnan(a)) return isnan(b) ? ia < ib : true;
  if (isnan(b)) return false;
  return a == b ? ia < ib : a > b;
}

// The threads ATen's row sum of n floats reads with (bw, see the header).
__device__ __forceinline__ int sum_threads(int n) {
  return last_pow2(n >= 128 ? n / kSumVector : n);
}

// Thread t's value before the cross-thread tree of ATen's row sum of
// x[0, n): its four accumulators' sum (t < sum_threads(n)).
__device__ float sum_partial(const float* x, int n, int t) {
  const bool vec = n >= 128;
  const int bw = sum_threads(n);
  float a[kSumVector] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (vec) {
    for (int idx = t; idx * kSumVector + kSumVector - 1 < n; idx += bw)
#pragma unroll
      for (int i = 0; i < kSumVector; ++i)
        a[i] = __fadd_rn(a[i], x[idx * kSumVector + i]);
    const int j = n - n % kSumVector + t;
    if (j < n) a[0] = __fadd_rn(a[0], x[j]);
  } else {
    int idx = t;
    for (; idx + (kSumVector - 1) * bw < n; idx += kSumVector * bw)
#pragma unroll
      for (int i = 0; i < kSumVector; ++i)
        a[i] = __fadd_rn(a[i], x[idx + i * bw]);
    for (int i = 0; i < kSumVector && idx < n; ++i, idx += bw)
      a[i] = __fadd_rn(a[i], x[idx]);
  }
  return __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), a[2]), a[3]);
}

// The cross-thread tree of ATen's row sum over the partials red[0, bw):
// v[t] += v[t + off] for off = bw / 2 down to 32, then the warp tree.
// Every warp computes it, so every thread gets the sum with no barrier.
__device__ float sum_tree(const float* red, int bw) {
  const int lane = threadIdx.x % kWarp;
  float v;
  int dim_x = bw;
  if (bw > kWarp) {  // lane l holds v[l + 32 k]
    float a[kSumThreads / kWarp];
#pragma unroll
    for (int k = 0; k < kSumThreads / kWarp; ++k)
      a[k] = k < bw / kWarp ? red[lane + kWarp * k] : 0.0f;
    if (bw >= 256)
#pragma unroll
      for (int k = 0; k < 4; ++k) a[k] = __fadd_rn(a[k], a[k + 4]);
    if (bw >= 128)
#pragma unroll
      for (int k = 0; k < 2; ++k) a[k] = __fadd_rn(a[k], a[k + 2]);
    v = __fadd_rn(a[0], a[1]);
    dim_x = kWarp;
  } else {
    v = lane < bw ? red[lane] : 0.0f;
  }
  for (int off = dim_x >> 1; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(kFull, v, off));
  return __shfl_sync(kFull, v, 0);
}

__global__ void __launch_bounds__(kMaxParticles)
slam_select_kernel(const float* __restrict__ prev_weights,
                   const float* __restrict__ log_lik,
                   const float* __restrict__ log_motion,
                   const float* __restrict__ u01,
                   const float* __restrict__ poses, const SlamSelectParams p,
                   float* __restrict__ weights_out,
                   int* __restrict__ ancestors_out, int* __restrict__ best_out,
                   float* __restrict__ n_eff_out,
                   unsigned char* __restrict__ fire_out,
                   float* __restrict__ best_pose_out,
                   float* __restrict__ poses_out) {
  __shared__ float pose[3 * kMaxParticles];
  __shared__ float w[kMaxParticles];    // exp, then the weights
  __shared__ float sq[kMaxParticles];   // the squares, then the offsets u
  __shared__ float cum[kMaxParticles];
  __shared__ int hist[kMaxParticles];
  __shared__ float red[kSumThreads];    // a row sum's partials
  __shared__ float warp_max[kWarp], warp_best[kWarp], scan_total[kWarp];
  __shared__ int warp_best_idx[kWarp], hist_total[kWarp];
  const int n = p.particles, t = threadIdx.x;
  const int lane = t % kWarp, warp = t / kWarp;
  const bool live = t < n;
  const int bw = sum_threads(n);

  // the carried log-weight; the poses staged for the gathers
  float lw = -INFINITY;
  if (live) {
    lw = __fadd_rn(__fadd_rn(logf(prev_weights[t]), log_lik[t]),
                   log_motion[t]);
#pragma unroll
    for (int k = 0; k < 3; ++k) pose[3 * t + k] = poses[3 * t + k];
  }
  float m = lw;
  for (int off = kWarp / 2; off > 0; off >>= 1)
    m = max_nan(m, __shfl_xor_sync(kFull, m, off));
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  m = lane < blockDim.x / kWarp ? warp_max[lane] : -INFINITY;
  for (int off = kWarp / 2; off > 0; off >>= 1)
    m = max_nan(m, __shfl_xor_sync(kFull, m, off));

  // the normalizing sum and the weights
  const float e = live ? expf(__fsub_rn(lw, m)) : 0.0f;
  w[t] = e;
  __syncthreads();
  if (t < bw) red[t] = sum_partial(w, n, t);
  __syncthreads();
  const float wt = __fdiv_rn(e, sum_tree(red, bw));
  w[t] = wt;
  sq[t] = __fmul_rn(wt, wt);
  float bv = live ? wt : -INFINITY;
  int bi = live ? t : n;
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, bv, off);
    const int oi = __shfl_xor_sync(kFull, bi, off);
    if (better(ov, oi, bv, bi)) bv = ov, bi = oi;
  }
  if (lane == 0) warp_best[warp] = bv, warp_best_idx[warp] = bi;
  __syncthreads();

  // argmax; the squares' partials; CUB's scan: each thread's item sum,
  // the warp's Kogge-Stone scan of them, the warps' totals
  bv = lane < blockDim.x / kWarp ? warp_best[lane] : -INFINITY;
  bi = lane < blockDim.x / kWarp ? warp_best_idx[lane] : n;
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, bv, off);
    const int oi = __shfl_xor_sync(kFull, bi, off);
    if (better(ov, oi, bv, bi)) bv = ov, bi = oi;
  }
  if (t < bw) red[t] = sum_partial(sq, n, t);
  const int first = t * kScanItems;
  float item[kScanItems], excl = 0.0f;
  if (warp * kWarp * kScanItems < n) {  // the warps holding items
#pragma unroll
    for (int j = 0; j < kScanItems; ++j)
      item[j] = first + j < n ? w[first + j] : 0.0f;
    float incl = item[0];  // items past n only feed later threads' prefixes
#pragma unroll
    for (int j = 1; j < kScanItems; ++j) incl = __fadd_rn(incl, item[j]);
#pragma unroll
    for (int off = 1; off < kWarp; off <<= 1) {
      const float o = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl = __fadd_rn(o, incl);
    }
    excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == kWarp - 1) scan_total[warp] = incl;
  }
  __syncthreads();

  // N_eff and the gate; each thread's items scanned from its prefix; the
  // offsets u_m
  const float n_eff = __fmul_rn(__fdiv_rn(1.0f, sum_tree(red, bw)), 1.0f);
  const bool fire = n_eff <= p.gate;
  if (first < n) {
    if (warp > 0) {
      float prefix = scan_total[0];
      for (int k = 1; k < warp; ++k)
        prefix = __fadd_rn(prefix, scan_total[k]);
      excl = lane == 0 ? prefix : __fadd_rn(prefix, excl);
    }
    float s = t == 0 ? item[0] : __fadd_rn(excl, item[0]);
    cum[first] = s;
#pragma unroll
    for (int j = 1; j < kScanItems; ++j) {
      s = __fadd_rn(s, item[j]);
      if (first + j < n) cum[first + j] = s;
    }
  }
  sq[t] = __fadd_rn(__fmul_rn(*u01, p.inv_n),
                    __fmul_rn(static_cast<float>(t), p.inv_n));
  hist[t] = 0;
  __syncthreads();

  // the count a_m = #(cum_i < u_m): k_i by bisecting u, a histogram of
  // k_i, and its integer prefix sum
  int anc = t;
  if (fire) {
    if (live) {
      const float c = cum[t];
      int lo = 0, hi = n;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (c < sq[mid]) hi = mid; else lo = mid + 1;
      }
      if (lo < n) atomicAdd(&hist[lo], 1);
    }
    __syncthreads();
    int v = hist[t];
#pragma unroll
    for (int off = 1; off < kWarp; off <<= 1) {
      const int o = __shfl_up_sync(kFull, v, off);
      if (lane >= off) v += o;
    }
    if (lane == kWarp - 1) hist_total[warp] = v;
    __syncthreads();
    int before = lane < warp ? hist_total[lane] : 0;
    for (int off = kWarp / 2; off > 0; off >>= 1)
      before += __shfl_xor_sync(kFull, before, off);
    anc = min(v + before, n - 1);
  }
  if (live) {
    weights_out[t] = fire ? p.uniform : wt;
    ancestors_out[t] = anc;
    if (p.gather)
#pragma unroll
      for (int k = 0; k < 3; ++k) poses_out[3 * t + k] = pose[3 * anc + k];
  }
  if (t < 3) best_pose_out[t] = pose[3 * bi + t];
  if (t == 0) {
    *best_out = bi;
    *n_eff_out = n_eff;
    *fire_out = fire;
  }
}

}  // namespace

extern "C" int slamrs_slam_select(
    const void* prev_weights, const void* log_lik, const void* log_motion,
    const void* u01, const void* poses, const SlamSelectParams* params,
    void* weights_out, void* ancestors_out, void* best_out, void* n_eff_out,
    void* fire_out, void* best_pose_out, void* poses_out, void* stream) {
  if (params == nullptr || params->particles <= 0 ||
      params->particles > kMaxParticles ||
      (params->gather && poses_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (params->particles + kWarp - 1) / kWarp * kWarp;
  slam_select_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(prev_weights),
      static_cast<const float*>(log_lik),
      static_cast<const float*>(log_motion), static_cast<const float*>(u01),
      static_cast<const float*>(poses), *params,
      static_cast<float*>(weights_out), static_cast<int*>(ancestors_out),
      static_cast<int*>(best_out), static_cast<float*>(n_eff_out),
      static_cast<unsigned char*>(fire_out),
      static_cast<float*>(best_pose_out), static_cast<float*>(poses_out));
  return static_cast<int>(cudaGetLastError());
}
