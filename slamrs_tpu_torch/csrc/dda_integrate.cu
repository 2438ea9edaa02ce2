// The dda integrator's map update, for Hopper (sm_90a): for every
// particle, each present beam's DDA walk from the particle's cell to its
// endpoint's, the inverse sensor model's log-odds increment of every cell
// it emits, each map cell's increments summed, and the new maps written;
// the emitted lanes are added to the device counter dda.cells.
//
// Replaces no Pallas kernel: on the TPU this is the XLA body of
// slamrs_tpu/ops/grid.py::grid_integrate (traverse_ray, the inverse
// sensor model and a scatter-add).  In PyTorch that body is ~900 ATen
// kernels an update at [1024, 360] lanes and 34 steps (the walk's ~10
// elementwise kernels a step and its torch.stacks, the model, and one
// index_put_(accumulate=True): a radix sort of every (particle, beam,
// step) lane's flat cell index, then indexing_backward_kernel_stride_1);
// here it is one launch.  It gives the bits of the plain version
// slamrs_tpu_torch/ops/grid.py::grid_integrate_reference on the card:
//
//   the walk (traverse_ray), per lane, one rounding per ATen operation
//   (every float operation below is an explicitly rounded intrinsic):
//     dx = |x1 - x0|, dy = |y1 - y0|; x, y = int(floor(x0)), int(floor(y0))
//     budget = 1 + additional + (dx == 0 ? 0 : int(|floor(x1) - floor(x0)|
//              as the forward or backward difference)) + the same in y
//     error = err_x - err_y, err_x = (floor(x0) + 1 - x0) * dy forward,
//             (x0 - floor(x0)) * dy backward, inf where dx == 0
//     a step emits (x, y) while the budget lasts and the cell is in the
//     grid, and the walk ends at the first step that does not; then it
//     moves in y (error -= dx) where error > 0, else in x (error += dy);
//     a NaN error (both extents 0) steps x by 0 and stays on the cell
//   the increment (inverse_sensor_model_log_odds), per emitted lane:
//     d = sqrt((x + 0.5 - x0)^2 + (y + 0.5 - y0)^2), correctly rounded
//     hit: d < m - 1 free, d > m + 1 prior (+0.0), else occupied
//     miss: d < m free, else prior
//   the sum (index_put_(accumulate=True) on the card): the lanes in
//     (particle, beam, step) order, those not emitted adding +0.0 at the
//     particle's cell (0, 0); the radix sort is stable, so each cell's
//     run keeps lane order, and one warp sums a run of n lanes: lane j
//     adds entries j, j + 32, ... of the floor(n / 32) full passes from
//     0.0, a __shfl_down tree (offsets 16 ... 1) joins the lanes, lane 0
//     adds the rest in order and writes old + sum.  A run under 32 is so
//     summed in order from 0.0.  Cells no lane names keep their bits.
//
// Inputs.  The maps f32[P, H, W]; the grid coordinates the plain
// version computes in ATen (the start's x and y f32[P], the endpoints' x
// and y f32[P, B], the measured distances in cells f32) and the valid and
// present flags (bool); each of the last three is [B] (stride 0) or
// [P, B] (stride B).
// Host scalars come in a DdaIntegrateParams.  Outputs: the new maps
// f32[P, H, W] (another buffer) and an add to the int64 counter.
//
// Layout.  One CTA per particle (a run never crosses particles) of 384
// threads.  Every cell a walk emits lies within T - 1 steps of the start
// cell, so within a window of min(2T - 1, W) x min(2T - 1, H) cells; the
// CTA counts, orders and sums the window's cells in shared memory:
//   1. copy the old map to the new one; clear the window's counts;
//   2. each thread walks a beam, counting its emitted lanes per window
//      cell (shared atomics) and per beam;
//   3. block scans: the window cells' first slots, and each beam's
//      lanes not emitted before it (they precede nothing but cell
//      (0, 0)'s later entries);
//   4. the walk again: each emitted lane's beam and increment class, and
//      its window cell, into a slot of its cell's bucket (shared atomics:
//      any order);
//   5. a run under 32: each entry's rank by beam in its bucket (a beam
//      names a cell once, or thrice at one increment where both extents
//      are 0) is its place in the run, where its class is written (a
//      thread an entry); then a thread a cell adds the run in order;
//   6. a longer run, a warp each: the entries counted by beam, the
//      counts' exclusive sum each beam's first place; then added as
//      index_put_'s warp adds them.
// Every cell a lane names gets old + sum.  Cell (0, 0) takes the lanes
// not emitted: where the window holds it (as its cell 0), its run is laid
// out with a +0.0 for each of them, an emitted entry of beam b after
// those of beams < b; elsewhere no emitted lane reaches it and it gets
// old + 0.0.  One integer atomicAdd a CTA adds its emitted lanes to the
// counter (an integer sum: the same count in any order).  No per-lane
// global buffer, no host sync, no float atomics: the same bits every
// call, eager or replayed.
//
// What bounds it on the H100.  Each map is read and written once (52.4
// MB at [1024, 80, 80], ~16 us at 3.35 TB/s); the walk is ~20 integer and
// float operations a lane, twice, over 12.5 M lanes; the ordering works
// in shared memory (70,016 B a CTA at that shape, three CTAs an SM).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Host scalars of one call; the layout is ops/grid.py::_DdaParams'.
struct DdaIntegrateParams {
  int particles;
  int beams;
  int steps;           // the walk's static step count T
  int rows, cols;      // the map
  int win_rows, win_cols;  // the window, set by the entry: min(2T - 1, rows),
                           // min(2T - 1, cols)
  int budget0;         // 1 + the overshoot steps
  int measured_stride, valid_stride, present_stride;  // 0 or beams
  float l_free, l_occupied;  // the increments, float32
  float half_tolerance;      // tolerance / 2, in cells
};

namespace {

constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;
constexpr int kMiscInts = 32;  // scan scratch (kWarps + 1) and the long count
constexpr int kLongCount = kMiscInts - 1;
constexpr int kMaxBeams = 1 << 12;     // a bucket entry's beam field
constexpr int kMaxWindow = 1 << 16;    // cell_of's 16 bits

// a CTA's shared memory: the window's runs, per-beam and scan words, the
// lanes' buckets and their cells (or the per-warp beam counts)
__host__ __device__ inline size_t smem_bytes(int beams, int steps,
                                             int win_cells) {
  const size_t lanes = static_cast<size_t>(beams) * steps;
  const size_t cell_of = 2 * (lanes + lanes % 2);
  const size_t counts = static_cast<size_t>(4) * kWarps * beams;
  return 4 * (static_cast<size_t>(win_cells) + beams + lanes / 32 + 1 +
              kMiscInts) +
         2 * (lanes + lanes % 2) + (cell_of > counts ? cell_of : counts);
}

// int32 arithmetic wraps, as ATen's
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) +
                          static_cast<unsigned>(b));
}

// traverse_ray for one lane: calls emit(x, y) for each emitted cell, in
// step order, and returns at the first step that emits nothing
template <class Emit>
__device__ __forceinline__ void walk(float x0, float y0, float x1, float y1,
                                     const DdaIntegrateParams& prm,
                                     Emit emit) {
  const float dx = fabsf(__fsub_rn(x1, x0));
  const float dy = fabsf(__fsub_rn(y1, y0));
  const float fx0 = floorf(x0), fy0 = floorf(y0);
  const float fx1 = floorf(x1), fy1 = floorf(y1);
  int x = __float2int_rz(fx0), y = __float2int_rz(fy0);
  const bool fwd_x = x1 > x0, fwd_y = y1 > y0;
  const int nx = dx == 0.0f ? 0
                            : __float2int_rz(fwd_x ? __fsub_rn(fx1, fx0)
                                                   : __fsub_rn(fx0, fx1));
  const int ny = dy == 0.0f ? 0
                            : __float2int_rz(fwd_y ? __fsub_rn(fy1, fy0)
                                                   : __fsub_rn(fy0, fy1));
  int n = wrap_add(wrap_add(prm.budget0, nx), ny);
  const int x_inc = dx == 0.0f ? 0 : (fwd_x ? 1 : -1);
  const int y_inc = dy == 0.0f ? 0 : (fwd_y ? 1 : -1);
  const float err_x =
      dx == 0.0f ? INFINITY
                 : __fmul_rn(fwd_x ? __fsub_rn(__fadd_rn(fx0, 1.0f), x0)
                                   : __fsub_rn(x0, fx0),
                             dy);
  const float err_y =
      dy == 0.0f ? INFINITY
                 : __fmul_rn(fwd_y ? __fsub_rn(__fadd_rn(fy0, 1.0f), y0)
                                   : __fsub_rn(y0, fy0),
                             dx);
  float error = __fsub_rn(err_x, err_y);
  for (int t = 0; t < prm.steps; ++t) {
    if (!(n > 0 && x >= 0 && x < prm.cols && y >= 0 && y < prm.rows)) return;
    emit(x, y);
    if (error > 0.0f) {
      y = wrap_add(y, y_inc);
      error = __fsub_rn(error, dx);
    } else {
      x = wrap_add(x, x_inc);
      error = __fadd_rn(error, dy);
    }
    n = wrap_add(n, -1);
  }
}

// In-place exclusive scan of a[0, n) in shared memory by the whole CTA;
// returns the total.  Every thread calls it; it ends on a barrier.
__device__ int block_exclusive_scan(int* a, int n, int* scratch) {
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = min(static_cast<int>(threadIdx.x) * per, n);
  const int hi = min(lo + per, n);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += a[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = sum;
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < kWarps ? scratch[lane] : 0;
    int w_incl = v;
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w_incl, off);
      if (lane >= off) w_incl += u;
    }
    if (lane < kWarps) scratch[lane] = w_incl - v;
    if (lane == kWarps - 1) scratch[kWarps] = w_incl;
  }
  __syncthreads();
  int run = scratch[warp] + incl - sum;
  for (int i = lo; i < hi; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  const int total = scratch[kWarps];
  __syncthreads();
  return total;
}

// the increment classes: 0 prior (+0.0), 1 free, 2 occupied
__device__ __forceinline__ float increment(unsigned c,
                                           const DdaIntegrateParams& prm) {
  return c == 1u ? prm.l_free : (c == 2u ? prm.l_occupied : 0.0f);
}

// A bucket entry (16 bits): its beam (bits 4-15), the class of its lane
// (bits 0-1), and the class of the run's entry at its place (bits 2-3),
// set once by the entry ranked there
__device__ __forceinline__ void place(unsigned short* bucket, int pos,
                                      unsigned c) {
  atomicOr(reinterpret_cast<unsigned*>(bucket) + (pos >> 1),
           (c << 2) << (16 * (pos & 1)));
}

__device__ __forceinline__ unsigned placed(const unsigned short* bucket,
                                           int pos) {
  return (bucket[pos] >> 2) & 3u;
}

__global__ void __launch_bounds__(kThreads)
dda_integrate_kernel(const float* __restrict__ grid,
                     const float* __restrict__ start_x,
                     const float* __restrict__ start_y,
                     const float* __restrict__ end_x,
                     const float* __restrict__ end_y,
                     const float* __restrict__ measured,
                     const unsigned char* __restrict__ valid,
                     const unsigned char* __restrict__ present,
                     float* __restrict__ out,
                     unsigned long long* __restrict__ cells,
                     const DdaIntegrateParams prm) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int p = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = prm.beams, wc = prm.win_cols;
  const int lanes = nb * prm.steps, nwin = wc * prm.win_rows;
  int* run = reinterpret_cast<int*>(smem);  // [nwin]: counts, slots, ends
  int* beam = run + nwin;                   // [nb]: emitted, then M_b
  int* longs = beam + nb;                   // [lanes / 32 + 1]
  int* misc = longs + lanes / 32 + 1;       // [kMiscInts]
  unsigned short* bucket =
      reinterpret_cast<unsigned short*>(misc + kMiscInts);  // [lanes]
  // step 5's window cell of each bucket slot, then step 6's counts
  unsigned short* cell_of = bucket + lanes + lanes % 2;  // [lanes]
  int* counts = reinterpret_cast<int*>(cell_of);  // [kWarps][nb]

  const size_t hw = static_cast<size_t>(prm.rows) * prm.cols;
  const float* old = grid + static_cast<size_t>(p) * hw;
  float* dst = out + static_cast<size_t>(p) * hw;
  const float x0 = start_x[p], y0 = start_y[p];
  // the window: every emitted cell is within T - 1 steps of the start's
  const long long xs = __float2int_rz(floorf(x0));
  const long long ys = __float2int_rz(floorf(y0));
  const int ox = static_cast<int>(
      min(max(xs - (prm.steps - 1), 0LL),
          static_cast<long long>(prm.cols - wc)));
  const int oy = static_cast<int>(
      min(max(ys - (prm.steps - 1), 0LL),
          static_cast<long long>(prm.rows - prm.win_rows)));
  const bool corner = ox == 0 && oy == 0;  // window cell 0 is cell (0, 0)
  const float* m_row = measured + static_cast<size_t>(p) * prm.measured_stride;
  const unsigned char* v_row = valid + static_cast<size_t>(p) * prm.valid_stride;
  const unsigned char* pr_row =
      present + static_cast<size_t>(p) * prm.present_stride;
  const float* ex_row = end_x + static_cast<size_t>(p) * nb;
  const float* ey_row = end_y + static_cast<size_t>(p) * nb;

  // 1. the old map into the new; the window's counts cleared
  if (hw % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(old) | reinterpret_cast<uintptr_t>(dst)) &
       15) == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(old);
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (size_t i = tid; i < hw / 4; i += kThreads) dst4[i] = src4[i];
  } else {
    for (size_t i = tid; i < hw; i += kThreads) dst[i] = old[i];
  }
  for (int i = tid; i < nwin; i += kThreads) run[i] = 0;
  if (tid == 0) misc[kLongCount] = 0;
  __syncthreads();

  // 2. the walk: emitted lanes per window cell and per beam
  for (int b = tid; b < nb; b += kThreads) {
    int emitted = 0;
    if (pr_row[b]) {
      walk(x0, y0, ex_row[b], ey_row[b], prm, [&](int x, int y) {
        atomicAdd(&run[(y - oy) * wc + (x - ox)], 1);
        ++emitted;
      });
    }
    beam[b] = prm.steps - emitted;  // the beam's lanes not emitted
  }
  __syncthreads();

  // 3. M_b (lanes not emitted before beam b), their total, and each
  // window cell's first slot; cell (0, 0)'s run starts with the M zeros
  const int masked = block_exclusive_scan(beam, nb, misc);
  if (corner && tid == 0) run[0] += masked;
  __syncthreads();
  const int total = block_exclusive_scan(run, nwin, misc);
  if (tid == 0) {
    if (corner) run[0] += masked;  // emitted entries after the zeros
    const int emitted = lanes - masked;
    if (emitted > 0)
      atomicAdd(cells, static_cast<unsigned long long>(emitted));
  }
  if (corner)  // the places of cell (0, 0)'s +0.0s: no entry, class 0
    for (int i = tid; i < masked; i += kThreads) bucket[i] = 0;
  __syncthreads();

  // 4. the walk again: each emitted lane's beam and class into its bucket
  for (int b = tid; b < nb; b += kThreads) {
    if (!pr_row[b]) continue;
    const float m = m_row[b];
    const bool hit = v_row[b] != 0;
    const float below = __fsub_rn(m, prm.half_tolerance);
    const float above = __fadd_rn(m, prm.half_tolerance);
    walk(x0, y0, ex_row[b], ey_row[b], prm, [&](int x, int y) {
      const float ddx = __fsub_rn(__fadd_rn(__int2float_rn(x), 0.5f), x0);
      const float ddy = __fsub_rn(__fadd_rn(__int2float_rn(y), 0.5f), y0);
      const float d =
          __fsqrt_rn(__fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy)));
      const unsigned c = hit ? (d < below ? 1u : (d > above ? 0u : 2u))
                             : (d < m ? 1u : 0u);
      const int w = (y - oy) * wc + (x - ox);
      const int slot = atomicAdd(&run[w], 1);
      bucket[slot] = static_cast<unsigned short>((b << 4) | c);
      cell_of[slot] = static_cast<unsigned short>(w);
    });
  }
  __syncthreads();

  // 5. run[w] is now the end of window cell w's entries.  In a run under
  // 32, each entry's rank by beam in its bucket places its class in run
  // order (a thread an entry); then a thread a cell sums such a run in
  // order.  Longer runs wait for a warp
  for (int i = corner ? masked + tid : tid; i < total; i += kThreads) {
    const int w = cell_of[i];
    const int seg = w == 0 ? 0 : run[w - 1], end = run[w];
    if (end - seg >= 32) continue;
    const bool zeros = corner && w == 0;  // after the M +0.0s
    const int first = zeros ? masked : seg;
    const unsigned e = bucket[i], b = e >> 4;
    int rank = 0;
    for (int j = first; j < end; ++j) {
      const unsigned bj = bucket[j] >> 4;
      rank += (bj < b) || (bj == b && j < i);
    }
    place(bucket, seg + rank + (zeros ? beam[b] : 0), e & 3u);
  }
  __syncthreads();
  for (int w = tid; w < nwin; w += kThreads) {
    const int seg = w == 0 ? 0 : run[w - 1], end = run[w];
    const int n = end - seg;
    if (n == 0) continue;
    if (n >= 32) {
      longs[atomicAdd(&misc[kLongCount], 1)] = w;
      continue;
    }
    const size_t g =
        static_cast<size_t>(oy + w / wc) * prm.cols + (ox + w % wc);
    const float before = old[g];
    float sum = 0.0f;
    for (int k = seg; k < end; ++k)
      sum = __fadd_rn(sum, increment(placed(bucket, k), prm));
    dst[g] = __fadd_rn(before, sum);
  }
  if (!corner && masked > 0 && tid == 0) dst[0] = __fadd_rn(old[0], 0.0f);
  __syncthreads();

  // 6. the runs of 32 or more, a warp each: the bucket's entries counted
  // by beam in the warp's own counts, whose exclusive sum (plus M_b in
  // cell (0, 0)'s run) is each beam's place in the run (a beam's entries
  // are one increment); then summed as index_put_'s warp sums them
  int* cnt = counts + warp * nb;
  const int n_long = misc[kLongCount];
  for (int k = warp; k < n_long; k += kWarps) {
    const int w = longs[k];
    const int seg = w == 0 ? 0 : run[w - 1], end = run[w];
    const int n = end - seg;
    const bool zeros = corner && w == 0;
    const int first = zeros ? masked : seg;
    for (int b = lane; b < nb; b += 32) cnt[b] = 0;
    __syncwarp();
    for (int i = first + lane; i < end; i += 32)
      atomicAdd(&cnt[bucket[i] >> 4], 1);
    __syncwarp();
    int carry = seg;
    for (int b0 = 0; b0 < nb; b0 += 32) {
      const int b = b0 + lane;
      const int v = b < nb ? cnt[b] : 0;
      int incl = v;
      for (int off = 1; off < 32; off <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += u;
      }
      if (b < nb) cnt[b] = carry + incl - v + (zeros ? beam[b] : 0);
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    __syncwarp();
    for (int i = first + lane; i < end; i += 32) {
      const unsigned e = bucket[i];
      place(bucket, atomicAdd(&cnt[e >> 4], 1), e & 3u);
    }
    __syncwarp();
    const int passes = n >> 5;
    float sum = 0.0f;
    for (int i = 0; i < passes; ++i)
      sum = __fadd_rn(sum, increment(placed(bucket, seg + i * 32 + lane), prm));
    for (int off = 16; off > 0; off >>= 1)
      sum = __fadd_rn(sum, __shfl_down_sync(0xffffffffu, sum, off));
    if (lane == 0) {
      for (int i = passes * 32; i < n; ++i)
        sum = __fadd_rn(sum, increment(placed(bucket, seg + i), prm));
      const size_t g =
          static_cast<size_t>(oy + w / wc) * prm.cols + (ox + w % wc);
      dst[g] = __fadd_rn(old[g], sum);
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int slamrs_dda_integrate(const void* grid, const void* start_x,
                                    const void* start_y, const void* end_x,
                                    const void* end_y, const void* measured,
                                    const void* valid, const void* present,
                                    void* out, void* cells,
                                    const DdaIntegrateParams* params,
                                    void* stream) {
  if (params == nullptr || params->particles <= 0 || params->beams <= 0 ||
      params->beams > kMaxBeams || params->steps <= 0 ||
      params->steps > (1 << 20) || params->rows <= 0 || params->cols <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // every cell a walk of T steps can emit lies within T - 1 of its start
  DdaIntegrateParams prm = *params;
  const int side = 2 * prm.steps - 1;
  prm.win_rows = side < prm.rows ? side : prm.rows;
  prm.win_cols = side < prm.cols ? side : prm.cols;
  if (static_cast<long long>(prm.win_rows) * prm.win_cols > kMaxWindow)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(prm.beams, prm.steps,
                                  prm.win_rows * prm.win_cols);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bytes > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  // raise the kernel's dynamic shared memory limit once a device
  static int raised[64] = {0};
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(dda_integrate_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised[dev] = 1;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dda_integrate_kernel<<<prm.particles, kThreads, bytes, st>>>(
      static_cast<const float*>(grid), static_cast<const float*>(start_x),
      static_cast<const float*>(start_y), static_cast<const float*>(end_x),
      static_cast<const float*>(end_y), static_cast<const float*>(measured),
      static_cast<const unsigned char*>(valid),
      static_cast<const unsigned char*>(present), static_cast<float*>(out),
      static_cast<unsigned long long*>(cells), prm);
  return static_cast<int>(cudaGetLastError());
}
