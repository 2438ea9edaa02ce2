// Fused RBPF grid-SLAM update for Hopper (sm_90a): the endpoint
// likelihood and the dense inverse-sensor-model integrate of every
// particle in one launch.
//
// Replaces the Pallas TPU kernel slamrs_tpu/ops/fused.py::fused_update
// (kernel bodies _kernel_resident, _kernel_resident_anc, _kernel_hbm_anc,
// _kernel_hbm_staged and _kernel_hbm, with their shared _window_compute,
// _cell_pass and _lik_* helpers).  It computes what the plain version
// slamrs_tpu_torch/ops/fused.py::fused_update_reference computes; none of
// the TPU's VMEM residency, particle batching, lane packing, column rolls
// or staged windows is carried over.
//
// What bounds it on the H100: at the headline shape (1,024 particles of
// [80, 128] bf16 maps) one update reads and writes the 21 MB map set once,
// and each of the 1024 x 56 x 128 window cells costs about 40 flops plus an
// atan2.  Both are small next to the launch and host overheads of the
// rollout around the kernel.  The design does nothing about that yet:
// one CTA per particle, 256 threads, in one of two modes:
//   - lineage (ping-pong): read grids_in[anc[i]], write grids_out[i], so
//     the likelihood read of the pre-update ancestor map can never race a
//     write (the deferred-lineage resample);
//   - in place (grids_out == grids_in, anc == nullptr: identity): each CTA
//     touches only its own map, its likelihood reads finish before the
//     __syncthreads() that precedes the cell pass's writes, and the rows
//     outside the window are not copied (the counterpart of the aliased
//     _kernel_hbm; used by the copy-on-write and whole-set-gather resample).
//
// Per CTA (particle i):
//   1. likelihood: threads stride over the 512 beam lanes, compute each
//      valid beam's endpoint cell, and sum log(Z_HIT mixture) over the
//      beams whose endpoint lies inside the logical grid and the window
//      (an out-of-window endpoint adds nothing, as on the TPU);
//   2. copy (lineage mode only): rows outside [r0, r0 + wr) go from the
//      ancestor map to the output map with 16-byte vector loads;
//   3. cell pass: every window cell finds its beam by atan2 (static
//      bin-units or traced pipeline), decodes the quantized d_enc staged
//      in shared memory, applies the squared-space inverse sensor model
//      times the beam density, and stores f32(cell) + inc, rounded to
//      bf16 for bf16 maps.
// The likelihood and the cell pass are the shared device code of
// fused_common.cuh, which K3 (fused_update_tiled.cu) runs too.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -Xcompiler -fPIC -c, then linked -shared with the
//        other sources (slamrs_tpu_torch/kernels).
// --fmad=false keeps products and sums separately rounded, as the plain
// PyTorch version rounds them.

#include "fused_common.cuh"

namespace {

using namespace slamrs;

struct Args {
  const void* grids_in;  // [P, rows, cols] T, read through anc
  void* grids_out;       // [P, rows, cols] T; == grids_in in place
  const int* anc;        // [P] pending lineage, or nullptr (identity)
  const float* pp;       // [P, 8] cx, cy, theta, ta-or-T, cos, sin, dphi, 1/dphi
  const int* r0;         // [P] window row offsets
  float* lik;            // [P]
  int rows;
  ScanConsts c;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_update_kernel(Args a) {
  const int i = blockIdx.x;
  const int cols = a.c.cols;
  const int wr = a.c.wr;
  const size_t map = static_cast<size_t>(a.rows) * cols;
  const int from = a.anc ? a.anc[i] : i;
  // not __restrict__: in place, src and dst are the same map
  const T* src = static_cast<const T*>(a.grids_in) + static_cast<size_t>(from) * map;
  T* dst = static_cast<T*>(a.grids_out) + static_cast<size_t>(i) * map;
  const Particle q = load_particle(a.pp + 8 * i, a.r0[i]);

  __shared__ float s_denc[kBeamPad];
  __shared__ float s_warp[kThreads / 32];
  stage_denc(a.c, s_denc);

  // 1. endpoint likelihood on the pre-update map (its barrier also
  //    publishes s_denc)
  const T* win = src + static_cast<size_t>(q.r0) * cols;
  block_likelihood(
      a.c, q,
      [&](int wy, int wx) {
        return load_cell(win + static_cast<size_t>(wy) * cols + wx);
      },
      s_warp, a.lik + i);

  // 2. rows outside the window, lineage mode only: 16-byte copies
  //    (cols % 128 == 0, so every row is a whole number of uint4)
  if (src != dst) {
    const size_t per_row = static_cast<size_t>(cols) * sizeof(T) / 16;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    block_copy16(s4, d4, static_cast<size_t>(q.r0) * per_row);
    const size_t tail = static_cast<size_t>(q.r0 + wr) * per_row;
    block_copy16(s4 + tail, d4 + tail, static_cast<size_t>(a.rows) * per_row - tail);
  }

  // 3. dense inverse-sensor-model pass over the [wr, cols] window
  const CellPass k = make_cell_pass(a.c, q);
  const int n = wr * cols;
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const int wy = idx / cols;
    const int wx = idx - wy * cols;
    const float inc = cell_increment(a.c, k, s_denc, wy, wx);
    const size_t off = static_cast<size_t>(q.r0 + wy) * cols + wx;
    store_cell(dst + off, load_cell(src + off) + inc);
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 when
// the launch was accepted).  Pointers are device pointers of contiguous
// tensors; the caller has validated shapes and dtypes.  In place:
// grids_out == grids_in and anc == nullptr.
extern "C" int slamrs_fused_update(const void* grids_in, void* grids_out,
                                   const void* anc, const void* pp,
                                   const void* r0, const void* table, void* lik,
                                   int p, int rows, int cols, int wr,
                                   int logical_rows, int logical_cols,
                                   int num_beams, int is_bf16, int static_bins,
                                   float inv_s, float nbf, float inv_nbf,
                                   void* stream) {
  Args a{grids_in, grids_out, static_cast<const int*>(anc),
         static_cast<const float*>(pp), static_cast<const int*>(r0),
         static_cast<float*>(lik), rows,
         ScanConsts{static_cast<const float*>(table), wr, cols, logical_rows,
                    logical_cols, num_beams, static_bins, inv_s, nbf, inv_nbf}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    fused_update_kernel<__nv_bfloat16><<<p, kThreads, 0, s>>>(a);
  else
    fused_update_kernel<float><<<p, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
