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
// What bounds it on the H100, and what the design does about it.  Only
// the cells of the scan disc can change, so the cell pass covers only the
// disc's bounding box (fused_common.cuh), computed in the kernel from the
// staged beam row: ~45 x 48 cells a particle at 0.05 m (1 m range) where
// the window has 56 x cols.  What is left:
//   - in place (config 3, [1024, 1000, 1024] bf16): the box pass alone,
//     ~2.3 M cells of ~60 float32 operations plus the likelihood: per-cell
//     arithmetic, no bytes outside the box are read or written;
//   - lineage (the headline [1024, 80, 128] and [1024, 200, 256]): every
//     output map is a fresh buffer written whole, so the 16-byte copy of
//     the words outside the box from the ancestor map adds the bytes of
//     the map set, overlapped with the box pass across the CTAs of an SM.
//     At 0.02 m the box is ~105 x 112 cells (11.5 M in all) and its
//     arithmetic outweighs the 210 MB of copies.
// The work has no products, so tensor cores do not apply.  ptxas: 32
// registers, 2,112 bytes of shared memory, no spills: 8 CTAs a SM, so
// 1,024 particles run in one wave.  One CTA per particle, 256 threads, in
// one of two modes:
//   - lineage (ping-pong): read grids_in[anc[i]], write grids_out[i], so
//     the likelihood read of the pre-update ancestor map can never race a
//     write (the deferred-lineage resample);
//   - in place (grids_out == grids_in, anc == nullptr: identity): each CTA
//     touches only its own map, its likelihood reads finish before the
//     __syncthreads() that precedes the box pass's writes, and nothing
//     outside the box is read or written (the counterpart of the aliased
//     _kernel_hbm; used by the copy-on-write and whole-set-gather resample).
//
// Per CTA (particle i):
//   1. likelihood: threads stride over the 512 beam lanes, compute each
//      valid beam's endpoint cell, and sum log(Z_HIT mixture) over the
//      beams whose endpoint lies inside the logical grid and the window
//      (an out-of-window endpoint adds nothing, as on the TPU); its
//      barrier also reduces dmax = max |d_enc| of the staged beam row;
//   2. the box from dmax and the particle's pose;
//   3. copy (lineage mode only): every 16-byte word of the ancestor map
//      outside the box goes to the output map, two loads in flight a
//      thread;
//   4. box pass: every box cell finds its beam by atan2 (static bin-units
//      or traced pipeline), decodes the quantized d_enc staged in shared
//      memory, applies the squared-space inverse sensor model times the
//      beam density, and stores f32(cell) + inc, rounded to bf16 for bf16
//      maps.
// The likelihood, the box and the cell pass are the shared device code of
// fused_common.cuh, which K3 (fused_update_tiled.cu) runs too.
//
// Worlds.  A fleet of W worlds is one launch over its W*P particles, maps
// flattened world by world: each world has its own scan, so the beam
// table is [W, 8, kBeamPad] and CTA i reads the table of its world,
// i / per_world (the JAX package vmaps its kernel over worlds,
// slamrs_tpu/parallel/shard.py).  Staging row 0, the likelihood and the
// box's dmax all read that table, so each world's box follows its own
// scan.  One world is the same launch with per_world = P.
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
  int per_world;         // particles a world; c.table is world 0's table
  ScanConsts c;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_update_kernel(Args a) {
  const int i = blockIdx.x;
  ScanConsts c = a.c;  // this particle's world's beam table
  c.table += static_cast<size_t>(i / a.per_world) * 8 * kBeamPad;
  const int cols = c.cols;
  const size_t map = static_cast<size_t>(a.rows) * cols;
  const int from = a.anc ? a.anc[i] : i;
  // not __restrict__: in place, src and dst are the same map
  const T* src = static_cast<const T*>(a.grids_in) + static_cast<size_t>(from) * map;
  T* dst = static_cast<T*>(a.grids_out) + static_cast<size_t>(i) * map;
  const Particle q = load_particle(a.pp + 8 * i, a.r0[i]);

  __shared__ float s_denc[kBeamPad];
  __shared__ float s_red[2 * kThreads / 32];
  const float dmax_part = stage_denc(c, s_denc);

  // 1. endpoint likelihood on the pre-update map (its barrier also
  //    publishes s_denc and reduces dmax)
  const T* win = src + static_cast<size_t>(q.r0) * cols;
  const float dmax = block_likelihood(
      c, q,
      [&](int wy, int wx) {
        return load_cell(win + static_cast<size_t>(wy) * cols + wx);
      },
      dmax_part, s_red, a.lik + i);

  // 2. the box; its columns are whole 16-byte words
  constexpr int kPerWord = 16 / sizeof(T);
  const Box box = cell_box(c, q, dmax, kPerWord);

  // 3. lineage mode only: the map outside the box, 16-byte copies
  //    (cols % 128 == 0, so every row is a whole number of uint4)
  if (src != dst) {
    copy_outside_box(reinterpret_cast<const uint4*>(src),
                     reinterpret_cast<uint4*>(dst), a.rows, cols / kPerWord,
                     q.r0 + box.y0, q.r0 + box.y1, box.x0 / kPerWord,
                     box.x1 / kPerWord);
  }

  // 4. inverse-sensor-model pass over the box
  box_pass(c, make_cell_pass(c, q), s_denc, box,
           [&](int wy, int wx, float inc) {
             const size_t off = static_cast<size_t>(q.r0 + wy) * cols + wx;
             store_cell(dst + off, load_cell(src + off) + inc);
           });
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 when
// the launch was accepted).  Pointers are device pointers of contiguous
// tensors; the caller has validated shapes and dtypes.  In place:
// grids_out == grids_in and anc == nullptr.  `table` holds p / per_world
// tables of 8 x kBeamPad floats, one per world.
extern "C" int slamrs_fused_update(const void* grids_in, void* grids_out,
                                   const void* anc, const void* pp,
                                   const void* r0, const void* table, void* lik,
                                   int p, int per_world, int rows, int cols,
                                   int wr,
                                   int logical_rows, int logical_cols,
                                   int num_beams, int is_bf16, int static_bins,
                                   float inv_s, float nbf, float inv_nbf,
                                   void* stream) {
  Args a{grids_in, grids_out, static_cast<const int*>(anc),
         static_cast<const float*>(pp), static_cast<const int*>(r0),
         static_cast<float*>(lik), rows, per_world,
         ScanConsts{static_cast<const float*>(table), wr, cols, logical_rows,
                    logical_cols, num_beams, static_bins, inv_s, nbf, inv_nbf}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    fused_update_kernel<__nv_bfloat16><<<p, kThreads, 0, s>>>(a);
  else
    fused_update_kernel<float><<<p, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
