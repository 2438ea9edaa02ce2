// Fused RBPF grid-SLAM update over tiled maps for Hopper (sm_90a): K1's
// likelihood and cell pass, on maps that are views of a shared pool of
// full-width row-band tiles, with copy-on-write band privatization.
//
// Replaces the Pallas TPU kernel slamrs_tpu/ops/tiles.py::fused_update_tiled
// (bodies _kernel_tiled, the 2-band span, and _kernel_tiled_cached, the
// k-band span).  It computes what the plain version
// slamrs_tpu_torch/ops/tiles.py::fused_update_tiled_reference computes.  The
// TPU's double-buffered DMA schedule, particle batching, shared-window
// cache, 128-lane crop and lane rolls are not carried over: the cell pass
// covers the scan disc's bounding box, as K1's does (fused_common.cuh).
//
// Layout.  pool [n_phys, hb, cols] T is updated in place.  Particle i's
// window of wr rows starts at in-span row woff[i] of its kspan-band span;
// band b of the span is read from tile src[i, b] and written to tile
// dst[i, b] (dst == src where the tile is exclusively owned, a fresh tile
// where it is shared).  The host computes the plan (ops/tiles.py::tiled_plan)
// and the per-particle r0, woff and pp rows.
//
// Per CTA (particle i, 256 threads):
//   1. likelihood on the pre-update window read through the src tiles:
//      window row y is row (woff + y) % hb of tile src[(woff + y) / hb];
//   2. __syncthreads() (inside block_likelihood): every read of step 1 is
//      done before any write below; the same barrier reduces dmax, from
//      which every thread computes the box;
//   3. for each spanned band with dst != src (privatized), every 16-byte
//      word of the band outside the box goes from the src tile to the dst
//      tile; an owned band (dst == src) is not touched outside the box;
//   4. the box pass: read each box cell from its src tile, write it to its
//      dst tile.
// Steps 1, 2 and 4 are the device code of fused_common.cuh that K1 runs,
// so K3 is bitwise K1 on the materialized maps.
//
// Why in place is race-free (the module's own argument, tiles.py:46-53): a
// CTA writes only fresh tiles, which no table row references, or tiles it
// owns exclusively, for which it is the only reader.  No CTA reads what
// another writes, and tiled_plan hands out distinct fresh tiles.
//
// What bounds it on the H100, and what the design does about it: at
// config 3 (1,024 particles, hb = wr = 56, cols = 1,024, bf16) the box
// pass computes ~2.4 M cells (~45 x 52 a particle) instead of the
// window's 58.7 M, and every privatized band is a fresh tile written
// whole: after a resample that shares half the maps, ~355 MB of band
// copies, ~0.11 ms at 3.35 TB/s.  So bytes bound it.  The copies run two
// 16-byte loads in flight a thread, and the box pass of one CTA overlaps
// the copies of the others on its SM.  ptxas: 40 registers, 2,112 bytes
// of shared memory, no spills, so 6 CTAs a SM; capped at 32 registers
// (8 a SM, one wave of 1,024) it spilled and was no faster.  The work has
// no products, so tensor cores do not apply.

#include "fused_common.cuh"

namespace {

using namespace slamrs;

struct TiledArgs {
  void* pool;       // [n_phys, hb, cols] T, updated in place
  const int* src;   // [P, kspan] tiles read
  const int* dst;   // [P, kspan] tiles written
  const int* r0;    // [P] window row origin in the padded map
  const int* woff;  // [P] window row origin inside the span
  const float* pp;  // [P, 8]
  float* lik;       // [P]
  int hb, kspan;
  ScanConsts c;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_update_tiled_kernel(TiledArgs a) {
  const int i = blockIdx.x;
  const int hb = a.hb;
  const int cols = a.c.cols;
  const int woff = a.woff[i];
  const size_t tile = static_cast<size_t>(hb) * cols;
  const int* src = a.src + static_cast<size_t>(i) * a.kspan;
  const int* dst = a.dst + static_cast<size_t>(i) * a.kspan;
  T* pool = static_cast<T*>(a.pool);
  const Particle q = load_particle(a.pp + 8 * i, a.r0[i]);

  __shared__ float s_denc[kBeamPad];
  __shared__ float s_red[2 * kThreads / 32];
  const float dmax_part = stage_denc(a.c, s_denc);

  // 1. likelihood on the pre-update window, through the src tiles
  const float dmax = block_likelihood(
      a.c, q,
      [&](int wy, int wx) {
        const int s = woff + wy;
        const int b = s / hb;
        return load_cell(pool + static_cast<size_t>(src[b]) * tile +
                         static_cast<size_t>(s - b * hb) * cols + wx);
      },
      dmax_part, s_red, a.lik + i);

  // 2. the box; its columns are whole 16-byte words
  constexpr int kPerWord = 16 / sizeof(T);
  const Box box = cell_box(a.c, q, dmax, kPerWord);

  // 3. privatized bands: every word outside the box, src tile -> dst tile
  for (int b = 0; b < a.kspan; ++b) {
    const int ts = src[b], td = dst[b];
    if (ts == td) continue;
    const int lo = min(max(woff + box.y0 - b * hb, 0), hb);  // box rows of
    const int hi = min(max(woff + box.y1 - b * hb, 0), hb);  // band b
    copy_outside_box(
        reinterpret_cast<const uint4*>(pool + static_cast<size_t>(ts) * tile),
        reinterpret_cast<uint4*>(pool + static_cast<size_t>(td) * tile), hb,
        cols / kPerWord, lo, hi, box.x0 / kPerWord, box.x1 / kPerWord);
  }

  // 4. the box pass: read from src tiles, write to dst tiles
  box_pass(a.c, make_cell_pass(a.c, q), s_denc, box,
           [&](int wy, int wx, float inc) {
             const int s = woff + wy;
             const int b = s / hb;
             const size_t in_tile = static_cast<size_t>(s - b * hb) * cols + wx;
             const float v =
                 load_cell(pool + static_cast<size_t>(src[b]) * tile + in_tile);
             store_cell(pool + static_cast<size_t>(dst[b]) * tile + in_tile,
                        v + inc);
           });
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 when
// the launch was accepted).  Pointers are device pointers of contiguous
// tensors; the caller has validated shapes and dtypes.
extern "C" int slamrs_fused_update_tiled(void* pool, const void* src,
                                         const void* dst, const void* r0,
                                         const void* woff, const void* pp,
                                         const void* table, void* lik, int p,
                                         int hb, int kspan, int cols, int wr,
                                         int logical_rows, int logical_cols,
                                         int num_beams, int is_bf16,
                                         int static_bins, float inv_s,
                                         float nbf, float inv_nbf,
                                         void* stream) {
  TiledArgs a{pool,
              static_cast<const int*>(src),
              static_cast<const int*>(dst),
              static_cast<const int*>(r0),
              static_cast<const int*>(woff),
              static_cast<const float*>(pp),
              static_cast<float*>(lik),
              hb,
              kspan,
              ScanConsts{static_cast<const float*>(table), wr, cols,
                         logical_rows, logical_cols, num_beams, static_bins,
                         inv_s, nbf, inv_nbf}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    fused_update_tiled_kernel<__nv_bfloat16><<<p, kThreads, 0, s>>>(a);
  else
    fused_update_tiled_kernel<float><<<p, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
