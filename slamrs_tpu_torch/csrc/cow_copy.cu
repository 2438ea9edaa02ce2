// Copy-on-write resample copies for Hopper (sm_90a):
// grids[dst[j]] = grids[src[j]] for every j < *n_copies, in place.
//
// Replaces the Pallas TPU kernel slamrs_tpu/ops/cow.py::cow_copy (bodies
// _kernel_cow_staged and _kernel_cow).  It computes what the plain version
// slamrs_tpu_torch/ops/cow.py::cow_copy_reference computes.
//
// Layout: a 2-D grid (P, chunks).  Block (j, c) copies chunk c of map
// src[j] into map dst[j] with 16-byte uint4 loads and stores, and exits at
// once when j >= *n_copies, which it reads from device memory (the host
// never learns the count).  Every map is a whole number of uint4 because
// the column axis is padded to 128.
//
// Why it is race-free: sources are surviving slots and destinations are
// freed slots (ops/cow.py::cow_plan), so no block writes what another reads.
//
// What bounds it on the H100: bytes.  bench.py's config-3 plan copies 512
// maps of 2,048,000 bytes from 256 unique sources: 1.57 GB when each source
// is read once (~0.47 ms at 3.35 TB/s).  A source with several children is
// read by neighbouring blocks at nearly the same time, so the 50 MB L2
// serves the repeated reads; the TPU's VMEM staging of one source for all
// its copies (_kernel_cow_staged) has no counterpart here.  An identity plan
// (an N_eff skip) moves no bytes: one launch of blocks that exit at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    cow_copy_kernel(uint4* grids, const int* src, const int* dst,
                    const int* n_copies, size_t map_vec, size_t chunk_vec) {
  const int j = blockIdx.x;
  if (j >= *n_copies) return;
  const size_t begin = static_cast<size_t>(blockIdx.y) * chunk_vec;
  const size_t end = begin + chunk_vec < map_vec ? begin + chunk_vec : map_vec;
  const uint4* __restrict__ s = grids + static_cast<size_t>(src[j]) * map_vec;
  uint4* __restrict__ d = grids + static_cast<size_t>(dst[j]) * map_vec;
  for (size_t k = begin + threadIdx.x; k < end; k += kThreads) d[k] = s[k];
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 when
// the launch was accepted).  grids: p maps of map_bytes bytes each
// (a multiple of 16); src, dst: i32[p]; n_copies: one i32 on the device.
extern "C" int slamrs_cow_copy(void* grids, const void* src, const void* dst,
                               const void* n_copies, int p,
                               long long map_bytes, void* stream) {
  const size_t map_vec = static_cast<size_t>(map_bytes) / 16;
  // 64 KB per block, more where a map needs over 65,535 chunks
  size_t chunk_vec = 4096;
  if (map_vec / chunk_vec >= 65535) chunk_vec = map_vec / 65535 + 1;
  const unsigned chunks = static_cast<unsigned>((map_vec + chunk_vec - 1) / chunk_vec);
  if (p > 0 && chunks > 0) {
    cow_copy_kernel<<<dim3(p, chunks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint4*>(grids), static_cast<const int*>(src),
        static_cast<const int*>(dst), static_cast<const int*>(n_copies),
        map_vec, chunk_vec);
  }
  return static_cast<int>(cudaGetLastError());
}
