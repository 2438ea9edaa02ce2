// One frame of the simulator, for Hopper (sm_90a): for every world w, the
// frame's ticks of exact differential-drive motion and, on a tick that
// scans, the 360-beam lidar scan from the new pose against the scene's
// line segments.
//
// Replaces no Pallas kernel: on the TPU this is the XLA body of
// slamrs_tpu/graph/compile.py::FusedWorld.rollout_cadence's idle ticks and
// step's motion and lidar (slamrs_tpu/core/motion.py::integrate_exact,
// slamrs_tpu/models/simulator.py::lidar_scan, slamrs_tpu/ops/raycast.py).
// In PyTorch that body is ~139 small ATen kernels a 5 Hz frame (twelve a
// tick of motion and two of the wheel-travel sums, ~52 for the lidar: the
// cos, sin, the [B, S] intersection's elementwise steps, the min, the
// masks); here it is one launch.  It computes what the plain version
// slamrs_tpu_torch/models/simulator.py::sim_frame_reference computes, in
// float32, one rounding per ATen operation as the card's elementwise
// kernels round them (every operation below is an explicitly rounded
// intrinsic, so nothing is contracted into an fma), so the same bits:
//
//   motion, per tick i of n (the travel and the turn-then-advance of
//   core/motion.py::integrate_exact):
//     sl = speed_left[i] * dt,  sr = speed_right[i] * dt
//     theta += (sr - sl) * (1 / wheel_base)    the card's division of a
//            tensor by a host scalar multiplies by the float reciprocal
//            (ATen's div_true_kernel_cuda); the wrapper passes 1 / wheel_base
//            rounded once to float32, as ATen computes it
//     x += ((sr + sl) * 0.5) * cosf(theta),  y += (...) * sinf(theta)
//     accum_left += sl,  accum_right += sr
//   lidar, per beam b (ops/raycast.py::segment_intersect, raycast and
//   simulator.lidar_scan):
//     rel = float(b) * float(pi / 180)         torch.deg2rad's product
//     a = theta + rel,  (dx, dy) = (cosf(a), sinf(a))
//     per segment (x1, y1, x2, y2):
//       denom = (x1 - x2) (-dy) - (y1 - y2) (-dx)
//       t = ((x1 - x) (-dy) - (y1 - y) (-dx)) / denom
//       u = -((x1 - x2) (y1 - y) - (y1 - y2) (x1 - x)) / denom
//       u counts where denom != 0, 0 <= t <= 1, u > 0 and the segment is real,
//       else NO_HIT = 1e30
//     dist = the min over the segments,  hit = dist < NO_HIT
//     valid = hit and dist < range
//     distance = valid ? dist : (hit ? range : 0)
//     strength = hit ? 1 : 0,  present = hit
//
// Inputs.  The pose f32[W, 3] and the accumulators f32[W] as they stand
// before the frame; the frame's wheel speeds, shared by every world, read
// at speed_left[i * stride_left] and speed_right[i * stride_right] (a
// column slice of the rollout's command table, or one tick's 0-dim
// command); the segments f32[S, 4] and their mask.  Outputs: the pose and
// the accumulators after the last tick; with distances != nullptr the scan
// (f32 distances and strengths, bool valid and present, [W, B]) and the
// beam table angles f32[B] (written by CTA 0).  The accumulators written
// are the odometry reading of a scan tick; the caller zeroes the state's.
//
// Layout.  One CTA a world, kThreads threads.  Thread 0 runs the ticks,
// which depend one on the next, and publishes the pose through shared
// memory; then each thread casts beams b = tid, tid + kThreads, ... over
// the S segments (13 in every configuration of the benchmark), read
// through the L1 cache, where every thread of a warp reads the same
// address.  No atomics, so a call gives the same bits every time, eager
// or replayed.
//
// What bounds it on the H100.  Latency: one world's frame is a chain of
// ~6 ticks of a cosf and a sinf each on one thread, then ~13 x 20 float32
// operations, two divisions among them, and a cosf and a sinf per beam;
// it reads ~300 B and writes ~3.6 KB a world.  The design keeps a frame to
// one launch (the plain version's ~139), and a fleet to one launch with a
// CTA a world.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 384;  // 360 beams in one pass
constexpr float kNoHit = 1e30f;
// torch.deg2rad multiplies by the double pi / 180 cast to float32
constexpr float kDegToRad =
    static_cast<float>(0.017453292519943295769236907684886127134428718885417);

__global__ void __launch_bounds__(kThreads)
sim_frame_kernel(const float* __restrict__ pose_in,
                 const float* __restrict__ accum_left_in,
                 const float* __restrict__ accum_right_in,
                 const float* __restrict__ speed_left,
                 const float* __restrict__ speed_right,
                 long long stride_left, long long stride_right, int n_ticks,
                 float dt, float inv_wheel_base,
                 const float4* __restrict__ segments,
                 const unsigned char* __restrict__ segment_mask,
                 int n_segments, float scanner_range, int num_beams,
                 float* __restrict__ pose_out,
                 float* __restrict__ accum_left_out,
                 float* __restrict__ accum_right_out,
                 float* __restrict__ angles, float* __restrict__ distances,
                 float* __restrict__ strengths,
                 unsigned char* __restrict__ valid,
                 unsigned char* __restrict__ present) {
  __shared__ float pose[3];
  const int w = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid == 0) {
    float x = pose_in[3 * w], y = pose_in[3 * w + 1],
          th = pose_in[3 * w + 2];
    float al = accum_left_in[w], ar = accum_right_in[w];
    for (int i = 0; i < n_ticks; ++i) {
      const float sl = __fmul_rn(speed_left[i * stride_left], dt);
      const float sr = __fmul_rn(speed_right[i * stride_right], dt);
      const float sbar = __fmul_rn(__fadd_rn(sr, sl), 0.5f);
      th = __fadd_rn(th, __fmul_rn(__fsub_rn(sr, sl), inv_wheel_base));
      x = __fadd_rn(x, __fmul_rn(sbar, cosf(th)));
      y = __fadd_rn(y, __fmul_rn(sbar, sinf(th)));
      al = __fadd_rn(al, sl);
      ar = __fadd_rn(ar, sr);
    }
    pose_out[3 * w] = x;
    pose_out[3 * w + 1] = y;
    pose_out[3 * w + 2] = th;
    accum_left_out[w] = al;
    accum_right_out[w] = ar;
    pose[0] = x;
    pose[1] = y;
    pose[2] = th;
  }
  if (distances == nullptr) return;  // motion only
  __syncthreads();
  const float x = pose[0], y = pose[1], th = pose[2];
  const size_t row = static_cast<size_t>(w) * num_beams;
  for (int b = tid; b < num_beams; b += kThreads) {
    const float rel = __fmul_rn(static_cast<float>(b), kDegToRad);
    const float a = __fadd_rn(th, rel);
    const float ndx = -cosf(a), ndy = -sinf(a);
    float dist = kNoHit;
    for (int s = 0; s < n_segments; ++s) {
      const float4 g = segments[s];  // x1, y1, x2, y2
      const float ax = __fsub_rn(g.x, g.z), ay = __fsub_rn(g.y, g.w);
      const float ox = __fsub_rn(g.x, x), oy = __fsub_rn(g.y, y);
      const float denom = __fsub_rn(__fmul_rn(ax, ndy), __fmul_rn(ay, ndx));
      const float safe = denom == 0.0f ? 1.0f : denom;
      const float t = __fdiv_rn(
          __fsub_rn(__fmul_rn(ox, ndy), __fmul_rn(oy, ndx)), safe);
      const float u = __fdiv_rn(
          -__fsub_rn(__fmul_rn(ax, oy), __fmul_rn(ay, ox)), safe);
      const bool ok = denom != 0.0f && t >= 0.0f && t <= 1.0f && u > 0.0f &&
                      segment_mask[s];
      dist = fminf(dist, ok ? u : kNoHit);
    }
    const bool hit = dist < kNoHit;
    const bool in_range = hit && dist < scanner_range;
    distances[row + b] = in_range ? dist : (hit ? scanner_range : 0.0f);
    strengths[row + b] = hit ? 1.0f : 0.0f;
    valid[row + b] = in_range;
    present[row + b] = hit;
    if (w == 0) angles[b] = rel;
  }
}

}  // namespace

extern "C" int slamrs_sim_frame(
    const void* pose_in, const void* accum_left_in,
    const void* accum_right_in, const void* speed_left,
    const void* speed_right, long long stride_left, long long stride_right,
    int n_ticks, float dt, float inv_wheel_base, const void* segments,
    const void* segment_mask, int n_segments, float scanner_range,
    int num_beams, void* pose_out, void* accum_left_out,
    void* accum_right_out, void* angles, void* distances, void* strengths,
    void* valid, void* present, int worlds, void* stream) {
  if (worlds <= 0) return static_cast<int>(cudaGetLastError());
  if (n_ticks < 0 || n_segments < 0 ||
      (distances != nullptr &&
       (num_beams <= 0 || angles == nullptr || strengths == nullptr ||
        valid == nullptr || present == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // a frame without a scan needs only thread 0 of each CTA
  const int threads = distances != nullptr ? kThreads : 32;
  sim_frame_kernel<<<worlds, threads, 0, st>>>(
      static_cast<const float*>(pose_in),
      static_cast<const float*>(accum_left_in),
      static_cast<const float*>(accum_right_in),
      static_cast<const float*>(speed_left),
      static_cast<const float*>(speed_right), stride_left, stride_right,
      n_ticks, dt, inv_wheel_base, static_cast<const float4*>(segments),
      static_cast<const unsigned char*>(segment_mask), n_segments,
      scanner_range, num_beams, static_cast<float*>(pose_out),
      static_cast<float*>(accum_left_out),
      static_cast<float*>(accum_right_out), static_cast<float*>(angles),
      static_cast<float*>(distances), static_cast<float*>(strengths),
      static_cast<unsigned char*>(valid),
      static_cast<unsigned char*>(present));
  return static_cast<int>(cudaGetLastError());
}
