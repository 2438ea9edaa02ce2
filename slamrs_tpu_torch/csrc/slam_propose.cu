// The proposal of one grid SLAM update, for Hopper (sm_90a): for every
// particle, the pose sampled from the odometry model, the motion
// log-probability of that transition, and the inputs K1 and K3 take at
// the sampled pose; and the scan's beam table.
//
// Replaces no Pallas kernel: on the TPU this is the XLA body of
// slamrs_tpu/models/gridslam.py::update before the fused kernel
// (core/motion.py::sample and ::log_prob, and ops/fused.py's preparation
// of the kernel's inputs).  In PyTorch that body is ~118 small ATen
// kernels an update (motion.sample 12, log_prob 28 with normal_logpdf
// and angle_diff, the odometry deltas and stds twice, 44; the beam
// spacing 1; ops/fused.py::prepare 18, encode_beam_table 28,
// quantize_d_enc 10); here it is one launch.  It computes what the plain
// version slamrs_tpu_torch/ops/propose.py::slam_propose_reference
// computes, in float32, one rounding per ATen operation as the card's
// elementwise kernels round them (every operation below is an explicitly
// rounded intrinsic, so nothing is contracted into an fma), so the same
// bits:
//
//   odometry (core/motion.py::deltas, ::stds), from the 0-dim readings:
//     dc = (l + r) * 0.5
//     dt = (r - l) * (1 / wheel_base)    the card's division of a tensor
//          by a host scalar multiplies by the float reciprocal (ATen's
//          div_true_kernel_cuda); a wheel base on the card divides
//     c_std = (|dc| * 0.05 + 0.01) * 0.5,  t_std = 0.1 |dt| + radians(5)
//   sample, per particle (eps_c, eps_t injected):
//     center = dc + c_std eps_c,  th = (th0 + dt) + t_std eps_t
//     x = x0 + cosf(th) center,  y = y0 + sinf(th) center
//   log_prob (core/math.py::angle_diff, ::normal_logpdf):
//     cd = sqrtf((x0 - x)^2 + (y0 - y)^2)       ** 2 is x * x
//     ad = remainder(th - th0 + pi, 2 pi) - pi, + 2 pi below -pi, where
//          remainder is ATen's: fmodf, then + 2 pi where the signs differ
//     z = (v - mean) / std,  logpdf = ((z * -0.5) * z - logf(std)) - c
//     log_motion = logpdf(cd, dc, c_std) + logpdf(ad, dt, t_std)
//   prepare (ops/fused.py::prepare), at the sampled pose:
//     cx = (x - position_x) * (1 / resolution), cy likewise
//     r0 = floor8(clamp(int(rintf(cy)) - wr / 2, 0, max(rows - wr, 0)))
//     ta = th + a0, in bin units (ta * float(1 / spacing)) - 0.5 where the
//          spacing is static
//     pp = (cx, cy, th, ta, cosf(th), sinf(th), dphi, (1 / dphi) * 1)
//          with dphi = a1 - a0 (the scan's angle step) or the constant
//   the beam table (ops/fused.py::encode_beam_table, ::quantize_d_enc),
//   per lane b of 512:
//     d = |dist * (1 / resolution)|; row 0 +d valid, -d present and
//     invalid, -0.0 absent or padding, 1e-6 for a valid beam at 0; then,
//     for at most 381 beams, |d| snapped to qu (rintf of |d| * (1 / qu),
//     clamped to [1, 511] with NaN kept, times qu), sign and +-0 kept;
//     rows 1-4 where the beam is valid and present: d, cosf and sinf of
//     a0 + b * dphi, 1; else 0; rows 5-7 zero.
//
// Inputs.  The poses f32[P, 3] before the update, the draws f32[P], the
// odometry's two readings and, where it is a tensor, its wheel base (one
// float each, on the card), the scan's first two angles (the second only
// where the spacing comes from them) and its lanes (f32 distances, bool
// valid and present, [B]).  Host scalars (the model's constants, the
// grid's geometry, the window) come in a SlamProposeParams, passed by
// value to the kernel.  Outputs: the sampled poses f32[P, 3], log_motion
// f32[P], pp f32[P, 8], r0 i32[P] and the table f32[8, 512].
//
// Layout.  ceil(max(P, 512) / 256) CTAs of 256 threads; thread i samples
// particle i and writes lane i of the table.  Every thread recomputes the
// few odometry scalars (two logf among them).  No shared memory, no
// atomics, so a call gives the same bits every time, eager or replayed.
//
// What bounds it on the H100.  Latency: it reads ~20 B and writes ~56 B a
// particle and 32 B a lane (~74 KB at 1,024 particles), with ~60 float32
// operations a particle; the design keeps the proposal to one launch
// (the plain chain's ~118).

#include <cuda_runtime.h>
#include <math.h>

// Host scalars of one call; the layout is ops/propose.py::_Params'.
struct SlamProposeParams {
  int particles;
  int num_beams;
  int rows;         // rows the window is clamped to
  int wr;           // window rows
  int quantize;     // 1: row 0 snapped to qu (at most 381 beams)
  int static_bins;  // 1: the spacing is static, ta in bin units
  float inv_wheel_base;  // float32 1 / wheel base (a host wheel base)
  float min_center_std, center_std_rate, theta_std_base, theta_std_rate;
  float log_sqrt_2pi, pi, two_pi;
  float position_x, position_y, inv_resolution;
  float dphi;      // the spacing where no second angle is read
  float inv_binu;  // float32 of the double 1 / spacing (static spacing)
  float qu, inv_qu;
};

namespace {

constexpr int kThreads = 256;
constexpr int kBeamPad = 512;  // ops/fused.py::BEAM_PAD
// torch.full_like(d, 1e-6): the double cast to float32
constexpr float kZeroBeam = static_cast<float>(1e-6);

// core/math.py::angle_diff(alpha, beta), torch.remainder as ATen's
__device__ __forceinline__ float angle_diff(float alpha, float beta,
                                            const SlamProposeParams& p) {
  const float v = __fadd_rn(__fsub_rn(beta, alpha), p.pi);
  float mod = fmodf(v, p.two_pi);
  if (mod != 0.0f && ((p.two_pi < 0.0f) != (mod < 0.0f)))
    mod = __fadd_rn(mod, p.two_pi);
  const float diff = __fsub_rn(mod, p.pi);
  return diff < -p.pi ? __fadd_rn(diff, p.two_pi) : diff;
}

// core/math.py::normal_logpdf, log(std) given
__device__ __forceinline__ float normal_logpdf(float x, float mean,
                                               float std, float log_std,
                                               float c) {
  const float z = __fdiv_rn(__fsub_rn(x, mean), std);
  return __fsub_rn(__fsub_rn(__fmul_rn(__fmul_rn(z, -0.5f), z), log_std),
                   c);
}

__global__ void __launch_bounds__(kThreads)
slam_propose_kernel(const float* __restrict__ pose_in,
                    const float* __restrict__ eps_c,
                    const float* __restrict__ eps_t,
                    const float* __restrict__ dist_left,
                    const float* __restrict__ dist_right,
                    const float* __restrict__ wheel_base,
                    const float* __restrict__ angle0,
                    const float* __restrict__ angle1,
                    const float* __restrict__ distances,
                    const unsigned char* __restrict__ valid,
                    const unsigned char* __restrict__ present,
                    const SlamProposeParams p, float* __restrict__ pose_out,
                    float* __restrict__ log_motion, float* __restrict__ pp,
                    int* __restrict__ r0, float* __restrict__ table) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float a0 = *angle0;
  const float dphi = angle1 != nullptr ? __fsub_rn(*angle1, a0) : p.dphi;
  if (i < p.particles) {
    const float dl = *dist_left, dr = *dist_right;
    const float dc = __fmul_rn(__fadd_rn(dl, dr), 0.5f);
    const float turn = __fsub_rn(dr, dl);
    const float dt = wheel_base != nullptr
                         ? __fdiv_rn(turn, *wheel_base)
                         : __fmul_rn(turn, p.inv_wheel_base);
    const float c_std = __fmul_rn(
        __fadd_rn(__fmul_rn(fabsf(dc), p.center_std_rate),
                  p.min_center_std),
        0.5f);
    const float t_std =
        __fadd_rn(__fmul_rn(fabsf(dt), p.theta_std_rate), p.theta_std_base);

    const float x0 = pose_in[3 * i], y0 = pose_in[3 * i + 1],
                th0 = pose_in[3 * i + 2];
    const float center = __fadd_rn(dc, __fmul_rn(c_std, eps_c[i]));
    const float th = __fadd_rn(__fadd_rn(th0, dt), __fmul_rn(t_std, eps_t[i]));
    const float c = cosf(th), s = sinf(th);
    const float x = __fadd_rn(x0, __fmul_rn(c, center));
    const float y = __fadd_rn(y0, __fmul_rn(s, center));
    pose_out[3 * i] = x;
    pose_out[3 * i + 1] = y;
    pose_out[3 * i + 2] = th;

    const float ex = __fsub_rn(x0, x), ey = __fsub_rn(y0, y);
    const float cd = __fsqrt_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)));
    log_motion[i] = __fadd_rn(
        normal_logpdf(cd, dc, c_std, logf(c_std), p.log_sqrt_2pi),
        normal_logpdf(angle_diff(th0, th, p), dt, t_std, logf(t_std),
                      p.log_sqrt_2pi));

    const float cx = __fmul_rn(__fsub_rn(x, p.position_x), p.inv_resolution);
    const float cy = __fmul_rn(__fsub_rn(y, p.position_y), p.inv_resolution);
    // int32 arithmetic wraps as ATen's does on a saturated conversion
    int row = static_cast<int>(static_cast<unsigned>(static_cast<int>(
                                   rintf(cy))) -
                               static_cast<unsigned>(p.wr / 2));
    row = min(max(row, 0), max(p.rows - p.wr, 0));
    r0[i] = row / 8 * 8;  // row >= 0: the floor division
    float ta = __fadd_rn(th, a0);
    if (p.static_bins) ta = __fsub_rn(__fmul_rn(ta, p.inv_binu), 0.5f);
    float4* out = reinterpret_cast<float4*>(pp + 8 * i);
    out[0] = make_float4(cx, cy, th, ta);
    out[1] = make_float4(c, s, dphi, __fmul_rn(__fdiv_rn(1.0f, dphi), 1.0f));
  }
  if (i < kBeamPad) {
    float enc = -0.0f, d_lik = 0.0f, ca = 0.0f, sa = 0.0f, use = 0.0f;
    if (i < p.num_beams) {
      const float d = fabsf(__fmul_rn(distances[i], p.inv_resolution));
      const bool v = valid[i] != 0, pr = present[i] != 0;
      enc = pr ? (v ? d : -d) : -0.0f;
      if (v && pr) {
        if (d == 0.0f) enc = kZeroBeam;
        const float ang = __fadd_rn(a0, __fmul_rn(static_cast<float>(i), dphi));
        d_lik = d;
        ca = cosf(ang);
        sa = sinf(ang);
        use = 1.0f;
      }
    }
    if (p.quantize && enc != 0.0f) {  // +-0 stays; NaN goes through
      float q = rintf(__fmul_rn(fabsf(enc), p.inv_qu));
      if (!isnan(q)) q = fminf(fmaxf(q, 1.0f), 511.0f);
      const float dq = __fmul_rn(q, p.qu);
      enc = enc > 0.0f ? dq : -dq;
    }
    table[i] = enc;
    table[kBeamPad + i] = d_lik;
    table[2 * kBeamPad + i] = ca;
    table[3 * kBeamPad + i] = sa;
    table[4 * kBeamPad + i] = use;
    table[5 * kBeamPad + i] = 0.0f;
    table[6 * kBeamPad + i] = 0.0f;
    table[7 * kBeamPad + i] = 0.0f;
  }
}

}  // namespace

extern "C" int slamrs_slam_propose(
    const void* pose_in, const void* eps_c, const void* eps_t,
    const void* dist_left, const void* dist_right, const void* wheel_base,
    const void* angle0, const void* angle1, const void* distances,
    const void* valid, const void* present, const SlamProposeParams* params,
    void* pose_out, void* log_motion, void* pp, void* r0, void* table,
    void* stream) {
  if (params == nullptr || params->particles <= 0 ||
      params->num_beams < 1 || params->num_beams > kBeamPad ||
      params->wr < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = params->particles > kBeamPad ? params->particles : kBeamPad;
  slam_propose_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const float*>(pose_in), static_cast<const float*>(eps_c),
      static_cast<const float*>(eps_t), static_cast<const float*>(dist_left),
      static_cast<const float*>(dist_right),
      static_cast<const float*>(wheel_base),
      static_cast<const float*>(angle0), static_cast<const float*>(angle1),
      static_cast<const float*>(distances),
      static_cast<const unsigned char*>(valid),
      static_cast<const unsigned char*>(present), *params,
      static_cast<float*>(pose_out), static_cast<float*>(log_motion),
      static_cast<float*>(pp), static_cast<int*>(r0),
      static_cast<float*>(table));
  return static_cast<int>(cudaGetLastError());
}
