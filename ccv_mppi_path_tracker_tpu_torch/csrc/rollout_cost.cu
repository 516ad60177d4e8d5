// Fused sample + rollout + cost + softmax-weighted update of one MPPI
// control step, written for Hopper (sm_90a).
//
// Replaces fused_sample_rollout_cost / _make_kernel in
// ccv_mppi_path_tracker_tpu/kernels/rollout_cost.py (the Pallas TPU kernel):
// its four model branches (unicycle, steering_unicycle,
// rate_limited_steering, full_body), noise-input and in-kernel RNG modes, any
// K, the three passes of elite sampling: costs only (accumulate = 0), costs
// in (the costs-free second pass) and the cost threshold (scal slot 17) that
// zeroes the weight of every sample above it; the second moment (the sums of
// w*u^2 that adaptive sigma reads); and the fleet grid (B robots in one
// launch).
//
// What bounds it on this card: FP32 and special-function work, not bytes.
// Per sample and step the tracking models evaluate one sincos, the full-body
// model three sincos and one cos (ZMP direction, roll, heading; pitch), and
// the min-distance scan costs about 3*T FMA/min operations; the kernel reads
// at most the injected noise (and, in the costs-in pass, one cost) per
// sample and writes one float per sample. wgmma and TMA have no role here:
// there is no matrix product and no tile to stage.
//
// Design, simple and correct in this version:
// - One thread per sample, kThreads per block. The model is a template
//   parameter: U and S are compile-time, one instantiation per model, and the
//   per-model rollout + cost body is chosen at compile time. The thread holds
//   the state, the running cost and the current control row in registers
//   (full_body also the next row: the ZMP finite differences read v and
//   roll_v at t+1), and the colored-noise carry eps_prev[j].
// - The centered reference constants [2(r-c), |r-c|^2] and u_prev sit in
//   shared memory; every thread of a warp reads the same word (broadcast).
// - Blocks run in parallel and in no order, so nothing is carried between
//   them (the TPU kernel carries a running minimum across its sequential
//   grid). Each block takes the minimum m_b of its valid costs, weighs its
//   samples by w = exp(-(cost - m_b)/lambda), zero above the threshold, and
//   writes m_b, sum w and the (T-1)*U sums of w*u[t,j] to its row of a
//   partials buffer. The wrapper rescales each row by exp(-(m_b - m)/lambda)
//   with m the global minimum and sums the rows: the same exact algebra as
//   the sharded JAX path. m_b is over all valid costs, not the elites only,
//   so a block without elites writes zero sums under a finite m_b.
// - Second moment: a second template flag. When set, the row grows by the
//   (T-1)*U sums of (w*u[t,j])*u[t,j] after the first-moment sums, and the
//   wrapper rescales them with the same block factors. When clear, the
//   kernel is the first-moment kernel with no added work or registers.
// - Fleet grid: gridDim.y = B robots, gridDim.x = the K blocks of one robot.
//   blockIdx.y offsets every per-robot operand (u_prev, the centered
//   reference rows, the centered start state, the scalars, the noise, the
//   costs in and out, the partials); sigma and the box are shared. Each
//   robot's baseline is the minimum over its own blocks only: the wrapper
//   reduces the partials per robot.
// - The update needs u[t,j] after the cost is known. It is regenerated, not
//   stored: noise-input mode re-reads the noise, RNG mode re-draws the same
//   Philox numbers. The costs-in pass regenerates the controls of the pass
//   that computed the costs in the same way, and skips the rollout.
// - Block sums are deterministic: a warp shuffle reduction, one shared
//   memory slot per (warp, sum), then a fixed-order sum over the warps. The
//   same inputs give bit-identical outputs on every run.
// - Padded samples (index >= num_samples, compared as integers) neither
//   enter the block minimum nor get weight.
// - RNG mode: Philox4x32-10 keyed by (seed, step) at counter (k, t, pair, b)
//   with b the robot (0 for one robot); Box-Muller over the top 23 bits of
//   words 0 and 1 gives the normals of controls 2*pair (cosine) and
//   2*pair+1 (sine). (U+1)/2 pairs per row: for U = 3 the fourth normal is
//   drawn and dropped. Every normal is a pure function of (seed, step, b, k,
//   t, j), independent of the block size and of B; robot 0 of a fleet draws
//   the single-robot stream. A launch may start at another robot index
//   (first_robot), so robot b of a fleet is one launch of its own too.
// - rate_limited_steering's steer and rate limits come in as two arguments
//   from the registered model's constants, not as compile-time constants, so
//   a re-registered variant needs no rebuild.
// - Precise logf/expf/sinf/cosf: no fast-math in this version. Block size,
//   occupancy and fast-math are for later tuning.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (kernels/build.py), bound with ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kCap2 = 100.0f * 100.0f;  // DIST_CAP^2 (ops/mindist.py)
constexpr float kTwoPi = 6.28318548f;   // 2*pi rounded to float32
constexpr float kInv2p23 = 1.0f / 8388608.0f;
constexpr unsigned kFull = 0xffffffffu;

// Slots of the scalar vector (kernels/rollout_cost.py pack_scalars).
enum Scal {
  kDt, kVRef, kPathW, kVW, kZmpW, kRollVW, kBackW, kYawW, kYawRef0,
  kMass, kBase2Com, kIxx, kIyy, kIzz, kGz, kBeta, kLam, kThresh, kNScal
};

// Model ids, in the order of kernels/rollout_cost.py KERNEL_MODELS.
enum ModelId { kUnicycle, kSteering, kRateLimited, kFullBody, kNumModels };

template <int M> struct Dims;
template <> struct Dims<kUnicycle> { static constexpr int U = 2, S = 3; };
template <> struct Dims<kSteering> { static constexpr int U = 3, S = 3; };
template <> struct Dims<kRateLimited> { static constexpr int U = 3, S = 4; };
template <> struct Dims<kFullBody> { static constexpr int U = 5, S = 5; };

__device__ __forceinline__ void philox4x32_10(uint32_t& c0, uint32_t& c1,
                                              uint32_t& c2, uint32_t& c3,
                                              uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
}

// Draws the control rows of one sample in time order, u[t, j] =
// clamp(u_prev[t, j] + sigma[j] * eps[t, j]), with eps the (optionally
// colored) standard normals: eps_t = beta*eps_{t-1} + sqrt(1-beta^2)*eta_t.
// Row 0 restarts the recurrence, so one sampler serves both passes over t.
template <int U>
struct RowSampler {
  static constexpr int kPairs = (U + 1) / 2;  // Box-Muller pairs per row
  const float* noise;   // (T-1, U, K) standard normals, or nullptr (RNG mode)
  const float* uprev;   // shared (T-1, U)
  float sigma[U], umin[U], umax[U];
  float beta, bscale;
  int num_samples, k;
  bool valid, steer_off;
  uint32_t seed, step, robot;
  float eps[U];

  __device__ __forceinline__ void row(int t, float u[U]) {
    float eta[2 * kPairs];
    if (noise != nullptr) {
#pragma unroll
      for (int j = 0; j < U; ++j) {
        eta[j] = valid ? noise[((size_t)t * U + j) * num_samples + k] : 0.0f;
      }
    } else {
#pragma unroll
      for (int p = 0; p < kPairs; ++p) {
        uint32_t c0 = (uint32_t)k, c1 = (uint32_t)t, c2 = (uint32_t)p, c3 = robot;
        philox4x32_10(c0, c1, c2, c3, seed, step);
        const float u1 = (float)(c0 >> 9) * kInv2p23;
        const float u2 = (float)(c1 >> 9) * kInv2p23;
        const float r = sqrtf(-2.0f * log1pf(-u1));
        const float theta = kTwoPi * u2;
        eta[2 * p] = r * cosf(theta);
        eta[2 * p + 1] = r * sinf(theta);
      }
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const float e = (t == 0) ? eta[j] : beta * eps[j] + bscale * eta[j];
      eps[j] = e;
      float val = uprev[t * U + j] + sigma[j] * e;
      val = fminf(fmaxf(val, umin[j]), umax[j]);
      // channel 2 (direction, steer or steer rate) of any model with U > 2
      if (steer_off && j == 2) val = 0.0f;
      u[j] = val;
    }
  }
};

// clamp(min_j |p - ref_j|^2, 0, cap^2) in the centered expanded form
// (ops/mindist.py): ref rows are [2(r_j-c), |r_j-c|^2], p is centered.
__device__ __forceinline__ float path_d2(float x, float y, const float* ref,
                                         int num_ref) {
  const float pn = x * x + y * y;
  float m = INFINITY;
  for (int j = 0; j < num_ref; ++j) {
    m = fminf(m, ref[3 * j + 2] - x * ref[3 * j] - y * ref[3 * j + 1]);
  }
  return fminf(fmaxf(pn + m, 0.0f), kCap2);
}

// Rollout + cost of one sample, unicycle / steering / rate-limited models
// (ops/costs.py tracking_cost): path term over all T states, velocity term
// over the T-1 controls. Heading is yaw (unicycle), yaw plus the steer
// control (steering), or yaw plus the steer state before this step's slew
// (rate-limited: then rate = clip(u2), steer = clip(steer + rate*dt)).
template <int M>
__device__ __forceinline__ float tracking_cost(RowSampler<Dims<M>::U>& smp,
                                               const float* s0, const float* scal,
                                               const float* ref, int num_ref,
                                               int tm1, float steer_max,
                                               float rate_max) {
  constexpr int U = Dims<M>::U;
  const float dt = scal[kDt], v_ref = scal[kVRef];
  const float path_w = scal[kPathW], v_w = scal[kVW];
  float x = s0[0], y = s0[1], yaw = s0[2];
  float steer = 0.0f;
  if constexpr (M == kRateLimited) steer = s0[3];
  float cost = 0.0f;
  float u[U];
  for (int t = 0; t < tm1; ++t) {
    smp.row(t, u);
    cost += path_w * path_d2(x, y, ref, num_ref);
    const float v = u[0], w = u[1];
    const float dv = v - v_ref;
    cost += v_w * dv * dv;
    float heading = yaw;
    if constexpr (M == kSteering) heading = yaw + u[2];
    if constexpr (M == kRateLimited) heading = yaw + steer;
    float sh, ch;
    sincosf(heading, &sh, &ch);
    x = x + v * ch * dt;
    y = y + v * sh * dt;
    yaw = yaw + w * dt;
    if constexpr (M == kRateLimited) {
      const float rate = fminf(fmaxf(u[2], -rate_max), rate_max);
      steer = fminf(fmaxf(steer + rate * dt, -steer_max), steer_max);
    }
  }
  return cost + path_w * path_d2(x, y, ref, num_ref);  // final state's term
}

// Rollout + cost of one sample, full-body model (ops/costs.py
// full_body_cost): every term over t in [0, T-3], plus the initial-yaw term.
__device__ __forceinline__ float full_body_cost(RowSampler<5>& smp,
                                                const float* s0,
                                                const float* scal,
                                                const float* ref, int num_ref,
                                                int horizon) {
  const float dt = scal[kDt], v_ref = scal[kVRef];
  const float path_w = scal[kPathW], v_w = scal[kVW], zmp_w = scal[kZmpW];
  const float rollv_w = scal[kRollVW], back_w = scal[kBackW];
  const float mass = scal[kMass], c = scal[kBase2Com], ixx = scal[kIxx];
  float x = s0[0], y = s0[1], yaw = s0[2];
  float roll = s0[3], pitch = s0[4];
  const float dyaw0 = yaw - scal[kYawRef0];
  float cost = scal[kYawW] * dyaw0 * dyaw0;
  // reciprocals hoisted out of the loop, as in the TPU kernel
  const float rdt = 1.0f / dt;
  const float bz = mass * scal[kGz];
  const float rbz = 1.0f / bz;

  float cur[5], nxt[5];
  smp.row(0, cur);
  for (int t = 0; t < horizon - 2; ++t) {
    smp.row(t + 1, nxt);
    cost += path_w * path_d2(x, y, ref, num_ref);
    const float v = cur[0], w = cur[1], dir = cur[2], rv = cur[3], pv = cur[4];
    const float dv = v - v_ref;
    cost += v_w * dv * dv;
    const float droll = nxt[3] - rv;
    cost += rollv_w * droll * droll;
    cost += back_w * (v < 0.0f ? v * v : 0.0f);
    // ZMP-y (models/full_body.py zmp_chain; only M_O_x is needed)
    const float da = (nxt[0] - v) * rdt;
    const float ac = v * w;
    float sd, cd;
    sincosf(dir, &sd, &cd);
    const float ay = da * sd + ac * cd;
    const float hgx = ixx * droll * rdt;
    float sr, cr;
    sincosf(roll, &sr, &cr);
    const float com_y = -c * sr;
    const float com_z = c * cosf(pitch) * cr;
    const float by = -mass * ay;
    const float mo_x = com_y * bz - com_z * by - hgx;
    const float zmp_y = mo_x * rbz;
    cost += zmp_w * zmp_y * zmp_y;
    // Euler step; the states at T-2 and T-1 are never read by the cost
    float sh, ch;
    sincosf(yaw + dir, &sh, &ch);
    x = x + v * ch * dt;
    y = y + v * sh * dt;
    yaw = yaw + w * dt;
    roll = roll + rv * dt;
    pitch = pitch + pv * dt;
#pragma unroll
    for (int j = 0; j < 5; ++j) cur[j] = nxt[j];
  }
  return cost;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// costs_in != nullptr: the costs-free elite pass (no rollout, no cost
// output). accumulate == 0: the costs-only pass (no update, no partials).
// M2: also the second-moment sums. Grid (ceil(K / kThreads), B).
template <int M, bool M2>
__global__ void __launch_bounds__(kThreads)
rollout_cost_kernel(const float* __restrict__ u_prev,
                    const float* __restrict__ sigma,
                    const float* __restrict__ u_min,
                    const float* __restrict__ u_max,
                    const float* __restrict__ refc,
                    const float* __restrict__ state0,
                    const float* __restrict__ scal,
                    const float* __restrict__ noise,
                    const float* __restrict__ costs_in,
                    float* __restrict__ costs,
                    float* __restrict__ partials,
                    int num_samples, int horizon, int num_ref,
                    uint32_t seed, uint32_t step, uint32_t first_robot,
                    int steer_off, int accumulate, float steer_max,
                    float rate_max) {
  constexpr int U = Dims<M>::U;
  constexpr int S = Dims<M>::S;
  extern __shared__ float smem[];
  __shared__ float s_min[kWarps];
  const int tm1 = horizon - 1;
  const int nu = tm1 * U;
  const int nacc = 1 + (M2 ? 2 : 1) * nu;  // sum w, sum w*u[t, j], [sum w*u^2]
  float* s_ref = smem;                   // num_ref * 3
  float* s_uprev = s_ref + 3 * num_ref;  // tm1 * U
  float* s_wsum = s_uprev + nu;          // kWarps * nacc

  // this block's robot: offset every per-robot operand
  const int robot = blockIdx.y;
  u_prev += (size_t)robot * nu;
  refc += (size_t)robot * 3 * num_ref;
  state0 += (size_t)robot * S;
  scal += (size_t)robot * kNScal;
  if (noise != nullptr) noise += (size_t)robot * nu * num_samples;
  if (costs_in != nullptr) costs_in += (size_t)robot * num_samples;
  if (costs != nullptr) costs += (size_t)robot * num_samples;

  for (int i = threadIdx.x; i < 3 * num_ref; i += kThreads) s_ref[i] = refc[i];
  for (int i = threadIdx.x; i < nu; i += kThreads) s_uprev[i] = u_prev[i];
  __syncthreads();

  const int k = blockIdx.x * kThreads + threadIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const float beta = scal[kBeta];
  RowSampler<U> smp;
  smp.noise = noise;
  smp.uprev = s_uprev;
#pragma unroll
  for (int j = 0; j < U; ++j) {
    smp.sigma[j] = sigma[j];
    smp.umin[j] = u_min[j];
    smp.umax[j] = u_max[j];
    smp.eps[j] = 0.0f;
  }
  smp.beta = beta;
  smp.bscale = sqrtf(1.0f - beta * beta);
  smp.num_samples = num_samples;
  smp.k = k;
  smp.valid = k < num_samples;
  smp.steer_off = steer_off != 0;
  smp.seed = seed;
  smp.step = step;
  smp.robot = first_robot + (uint32_t)robot;

  // --- rollout + cost, or the costs of an earlier pass -------------------
  float cost;
  if (costs_in != nullptr) {
    cost = smp.valid ? costs_in[k] : INFINITY;
  } else {
    if constexpr (M == kFullBody) {
      cost = full_body_cost(smp, state0, scal, s_ref, num_ref, horizon);
    } else {
      cost = tracking_cost<M>(smp, state0, scal, s_ref, num_ref, tm1,
                              steer_max, rate_max);
    }
    if (smp.valid) costs[k] = cost;
    if (!accumulate) return;  // uniform over the grid
  }

  // --- block minimum over valid samples ----------------------------------
  const float cm = warp_min(smp.valid ? cost : INFINITY);
  if (lane == 0) s_min[warp] = cm;
  __syncthreads();
  float m_block = s_min[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) m_block = fminf(m_block, s_min[i]);

  // --- weighted sums under the block baseline, elites only ---------------
  const float neg_rlam = -1.0f / scal[kLam];
  const bool live = smp.valid && cost <= scal[kThresh];
  const float wgt = live ? expf((cost - m_block) * neg_rlam) : 0.0f;
  float* wsum = s_wsum + warp * nacc;
  const float sw = warp_sum(wgt);
  if (lane == 0) wsum[0] = sw;
  float cur[U];
  for (int t = 0; t < tm1; ++t) {
    smp.row(t, cur);
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const float wu = wgt * cur[j];
      const float s = warp_sum(wu);
      if (lane == 0) wsum[1 + t * U + j] = s;
      if constexpr (M2) {
        const float s2 = warp_sum(wu * cur[j]);
        if (lane == 0) wsum[1 + nu + t * U + j] = s2;
      }
    }
  }
  __syncthreads();

  float* out = partials + ((size_t)robot * gridDim.x + blockIdx.x) * (nacc + 1);
  if (threadIdx.x == 0) out[0] = m_block;
  for (int i = threadIdx.x; i < nacc; i += kThreads) {
    float s = 0.0f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += s_wsum[wi * nacc + i];
    out[1 + i] = s;
  }
}

template <int M, bool M2>
int launch(const float* u_prev, const float* sigma, const float* u_min,
           const float* u_max, const float* refc, const float* state0,
           const float* scal, const float* noise, const float* costs_in,
           float* costs, float* partials, int num_samples, int horizon,
           int num_ref, unsigned int seed, unsigned int step,
           unsigned int first_robot, int steer_off, int accumulate,
           float steer_max, float rate_max, int num_robots,
           cudaStream_t stream) {
  constexpr int U = Dims<M>::U;
  const dim3 grid((num_samples + kThreads - 1) / kThreads, num_robots);
  const size_t tm1u = static_cast<size_t>(horizon - 1) * U;
  const size_t smem = sizeof(float) *
      (3 * static_cast<size_t>(num_ref) + tm1u + kWarps * (1 + (M2 ? 2 : 1) * tm1u));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rollout_cost_kernel<M, M2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  rollout_cost_kernel<M, M2><<<grid, kThreads, smem, stream>>>(
      u_prev, sigma, u_min, u_max, refc, state0, scal, noise, costs_in, costs,
      partials, num_samples, horizon, num_ref, seed, step, first_robot,
      steer_off, accumulate, steer_max, rate_max);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int rollout_cost_block_threads() { return kThreads; }

int rollout_cost_num_scalars() { return kNScal; }

// U * 16 + S of model id `model`, or -1 for an unknown id.
int rollout_cost_model_dims(int model) {
  switch (model) {
    case kUnicycle: return Dims<kUnicycle>::U * 16 + Dims<kUnicycle>::S;
    case kSteering: return Dims<kSteering>::U * 16 + Dims<kSteering>::S;
    case kRateLimited: return Dims<kRateLimited>::U * 16 + Dims<kRateLimited>::S;
    case kFullBody: return Dims<kFullBody>::U * 16 + Dims<kFullBody>::S;
    default: return -1;
  }
}

const char* rollout_cost_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the kernel of model id `model` on `stream`. Returns the
// cudaError_t of the launch (0 on success). noise may be null (RNG mode).
// costs_in non-null: the costs-free pass, costs unused (may be null).
// accumulate == 0: the costs-only pass, partials unused (may be null), and
// second_moment must be 0. Otherwise partials is (B, ceil(K / kThreads),
// 2 + (1 + second_moment) * (T-1)*U): per robot and block [m_b, sum w,
// sum w*u[t, j] ..., with second_moment sum w*u[t, j]^2 ...].
// num_robots = B: every per-robot operand has a leading (B,) axis; sigma,
// u_min and u_max are shared. Robot b draws the RNG stream of robot index
// first_robot + b.
int rollout_cost(int model, const float* u_prev, const float* sigma,
                 const float* u_min, const float* u_max, const float* refc,
                 const float* state0, const float* scal, const float* noise,
                 const float* costs_in, float* costs, float* partials,
                 int num_samples, int horizon, int num_ref, unsigned int seed,
                 unsigned int step, unsigned int first_robot, int steer_off,
                 int accumulate, float steer_max, float rate_max,
                 int num_robots, int second_moment, void* stream) {
  if (num_samples < 1 || horizon < 2 || num_ref < 1 || num_robots < 1 ||
      num_robots > 65535 ||
      (costs_in == nullptr && costs == nullptr) ||
      ((costs_in != nullptr || accumulate) && partials == nullptr) ||
      (costs_in != nullptr && !accumulate) || (second_moment && !accumulate)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ROLLOUT_COST_ARGS                                                    \
  u_prev, sigma, u_min, u_max, refc, state0, scal, noise, costs_in, costs,   \
      partials, num_samples, horizon, num_ref, seed, step, first_robot,      \
      steer_off, accumulate, steer_max, rate_max, num_robots, s
#define ROLLOUT_COST_CASE(M)                                                 \
  case M:                                                                    \
    return second_moment ? launch<M, true>(ROLLOUT_COST_ARGS)                \
                         : launch<M, false>(ROLLOUT_COST_ARGS);
  switch (model) {
    ROLLOUT_COST_CASE(kUnicycle)
    ROLLOUT_COST_CASE(kSteering)
    ROLLOUT_COST_CASE(kRateLimited)
    ROLLOUT_COST_CASE(kFullBody)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ROLLOUT_COST_CASE
#undef ROLLOUT_COST_ARGS
}

}  // extern "C"
