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
// What bounds it on this card: instructions, not bytes. Per sample and step
// the kernel draws U normals (Philox4x32-10 and a precise Box-Muller), scans
// the R reference points (two FMAs and a min each), and evaluates the model's
// sincos terms; it reads at most the injected noise and writes one cost per
// sample. Counted from the shapes (kernels/rollout_cost.py
// rollout_cost_work), the least time at full_body K=102400 T=30 is Philox's
// integer work at the H100's INT32 rate, about 0.016 ms; the kernel takes
// about 0.16 (PERF.md), held back by occupancy: the store form's tile keeps
// an SM to about 12 warps at full_body T=30, and the precise libm calls and
// Philox rounds are long dependent chains. wgmma and TMA have no role: there
// is no matrix product, and the one bulk read (the partial rows, in the
// finish) is a few hundred KB, copied with cp.async.
//
// Design, and what each part does about that bound:
// - One thread per sample, blockDim.x = the block size the wrapper chooses
//   (a multiple of 32, at most kMaxThreads; kernels/rollout_cost.py
//   launch_shape, by how evenly the blocks spread over the 132 SMs). The
//   model is a template parameter: U and S are compile-time, one
//   instantiation per (model, second moment, form).
// - Two forms, chosen by the wrapper from the shape alone:
//   * store (kStore): each control is drawn once. During the rollout
//     every thread writes its clamped u[t][j] into a shared-memory tile,
//     column t*U + j, one word per sample, swizzled
//     (sample s ^ (column & 31)) so that neither the row writes of a warp nor
//     the column reads below conflict on a bank. After the block minimum and
//     the weights, thread i sums the columns i, i + blockDim, ... over the
//     block's samples in a fixed order (four interleaved chains), the weights
//     read from a shared row: no warp shuffle, deterministic. The tile costs
//     (T-1)*U*4 bytes per sample, so it sets the samples per block.
//   * regenerate: where even 32 samples' tiles do not fit in shared memory
//     (full_body beyond T = 344 with R = T), the update loop draws every row
//     again (the same Philox numbers, or the noise re-read) and reduces each
//     sum with a warp shuffle, one shared slot per (warp, sum) and a
//     fixed-order sum over the warps. The two passes of two-pass elite use it
//     too: the costs-only pass has no update, and the costs-in pass has no
//     rollout, so it draws each row once either way (the store form fills its
//     tile from the RNG or the noise) and this form holds more warps.
// - Registers: 64 (four blocks of kMaxThreads), except full_body's store
//   form, which its tile holds to about 12 warps anyway: it may take what it
//   needs (ptxas: 168, no spills), where at 64 it spilled.
// - The reference window arrives as (R_pad, 4) rows [2(rx-cx), 2(ry-cy),
//   |r-c|^2, 0], R padded to a multiple of 4 with rows [0, 0, +inf, 0] that
//   can never be the minimum. Each row is one 16-byte broadcast load from
//   shared memory and the scan is unrolled by 4; the four candidates are
//   reduced by a min tree (min is exact, so the order does not change the
//   result), each candidate computed as before.
// - The update is finished inside the kernel, which saves the 8-10 PyTorch
//   launches of a finish on the host. Blocks run in parallel and in no order,
//   so each writes a partial row [m_b, sum w, sums of w*u[t, j], with the
//   second moment the sums of (w*u[t, j])*u[t, j]] under its own baseline
//   m_b (the minimum of its valid costs), fences, and takes a ticket on its
//   group's counter (groups of kGroup consecutive blocks). The last block of
//   a group reduces the group's rows into a group row: the group minimum m,
//   each row scaled by exp((m_b - m) * (-1/lambda)), summed in block order.
//   The last group of a robot reduces the group rows the same way into
//   u_num, norm and u2_num. The order is fixed whichever block finishes
//   last, so the result is deterministic. Against one level (one block
//   reducing every row of its robot), the second level takes 3-13 % off the
//   kernel at the flagship shapes the wrapper picks, 9-28 % with the second
//   moment (PERF.md); a fleet robot of up to 32 blocks has one group. Each last
//   block resets its counter to 0, so no memset launch is needed. The
//   costs-only pass takes no ticket. m_b is over all valid costs, not the
//   elites only, so a block without elites writes zero sums under a finite
//   m_b.
// - Fleet grid: gridDim.y = B robots, gridDim.x = the blocks of one robot.
//   blockIdx.y offsets every per-robot operand; sigma and the box are
//   shared. Each robot has its own counters and its own baseline.
// - Padded samples (index >= num_samples) neither enter the block minimum
//   nor get weight; their controls are finite (the noise reads 0), so a zero
//   weight times a tile entry stays 0.
// - RNG mode: Philox4x32-10 keyed by (seed, step) at counter (k, t, pair, b)
//   with k the sample and b the robot (0 for one robot); Box-Muller over
//   the top 23 bits of words 0 and 1 gives the normals of controls 2*pair
//   (cosine) and 2*pair+1 (sine). (U+1)/2 pairs per row: for U = 3 the
//   fourth normal is drawn and dropped. Every normal is a pure function of (seed, step, b, k,
//   t, j), independent of the block size, the form and B; robot 0 of a
//   fleet draws the single-robot stream. A launch may start at another
//   robot index (first_robot), so robot b of a fleet is one launch of its
//   own too, and at another sample index (first_sample: counter word 0 is
//   first_sample + k), so the shard of samples [s, s + K) of a sharded
//   update draws exactly those samples of the unsharded stream.
// - The key: (seed, step) come by value, or, where the wrapper passes the
//   key pointer, from device memory: two int64 words [seed, step], read by
//   every block before its first Philox call, as the TPU kernel reads its
//   seed operand. A CUDA graph then replays with the key that the step
//   advances on the device, and draws new samples every cycle. The low 32
//   bits of each word are the Philox key, as the by-value launch masks
//   them, so the two draw the same stream.
// - rate_limited_steering's steer and rate limits come in as two arguments.
// - Precise logf/expf/sinf/cosf: no fast-math.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (kernels/build.py), bound with ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxDevices = 64;
constexpr int kGroup = 32;           // blocks per group of the finish
constexpr int kMaxDynamicSmem = 232448 - 64;  // 227 KB less the static smem
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

__host__ __device__ constexpr int align4(int n) { return (n + 3) & ~3; }

// Floats of one partial row: [m_b, sum w, sums w*u[t, j], [sums w*u^2]],
// padded to a multiple of 4 so that rows are 16-byte aligned.
__host__ __device__ constexpr int row_floats(int nu, bool m2) {
  return align4(2 + (m2 ? 2 : 1) * nu);
}

// Dynamic shared memory of one block, in floats (kernels/rollout_cost.py
// smem_bytes mirrors this and the binding checks that the two agree):
// the reference rows (4 * num_ref4), u_prev (nu), the weights row (threads),
// then the form's region: the control tile (nu * threads, store), one slot
// per (warp, sum) (regenerate), nothing (costs only). With the update, the
// finish reuses the whole area: the nacc sums, a scale per row and the kGroup
// rows of a group staged at once, or one row where kGroup rows do not fit.
int smem_floats(int u, bool store, bool m2, bool accumulate, int threads,
                int horizon, int num_ref4) {
  const int nu = (horizon - 1) * u;
  const int nacc = 1 + (m2 ? 2 : 1) * nu;
  const int rs = row_floats(nu, m2);
  int big = 0;
  if (accumulate) big = store ? nu * threads : (threads / 32) * nacc;
  const int rollout = 4 * num_ref4 + align4(nu) + threads + big;
  if (!accumulate) return rollout;
  const int want = align4(nacc) + kGroup + kGroup * rs;
  const int least = align4(nacc) + 4 + rs;
  const int fin = (static_cast<long long>(want) * 4 <= kMaxDynamicSmem) ? want : least;
  return rollout > fin ? rollout : fin;
}

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

// Index of (column, sample) in the store form's control tile: column-major
// with the sample swizzled by the column's low five bits. A warp writing one
// column (32 samples) and a warp reading 32 columns at one sample both touch
// 32 distinct banks. threads is a multiple of 32, so s ^ (col & 31) stays
// inside the column.
__device__ __forceinline__ int tile_index(int col, int s, int threads) {
  return col * threads + (s ^ (col & 31));
}

// Draws the control rows of one sample in time order, u[t, j] =
// clamp(u_prev[t, j] + sigma[j] * eps[t, j]), with eps the (optionally
// colored) standard normals: eps_t = beta*eps_{t-1} + sqrt(1-beta^2)*eta_t.
// Row 0 restarts the recurrence, so one sampler serves both passes over t
// of the regenerate form. The store form also writes each row to its tile.
template <int U, bool kStore>
struct RowSampler {
  static constexpr int kPairs = (U + 1) / 2;  // Box-Muller pairs per row
  const float* noise;   // (T-1, U, K) standard normals, or nullptr (RNG mode)
  const float* uprev;   // shared (T-1, U)
  float* tile;          // shared control tile (store form)
  float sigma[U], umin[U], umax[U];
  float beta, bscale;
  int num_samples, k, s, threads;
  bool valid, steer_off;
  uint32_t seed, step, robot;
  uint32_t ctr;         // Philox counter word 0: first_sample + k
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
        uint32_t c0 = ctr, c1 = (uint32_t)t, c2 = (uint32_t)p, c3 = robot;
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
      if constexpr (kStore) tile[tile_index(t * U + j, s, threads)] = val;
    }
  }
};

// clamp(min_j |p - ref_j|^2, 0, cap^2) in the centered expanded form
// (ops/mindist.py): ref rows are [2(r_j-c), |r_j-c|^2, 0], p is centered,
// num_ref4 a multiple of 4 (padded rows are [0, 0, +inf, 0]).
__device__ __forceinline__ float path_d2(float x, float y, const float4* ref,
                                         int num_ref4) {
  const float pn = x * x + y * y;
  float m = INFINITY;
  for (int j = 0; j < num_ref4; j += 4) {
    const float4 r0 = ref[j], r1 = ref[j + 1], r2 = ref[j + 2], r3 = ref[j + 3];
    const float d0 = r0.z - x * r0.x - y * r0.y;
    const float d1 = r1.z - x * r1.x - y * r1.y;
    const float d2 = r2.z - x * r2.x - y * r2.y;
    const float d3 = r3.z - x * r3.x - y * r3.y;
    m = fminf(m, fminf(fminf(d0, d1), fminf(d2, d3)));
  }
  return fminf(fmaxf(pn + m, 0.0f), kCap2);
}

// Rollout + cost of one sample, unicycle / steering / rate-limited models
// (ops/costs.py tracking_cost): path term over all T states, velocity term
// over the T-1 controls. Heading is yaw (unicycle), yaw plus the steer
// control (steering), or yaw plus the steer state before this step's slew
// (rate-limited: then rate = clip(u2), steer = clip(steer + rate*dt)).
template <int M, bool kStore>
__device__ __forceinline__ float tracking_cost(RowSampler<Dims<M>::U, kStore>& smp,
                                               const float* s0, const float* scal,
                                               const float4* ref, int num_ref4,
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
    cost += path_w * path_d2(x, y, ref, num_ref4);
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
  return cost + path_w * path_d2(x, y, ref, num_ref4);  // final state's term
}

// Rollout + cost of one sample, full-body model (ops/costs.py
// full_body_cost): every term over t in [0, T-3], plus the initial-yaw term.
template <bool kStore>
__device__ __forceinline__ float full_body_cost(RowSampler<5, kStore>& smp,
                                                const float* s0,
                                                const float* scal,
                                                const float4* ref, int num_ref4,
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
    cost += path_w * path_d2(x, y, ref, num_ref4);
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

// Minimum of v over the block; s_min holds one slot per warp. Every thread
// returns the same value.
__device__ __forceinline__ float block_min(float v, float* s_min) {
  const float wm = warp_min(v);
  if ((threadIdx.x & 31) == 0) s_min[threadIdx.x >> 5] = wm;
  __syncthreads();
  float m = s_min[0];
  const int nwarps = blockDim.x >> 5;
  for (int i = 1; i < nwarps; ++i) m = fminf(m, s_min[i]);
  __syncthreads();  // s_min may be reused
  return m;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Reduces n partial rows (rs floats each: [m_b, sum w, sums ...]) in row
// order: m = the minimum of their baselines, each row scaled from its m_b to
// m by exp((m_b - m) * neg_rlam) and the rows summed, chunk by chunk (as
// many rows as the block's shared memory holds, copied with cp.async). With
// dst, writes the row [m, sums] there; else the robot's outputs norm, u_num
// (nu) and u2_num (nu, if not null).
__device__ void reduce_rows(const float* rows, int n, int rs, int nacc, int nu,
                            float neg_rlam, float* smem, int smem_floats,
                            float* s_min, float* dst, float* u_num, float* norm,
                            float* u2_num) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  float m = INFINITY;
  for (int b = tid; b < n; b += nthr) m = fminf(m, __ldcg(rows + (size_t)b * rs));
  m = block_min(m, s_min);

  const int na4 = align4(nacc);
  int cb = (smem_floats - na4 - 3) / (rs + 1);  // rows per chunk
  if (cb > n) cb = n;
  float* s_acc = smem;                    // nacc sums
  float* s_scale = s_acc + na4;           // a scale per staged row
  float* stage = s_scale + align4(cb);    // cb rows, 16-byte aligned
  for (int b0 = 0; b0 < n; b0 += cb) {
    const int nb = min(cb, n - b0);
    const float* src = rows + (size_t)b0 * rs;
    const int n4 = nb * rs / 4;
    for (int i = tid; i < n4; i += nthr) cp_async16(stage + 4 * i, src + 4 * i);
    cp_async_wait_all();
    __syncthreads();
    for (int b = tid; b < nb; b += nthr) s_scale[b] = expf((stage[b * rs] - m) * neg_rlam);
    __syncthreads();
    for (int ci = tid; ci < nacc; ci += nthr) {
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
      const float* col = stage + 1 + ci;
      int b = 0;
      for (; b + 4 <= nb; b += 4) {
        a0 += s_scale[b] * col[b * rs];
        a1 += s_scale[b + 1] * col[(b + 1) * rs];
        a2 += s_scale[b + 2] * col[(b + 2) * rs];
        a3 += s_scale[b + 3] * col[(b + 3) * rs];
      }
      for (; b < nb; ++b) a0 += s_scale[b] * col[b * rs];
      const float chunk = (a0 + a1) + (a2 + a3);
      s_acc[ci] = (b0 == 0) ? chunk : s_acc[ci] + chunk;
    }
    __syncthreads();  // the next chunk overwrites the stage
  }
  if (dst != nullptr) {
    if (tid == 0) dst[0] = m;
    for (int ci = tid; ci < nacc; ci += nthr) dst[1 + ci] = s_acc[ci];
    return;
  }
  if (tid == 0) *norm = s_acc[0];
  for (int c = tid; c < nu; c += nthr) {
    u_num[c] = s_acc[1 + c];
    if (u2_num != nullptr) u2_num[c] = s_acc[1 + nu + c];
  }
}

// Takes a ticket on *counter after this block's global writes; true in
// every thread of the block that takes the last of `count` tickets, which
// also resets the counter to 0 for the next launch.
__device__ __forceinline__ bool last_ticket(unsigned int* counter, unsigned int count,
                                            int* s_last) {
  __threadfence();  // this thread's writes, device-wide
  __syncthreads();
  if (threadIdx.x == 0) *s_last = atomicAdd(counter, 1u) == count - 1u;
  __syncthreads();
  if (!*s_last) return false;
  __threadfence();
  if (threadIdx.x == 0) *counter = 0u;  // every block has counted
  return true;
}

// costs_in != nullptr: the costs-free elite pass (no rollout, no cost
// output). accumulate == 0: the costs-only pass (no update, no partials, no
// ticket; regenerate instantiation). M2: also the second-moment sums.
// kStore: the store form (controls drawn once into the shared tile).
// Grid (ceil(K / blockDim.x), B).
// Registers: see the header (full_body's store form uncapped, else 64).
template <int M, bool M2, bool kStore>
__global__ void __launch_bounds__(kMaxThreads, (kStore && M == kFullBody) ? 1 : 4)
rollout_cost_kernel(const float* __restrict__ u_prev,
                    const float* __restrict__ sigma,
                    const float* __restrict__ u_min,
                    const float* __restrict__ u_max,
                    const float4* __restrict__ refc,
                    const float* __restrict__ state0,
                    const float* __restrict__ scal,
                    const float* __restrict__ noise,
                    const float* __restrict__ costs_in,
                    float* __restrict__ costs,
                    float* partials,
                    unsigned int* counters,
                    const long long* __restrict__ key,
                    float* __restrict__ u_num,
                    float* __restrict__ norm,
                    float* __restrict__ u2_num,
                    int num_samples, int horizon, int num_ref4, int smem_total,
                    uint32_t seed, uint32_t step, uint32_t first_robot,
                    uint32_t first_sample, int steer_off, int accumulate,
                    float steer_max, float rate_max) {
  constexpr int U = Dims<M>::U;
  constexpr int S = Dims<M>::S;
  extern __shared__ float4 smem4[];
  __shared__ float s_min[kMaxWarps];
  __shared__ int s_last;
  const int threads = blockDim.x;
  const int tid = threadIdx.x;
  const int tm1 = horizon - 1;
  const int nu = tm1 * U;
  const int nacc = 1 + (M2 ? 2 : 1) * nu;  // sum w, sum w*u[t, j], [sum w*u^2]
  const int rs = row_floats(nu, M2);
  float4* s_ref = smem4;                                 // num_ref4 rows
  float* s_uprev = reinterpret_cast<float*>(smem4 + num_ref4);  // nu
  float* s_w = s_uprev + align4(nu);                     // threads
  float* s_big = s_w + threads;                          // the form's region

  // this block's robot: offset every per-robot operand
  const int robot = blockIdx.y;
  u_prev += (size_t)robot * nu;
  refc += (size_t)robot * num_ref4;
  state0 += (size_t)robot * S;
  scal += (size_t)robot * kNScal;
  if (noise != nullptr) noise += (size_t)robot * nu * num_samples;
  if (costs_in != nullptr) costs_in += (size_t)robot * num_samples;
  if (costs != nullptr) costs += (size_t)robot * num_samples;

  for (int i = tid; i < num_ref4; i += threads) s_ref[i] = refc[i];
  for (int i = tid; i < nu; i += threads) s_uprev[i] = u_prev[i];
  __syncthreads();

  const int k = blockIdx.x * threads + tid;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const float beta = scal[kBeta];
  RowSampler<U, kStore> smp;
  smp.noise = noise;
  smp.uprev = s_uprev;
  smp.tile = s_big;
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
  smp.s = tid;
  smp.threads = threads;
  smp.valid = k < num_samples;
  smp.steer_off = steer_off != 0;
  smp.seed = key != nullptr ? static_cast<uint32_t>(key[0]) : seed;
  smp.step = key != nullptr ? static_cast<uint32_t>(key[1]) : step;
  smp.robot = first_robot + (uint32_t)robot;
  smp.ctr = first_sample + (uint32_t)k;

  // --- rollout + cost, or the costs of an earlier pass -------------------
  float cost;
  if (costs_in != nullptr) {
    cost = smp.valid ? costs_in[k] : INFINITY;
    if constexpr (kStore) {
      float u[U];
      for (int t = 0; t < tm1; ++t) smp.row(t, u);
    }
  } else {
    if constexpr (M == kFullBody) {
      cost = full_body_cost<kStore>(smp, state0, scal, s_ref, num_ref4, horizon);
    } else {
      cost = tracking_cost<M, kStore>(smp, state0, scal, s_ref, num_ref4, tm1,
                                      steer_max, rate_max);
    }
    if (smp.valid) costs[k] = cost;
    if (!accumulate) return;  // uniform over the grid
  }

  // --- block minimum over valid samples ----------------------------------
  const float m_block = block_min(smp.valid ? cost : INFINITY, s_min);

  // --- weighted sums under the block baseline, elites only ---------------
  const float neg_rlam = -1.0f / scal[kLam];
  const bool live = smp.valid && cost <= scal[kThresh];
  const float wgt = live ? expf((cost - m_block) * neg_rlam) : 0.0f;
  const int nblk = gridDim.x;
  const int ngroups = (nblk + kGroup - 1) / kGroup;
  float* out = partials + ((size_t)robot * (nblk + ngroups) + blockIdx.x) * rs;
  if (tid == 0) out[0] = m_block;
  if constexpr (kStore) {
    s_w[tid] = wgt;
    __syncthreads();
    // column ci = 0 is the normalizer (sum w), ci >= 1 the tile column ci - 1
    for (int ci = tid; ci <= nu; ci += threads) {
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
      float b0 = 0.0f, b1 = 0.0f, b2 = 0.0f, b3 = 0.0f;
      if (ci == 0) {
        for (int s = 0; s < threads; s += 4) {
          a0 += s_w[s];
          a1 += s_w[s + 1];
          a2 += s_w[s + 2];
          a3 += s_w[s + 3];
        }
      } else {
        const int c = ci - 1;
        const float* col = s_big + c * threads;
        const int sw = c & 31;
        for (int s = 0; s < threads; s += 4) {
          const float u0 = col[s ^ sw], u1 = col[(s + 1) ^ sw];
          const float u2 = col[(s + 2) ^ sw], u3 = col[(s + 3) ^ sw];
          const float wu0 = s_w[s] * u0, wu1 = s_w[s + 1] * u1;
          const float wu2 = s_w[s + 2] * u2, wu3 = s_w[s + 3] * u3;
          a0 += wu0;
          a1 += wu1;
          a2 += wu2;
          a3 += wu3;
          if constexpr (M2) {
            b0 += wu0 * u0;
            b1 += wu1 * u1;
            b2 += wu2 * u2;
            b3 += wu3 * u3;
          }
        }
        if constexpr (M2) out[1 + nu + ci] = (b0 + b1) + (b2 + b3);
      }
      out[1 + ci] = (a0 + a1) + (a2 + a3);
    }
  } else {
    float* wsum = s_big + warp * nacc;
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
    const int nwarps = threads >> 5;
    for (int i = tid; i < nacc; i += threads) {
      float s = 0.0f;
      for (int wi = 0; wi < nwarps; ++wi) s += s_big[wi * nacc + i];
      out[1 + i] = s;
    }
  }

  // --- the finish: two levels of tickets --------------------------------
  // The last block of each group of kGroup blocks reduces the group's rows
  // into a group row (after the robot's block rows); the last group to
  // finish reduces the group rows into the outputs. A robot with one group
  // reduces its block rows into the outputs directly.
  unsigned int* tickets = counters + (size_t)robot * (ngroups + 1);
  const int g = blockIdx.x / kGroup;
  const int g0 = g * kGroup;
  const int gn = min(kGroup, nblk - g0);
  if (!last_ticket(tickets + g, gn, &s_last)) return;
  float* rows = partials + (size_t)robot * (nblk + ngroups) * rs;
  float* smem = reinterpret_cast<float*>(smem4);
  float* u_num_r = u_num + (size_t)robot * nu;
  float* u2_num_r = M2 ? u2_num + (size_t)robot * nu : nullptr;
  if (ngroups == 1) {
    reduce_rows(rows, nblk, rs, nacc, nu, neg_rlam, smem, smem_total, s_min, nullptr,
                u_num_r, norm + robot, u2_num_r);
    return;
  }
  float* group_rows = rows + (size_t)nblk * rs;
  reduce_rows(rows + (size_t)g0 * rs, gn, rs, nacc, nu, neg_rlam, smem, smem_total,
              s_min, group_rows + (size_t)g * rs, nullptr, nullptr, nullptr);
  if (!last_ticket(tickets + ngroups, ngroups, &s_last)) return;
  reduce_rows(group_rows, ngroups, rs, nacc, nu, neg_rlam, smem, smem_total, s_min,
              nullptr, u_num_r, norm + robot, u2_num_r);
}

template <int M, bool M2, bool kStore>
cudaError_t allow_smem() {
  static bool done[kMaxDevices] = {false};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(rollout_cost_kernel<M, M2, kStore>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxDynamicSmem);
  if (e == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return e;
}

template <int M, bool M2, bool kStore>
int blocks_per_sm(int threads, int smem_bytes) {
  const cudaError_t e = allow_smem<M, M2, kStore>();
  if (e != cudaSuccess) return -1;
  int n = -1;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &n, rollout_cost_kernel<M, M2, kStore>, threads, smem_bytes) == cudaSuccess
             ? n : -1;
}

template <int M, bool M2, bool kStore>
int launch(const float* u_prev, const float* sigma, const float* u_min,
           const float* u_max, const float* refc, const float* state0,
           const float* scal, const float* noise, const float* costs_in,
           float* costs, float* partials, unsigned int* counters,
           const long long* key, float* u_num,
           float* norm, float* u2_num, int num_samples, int horizon,
           int num_ref4, unsigned int seed, unsigned int step,
           unsigned int first_robot, unsigned int first_sample, int steer_off,
           int accumulate, float steer_max, float rate_max, int num_robots, int threads,
           cudaStream_t stream) {
  constexpr int U = Dims<M>::U;
  const dim3 grid((num_samples + threads - 1) / threads, num_robots);
  const int floats = smem_floats(U, kStore, M2, accumulate != 0, threads, horizon,
                                 num_ref4);
  const size_t smem = sizeof(float) * static_cast<size_t>(floats);
  if (smem > static_cast<size_t>(kMaxDynamicSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = allow_smem<M, M2, kStore>();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  rollout_cost_kernel<M, M2, kStore><<<grid, threads, smem, stream>>>(
      u_prev, sigma, u_min, u_max, reinterpret_cast<const float4*>(refc), state0,
      scal, noise, costs_in, costs, partials, counters, key, u_num, norm, u2_num,
      num_samples, horizon, num_ref4, floats, seed, step, first_robot, first_sample,
      steer_off, accumulate, steer_max, rate_max);
  return static_cast<int>(cudaGetLastError());
}

int model_u(int model) {
  switch (model) {
    case kUnicycle: return Dims<kUnicycle>::U;
    case kSteering: return Dims<kSteering>::U;
    case kRateLimited: return Dims<kRateLimited>::U;
    case kFullBody: return Dims<kFullBody>::U;
    default: return -1;
  }
}

}  // namespace

extern "C" {

int rollout_cost_max_threads() { return kMaxThreads; }

int rollout_cost_num_scalars() { return kNScal; }

// The parameters of rollout_cost, one letter each: i int, u unsigned int,
// f float, p pointer (kernels/rollout_cost.py SIGNATURE, which the binding
// holds equal to this).
const char* rollout_cost_signature() {
  return "ii" "pppppppppppppppp" "iiiuuuuiiffiiip";
}

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

// Dynamic shared memory bytes of one block (what launch passes), or -1 for
// an unknown model; and the floats of one partial row.
int rollout_cost_smem_bytes(int model, int store, int second_moment, int accumulate,
                            int threads, int horizon, int num_ref4) {
  const int u = model_u(model);
  if (u < 0) return -1;
  return 4 * smem_floats(u, store != 0, second_moment != 0, accumulate != 0, threads,
                         horizon, num_ref4);
}

int rollout_cost_row_floats(int model, int second_moment, int horizon) {
  const int u = model_u(model);
  return u < 0 ? -1 : row_floats((horizon - 1) * u, second_moment != 0);
}

const char* rollout_cost_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Blocks of `threads` threads with `smem_bytes` of dynamic shared memory
// that one SM holds at once, by the CUDA occupancy calculator; -1 on error.
int rollout_cost_blocks_per_sm(int model, int store, int second_moment, int threads,
                               int smem_bytes) {
#define ROLLOUT_COST_OCC(M)                                                     \
  case M:                                                                       \
    if (store) {                                                                \
      return second_moment ? blocks_per_sm<M, true, true>(threads, smem_bytes)  \
                           : blocks_per_sm<M, false, true>(threads, smem_bytes); \
    }                                                                           \
    return second_moment ? blocks_per_sm<M, true, false>(threads, smem_bytes)   \
                         : blocks_per_sm<M, false, false>(threads, smem_bytes);
  switch (model) {
    ROLLOUT_COST_OCC(kUnicycle)
    ROLLOUT_COST_OCC(kSteering)
    ROLLOUT_COST_OCC(kRateLimited)
    ROLLOUT_COST_OCC(kFullBody)
    default: return -1;
  }
#undef ROLLOUT_COST_OCC
}

// Launches the kernel of model id `model` on `stream`, in the store form
// (store != 0) or the regenerate form, with `threads` threads per block (a
// multiple of 32, at most rollout_cost_max_threads()). Returns the
// cudaError_t of the launch (0 on success). noise may be null (RNG mode).
// refc is (B, num_ref4, 4) with num_ref4 a multiple of 4. costs_in non-null:
// the costs-free pass, costs unused (may be null). accumulate == 0: the
// costs-only pass, in the regenerate form with second_moment 0; partials,
// counters and the outputs unused (may be null). Otherwise, with n =
// ceil(K / threads) blocks and g = ceil(n / 32) groups per robot, partials is
// (B, n + g, rollout_cost_row_floats) scratch, counters (B, g + 1) zeros
// (left at zero again), and the kernel writes u_num (B, T-1, U), norm
// (B,) and, with second_moment, u2_num (B, T-1, U). num_robots = B: every
// per-robot operand has a leading (B,) axis; sigma, u_min and u_max are
// shared. Robot b draws the RNG stream of robot index first_robot + b, and
// sample k the normals of sample index first_sample + k. key non-null: the
// (seed, step) of the RNG mode are read on the device from key[0], key[1]
// (int64), and the by-value seed and step are unused.
int rollout_cost(int model, int store, const float* u_prev, const float* sigma,
                 const float* u_min, const float* u_max, const float* refc,
                 const float* state0, const float* scal, const float* noise,
                 const float* costs_in, float* costs, float* partials,
                 unsigned int* counters, const long long* key, float* u_num,
                 float* norm, float* u2_num,
                 int num_samples, int horizon, int num_ref4, unsigned int seed,
                 unsigned int step, unsigned int first_robot,
                 unsigned int first_sample, int steer_off,
                 int accumulate, float steer_max, float rate_max, int num_robots,
                 int second_moment, int threads, void* stream) {
  if (num_samples < 1 || horizon < 2 || num_ref4 < 4 || num_ref4 % 4 != 0 ||
      num_robots < 1 || num_robots > 65535 || threads < 32 || threads % 32 != 0 ||
      threads > kMaxThreads ||
      (costs_in == nullptr && costs == nullptr) ||
      (costs_in != nullptr && !accumulate) || (second_moment && !accumulate) ||
      (store && !accumulate) ||
      (accumulate && (partials == nullptr || counters == nullptr ||
                      u_num == nullptr || norm == nullptr)) ||
      (second_moment && u2_num == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ROLLOUT_COST_ARGS                                                       \
  u_prev, sigma, u_min, u_max, refc, state0, scal, noise, costs_in, costs,      \
      partials, counters, key, u_num, norm, u2_num, num_samples, horizon,       \
      num_ref4,                                                                 \
      seed, step, first_robot, first_sample, steer_off, accumulate, steer_max,  \
      rate_max, num_robots, threads, s
#define ROLLOUT_COST_CASE(M)                                                    \
  case M:                                                                       \
    if (store) {                                                                \
      return second_moment ? launch<M, true, true>(ROLLOUT_COST_ARGS)           \
                           : launch<M, false, true>(ROLLOUT_COST_ARGS);         \
    }                                                                           \
    return second_moment ? launch<M, true, false>(ROLLOUT_COST_ARGS)            \
                         : launch<M, false, false>(ROLLOUT_COST_ARGS);
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
