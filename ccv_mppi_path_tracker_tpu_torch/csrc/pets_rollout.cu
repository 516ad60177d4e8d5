// The eager update's particle rollouts and costs over PETS's probabilistic
// ensemble (models/pets_pe.py): every particle's T-1 steps through its
// member's 6-200-200-200-200-8 swish network, the bounded Gaussian head, the
// sampled change of the dynamic states, AutoRally's kinematics, and its
// tracking cost, in one launch, written for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package has no network model, and the
// port's op-by-op version (models/pets_pe.py particle_states, then
// states_cost) is plain PyTorch. It was added for that version's launch
// chain: each of the T-1 steps was five member-batched SGEMMs (torch.baddbmm)
// with swish, the broadcast bias each writes first, the head's ops and the
// layout's reshapes, ~1400 launches an update at K=5120, P=20, T=30, each
// 200-wide activation (5, 20480, 200) float32, 82 MB, streamed through HBM
// about five times a layer; ~44 ms of device time for 0.737 TFLOP
// (benchmark/work_pe.py).
//
// What bounds this kernel: FFMA issue. A particle's step is 122 800
// multiply-adds (6·200 + 3·200·200 + 200·8) and 800 swish, each a precise
// expf and an IEEE division; at 128 FFMA a clock an SM, 132 SMs and 1.98
// GHz the multiply-adds of an update alone take 10.9 ms. No tensor-core
// format keeps the configuration's float32 with TF32 off, so the work runs
// on the CUDA cores. The weights, 2.47 MB, stay in the 50 MB L2; the only
// HBM traffic is the (T-1, K·P, 4) normals and (T-1, K, 2) controls in and
// the K·P costs out (~48 MB, ~15 us).
//
// Design, and what each part does about that:
// - A block of kThreads = 256 threads (8 warps, two a scheduler, so the four
//   schedulers carry the same load) owns kRows = 160 particles of one member
//   (row e, column c of the (E, K·P/E) layout: particle p = j·E + e of
//   sequence k, c = k·(P/E) + j) and carries them through all T-1 steps.
//   160 rows is the tile whose grid comes out near whole waves at one block
//   an SM: at K=5120 the 5 members' 20480 rows are 640 blocks, 4.85 waves
//   over 132 SMs run in 5 (128-row tiles: 800 blocks, 6.06 waves in 7, ~13 %
//   lost). A ragged tile computes its last particle again and stores
//   nothing for the rows past the member's.
// - The activations stay in shared memory, 200 features × 160 rows,
//   feature-major, one buffer: each layer's outputs accumulate in registers,
//   a thread tile of 5 rows × 25 columns (lane l: rows l + 32 i; warp w:
//   columns 25 w ...), and after a barrier are written back over the layer's
//   input with the bias and swish applied on the way. A thread's rows at one
//   input feature are 5 loads of consecutive words across the warp, without
//   bank conflicts; its columns' weights are broadcasts. The particles'
//   states and running costs live in shared memory too: the registers go to
//   the 125 accumulators (held in registers, they spilled).
// - The three 200×200 matrices of the member are streamed from the live
//   parameter tensors (never baked into the launch, so a CUDA graph's replay
//   sees weights changed in place) through a ring of two k-chunks of 20 input
//   features in shared memory, [column][feature], by cp.async (16 bytes, L2
//   only), the next chunk in flight while the block multiplies the current
//   one, one barrier a chunk; a thread reads four features of a column as
//   one 16-byte broadcast. Per 4 features a thread issues 500 FFMA beside 20
//   activation and 25 weight loads (~92 % FFMA). The first layer, the head
//   and the hidden biases of the member are loaded once a block.
// - The head (200 -> 8) is a warp an output, 5 rows a thread, into shared
//   memory; the bounded log-variance, the sampled change dyn + m +
//   exp(l/2)·eps (eps copied ahead from the draw (T-1, K·P, 4) at the
//   particle's counter index k·P + p, with the next step's controls), the
//   kinematics, the centred distance scan over the window and the speed term
//   run per particle in the threads 0 ... 159.
// - Arithmetic: float32 throughout, precise expf, log1pf, sinf and cosf, IEEE
//   division (no fast-math flag, no intrinsic of lower precision), no tensor
//   cores. Each operation is rounded as the op-by-op version rounds it, so
//   that a particle's cost lands within a few units in the last place of that
//   version's: each layer's dot products as cuBLAS's FFMA GEMM computes
//   baddbmm, one chain of multiply-adds in ascending input order from 0 and
//   the bias added after it; swish x / (1 + expf(-x)) and softplus
//   x > 20 ? x : log1pf(expf(x)), as PyTorch's CUDA ops; the input
//   standardiser (x - mu) / sigma; everything else one rounding an operation,
//   with __fmul_rn / __fadd_rn / __fsub_rn where nvcc would otherwise
//   contract a product into a sum: the sampled change (dyn + m) + exp(l/2)
//   eps, the Euler step pose + (dt pose'), the pose derivative, the centred
//   distance scan of ops/mindist.py, the speed error's square, and
//   path_weight * path + v_weight * speed. Only the sums over time run in
//   another order (one chain here).
// - Block 0's thread 0 adds K·P·(T-1) to the model.pe_evals and
//   model.pe_fused device counters (utils/profiling.py), where the wrapper
//   passes them.
// Not hidden: each swish's IEEE division is a dependent chain (reciprocal,
// five FFMA, the slow-path check and its branch) that nothing else of its
// warp overlaps, ~4 of the ~23.5 ms a launch takes on an H100 SXM at
// K=5120, T=30. Computing a column's denominators first, or activating the
// next chunk's inputs beside the products in warps staggered by scheduler,
// both measured slower there.
// The entry point is named without the benchmark's fused-kernel name, whose
// substring its trace reader matches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// 16 bytes from global to shared memory, asynchronously (cp.async through
// L2), and the waits on such copies; a build without the card's compiler
// defines these as plain copies.
#ifndef PETS_COPY16
#define PETS_COPY16(dst, src)                                                         \
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(                   \
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),             \
               "l"(src))
#define PETS_COPY8(dst, src)                                                          \
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(                     \
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),             \
               "l"(src))
#define PETS_COPY_COMMIT() asm volatile("cp.async.commit_group;\n" ::)
#define PETS_COPY_WAIT() asm volatile("cp.async.wait_group 0;\n" ::: "memory")
#endif

namespace {

constexpr int kS = 7;             // x, y, yaw, roll, v_x, v_y, yaw_mder
constexpr int kU = 2;             // steering, throttle
constexpr int kIn = 6;            // a member's input: roll, v_x, v_y, yaw_mder, u
constexpr int kH = 200;           // the four hidden layers
constexpr int kHead = 8;          // the head: mean (4) then log-variance (4)
constexpr int kOut = 4;           // roll, v_x, v_y, yaw_mder: the states a member predicts
constexpr int kMembers = 5;       // E
constexpr int kParticles = 20;    // P, particles a sequence
constexpr int kPer = kParticles / kMembers;   // a member's particles of a sequence
constexpr int kHidden = 3;        // the 200x200 products
constexpr int kThreads = 256;     // a block: 8 warps
constexpr int kRows = 160;        // particles a block, all of one member
constexpr int kRowsPerThread = kRows / 32;    // 5: rows lane + 32 i
constexpr int kCols = kH / (kThreads / 32);   // 25: columns a warp
constexpr int kChunk = 20;        // input features a weight chunk
constexpr int kChunks = kH / kChunk;          // chunks a hidden layer
constexpr int kMaxRef = 1024;     // window points (16 B of shared memory each)
constexpr float kDistCap2 = 100.0f * 100.0f;  // ops/mindist.py DIST_CAP^2

// shared memory, in floats: each part a multiple of 4, so every float4 lies
// on 16 bytes
constexpr int kActOff = 0;                              // [feature][row]
constexpr int kRingOff = kActOff + kH * kRows;          // 2 x [column][kChunk]
constexpr int kW1Off = kRingOff + 2 * kH * kChunk;      // [column][w (6), b1, 0]
constexpr int kW5Off = kW1Off + kH * 8;                 // [output][feature]
constexpr int kBhOff = kW5Off + kHead * kH;             // b2, b3, b4
constexpr int kB5Off = kBhOff + kHidden * kH;           // b5
constexpr int kZOff = kB5Off + kHead;                   // [input][row]
constexpr int kHoutOff = kZOff + kIn * kRows;           // [output][row]
constexpr int kEpsOff = kHoutOff + kHead * kRows;       // float4 a row: the step's normals
constexpr int kUnOff = kEpsOff + kOut * kRows;          // [row][2]: the next controls
constexpr int kPsOff = kUnOff + kU * kRows;             // [state, path, speed][row]
constexpr int kConstOff = kPsOff + (kS + 2) * kRows;    // mu, sigma, max_logvar, min_logvar
constexpr int kRefOff = kConstOff + 2 * kIn + 2 * kOut; // float4 a window point
constexpr size_t kFixedBytes = static_cast<size_t>(kRefOff) * sizeof(float);
static_assert(kRows % 32 == 0 && kH % (kThreads / 32) == 0 && kH % kChunk == 0 &&
              kChunk % 4 == 0 && kHead == kThreads / 32 && kRows <= kThreads,
              "the thread tiles do not cover the block's rows and columns");
static_assert(kFixedBytes + kMaxRef * 16 <= 232448, "over a block's shared memory");
static_assert(kRefOff % 4 == 0 && kEpsOff % 4 == 0, "a float4 off 16 bytes");

struct Args {
  const float* state;      // (7,) the start state of every sequence
  const float* controls;   // (T-1, K, 2)
  const float* normals;    // (T-1, K·P, 4)
  const float* w1;         // (E, 200, 6)
  const float* b1;         // (E, 200)
  const float* w2;         // (E, 200, 200)
  const float* b2;
  const float* w3;
  const float* b3;
  const float* w4;
  const float* b4;
  const float* w5;         // (E, 8, 200)
  const float* b5;         // (E, 8)
  const float* mu_in;      // (6,)
  const float* sigma_in;   // (6,)
  const float* max_logvar; // (4,)
  const float* min_logvar; // (4,)
  const float* ref_xy;     // (R, 2)
  const float* dt;
  const float* v_ref;
  const float* path_w;
  const float* v_w;
  float* costs;            // (E, K·P/E)
  unsigned long long* evals;   // model.pe_evals, or null
  unsigned long long* fused;   // model.pe_fused, or null
  int k;
  int tm1;
  int num_ref;
};

// clamp(v, 0, DIST_CAP^2) as torch.clamp: a NaN stays NaN.
__device__ __forceinline__ float clamp_cap(float v) {
  v = v < 0.f ? 0.f : v;
  return v > kDistCap2 ? kDistCap2 : v;
}

// min_j |p - ref_j|^2 clamped, over the centred window in shared memory,
// each operation rounded as ops/mindist.py's.
__device__ __forceinline__ float min_sq_distance(const float4* ref, int num_ref, float cx,
                                                 float cy, float x, float y) {
  const float xc = __fsub_rn(x, cx), yc = __fsub_rn(y, cy);
  float m = INFINITY;
#pragma unroll 4
  for (int j = 0; j < num_ref; ++j) {
    const float4 r = ref[j];
    m = fminf(m, __fsub_rn(__fsub_rn(r.z, __fmul_rn(xc, r.x)), __fmul_rn(yc, r.y)));
  }
  return clamp_cap(__fadd_rn(__fadd_rn(__fmul_rn(xc, xc), __fmul_rn(yc, yc)), m));
}

// F.silu as PyTorch's CUDA op rounds it
__device__ __forceinline__ float swish(float x) { return x / (1.0f + expf(-x)); }

// F.softplus (beta 1, threshold 20) as PyTorch's CUDA op rounds it
__device__ __forceinline__ float softplus(float x) {
  return x > 20.0f ? x : log1pf(expf(x));
}

// Weight chunk g (0 ... kHidden·kChunks - 1) of the member's hidden matrices
// into dst, [column][kChunk]: input features (g % kChunks)·kChunk ... of the
// matrix g / kChunks.
__device__ __forceinline__ void fetch_chunk(float* dst, const float* w2, const float* w3,
                                            const float* w4, int g, int tid) {
  const float* w = (g < kChunks ? w2 : (g < 2 * kChunks ? w3 : w4)) + (g % kChunks) * kChunk;
  for (int f = tid; f < kH * kChunk / 4; f += kThreads) {
    const int col = f / (kChunk / 4), q = f % (kChunk / 4);
    PETS_COPY16(dst + col * kChunk + 4 * q, w + static_cast<size_t>(col) * kH + 4 * q);
  }
}

__global__ void __launch_bounds__(kThreads, 1) pets_rollout_kernel(Args a) {
  extern __shared__ float4 s_mem[];
  float* const smem = reinterpret_cast<float*>(s_mem);
  float* const act = smem + kActOff;
  float* const ring = smem + kRingOff;
  float* const w1s = smem + kW1Off;
  float* const w5s = smem + kW5Off;
  float* const bh = smem + kBhOff;
  float* const b5s = smem + kB5Off;
  float* const zs = smem + kZOff;
  float* const hout = smem + kHoutOff;
  float4* const eps4 = reinterpret_cast<float4*>(smem + kEpsOff);
  float* const un = smem + kUnOff;
  float* const ps = smem + kPsOff;
  float* const mu = smem + kConstOff;          // then sigma, max_logvar, min_logvar
  float* const sg = mu + kIn;
  float* const lv_max = sg + kIn;
  float* const lv_min = lv_max + kOut;
  float4* const s_ref = reinterpret_cast<float4*>(smem + kRefOff);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m = a.k * kPer;                     // rows a member
  const int tiles = (m + kRows - 1) / kRows;
  const int e = blockIdx.x / tiles;
  const int first = (blockIdx.x % tiles) * kRows;
  const size_t hh = static_cast<size_t>(kH) * kH;
  const float* const w2 = a.w2 + e * hh;
  const float* const w3 = a.w3 + e * hh;
  const float* const w4 = a.w4 + e * hh;
  const int total_chunks = a.tm1 * kHidden * kChunks;
  if (total_chunks > 0) {
    fetch_chunk(ring, w2, w3, w4, 0, tid);
    PETS_COPY_COMMIT();
  }

  // the member's first layer, head and biases, and the centred window
  for (int i = tid; i < kH * 8; i += kThreads) {
    const int j = i / 8, q = i % 8;
    w1s[i] = q < kIn ? a.w1[(e * kH + j) * kIn + q] : (q == kIn ? a.b1[e * kH + j] : 0.f);
  }
  for (int i = tid; i < kHead * kH; i += kThreads) w5s[i] = a.w5[e * kHead * kH + i];
  for (int i = tid; i < kHidden * kH; i += kThreads) {
    const float* b = i < kH ? a.b2 : (i < 2 * kH ? a.b3 : a.b4);
    bh[i] = b[e * kH + i % kH];
  }
  if (tid < kHead) b5s[tid] = a.b5[e * kHead + tid];
  if (tid < kIn) {
    mu[tid] = a.mu_in[tid];
    sg[tid] = a.sigma_in[tid];
  }
  if (tid < kOut) {
    lv_max[tid] = a.max_logvar[tid];
    lv_min[tid] = a.min_logvar[tid];
  }
  const float cx = a.ref_xy[0], cy = a.ref_xy[1];
  for (int j = tid; j < a.num_ref; j += kThreads) {
    const float rx = __fsub_rn(a.ref_xy[2 * j], cx), ry = __fsub_rn(a.ref_xy[2 * j + 1], cy);
    s_ref[j] = make_float4(2.f * rx, 2.f * ry, __fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry)),
                           0.f);
  }
  __syncthreads();

  // a particle a thread of the first kRows: its states and running cost in
  // shared memory (the registers go to the products' accumulators), its
  // first input
  const bool holder = tid < kRows;
  const int c = min(first + tid, m - 1);
  const int seq = c / kPer;
  const int pidx = seq * kParticles + (c % kPer) * kMembers + e;   // k·P + p
  const float dt = *a.dt, v_ref = *a.v_ref;
  if (holder) {
    float s[kS];
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      s[i] = a.state[i];
      ps[i * kRows + tid] = s[i];
    }
    ps[kS * kRows + tid] = min_sq_distance(s_ref, a.num_ref, cx, cy, s[0], s[1]);
    ps[(kS + 1) * kRows + tid] = 0.f;
    if (a.tm1 > 0) {
      const float* u = a.controls + static_cast<size_t>(seq) * kU;
#pragma unroll
      for (int i = 0; i < kOut; ++i) zs[i * kRows + tid] = (s[3 + i] - mu[i]) / sg[i];
      zs[4 * kRows + tid] = (__ldg(u) - mu[4]) / sg[4];
      zs[5 * kRows + tid] = (__ldg(u + 1) - mu[5]) / sg[5];
    }
  }
  __syncthreads();

  const int col0 = warp * kCols;
  float acc[kRowsPerThread][kCols];
  int n = 0;   // weight chunks consumed
  for (int t = 0; t < a.tm1; ++t) {
    // the step's normals and the next step's controls, copied ahead (the
    // first weight chunk's wait covers them)
    if (holder) {
      PETS_COPY16(eps4 + tid, a.normals + (static_cast<size_t>(t) * a.k * kParticles + pidx) * 4);
      if (t + 1 < a.tm1) {
        PETS_COPY8(un + kU * tid, a.controls + (static_cast<size_t>(t + 1) * a.k + seq) * kU);
      }
      PETS_COPY_COMMIT();
    }

    // the first layer, from the inputs in shared memory
    {
      float z[kIn][kRowsPerThread];
#pragma unroll
      for (int q = 0; q < kIn; ++q) {
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) z[q][i] = zs[q * kRows + lane + 32 * i];
      }
      const float4* w1v = reinterpret_cast<const float4*>(w1s);
#pragma unroll 5
      for (int j = 0; j < kCols; ++j) {
        const float4 wa = w1v[2 * (col0 + j)], wb = w1v[2 * (col0 + j) + 1];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          float h = fmaf(wa.x, z[0][i], 0.f);
          h = fmaf(wa.y, z[1][i], h);
          h = fmaf(wa.z, z[2][i], h);
          h = fmaf(wa.w, z[3][i], h);
          h = fmaf(wb.x, z[4][i], h);
          h = fmaf(wb.y, z[5][i], h);
          act[(col0 + j) * kRows + lane + 32 * i] = swish(__fadd_rn(h, wb.z));
        }
      }
    }

    // the three hidden products, a weight chunk at a time
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
    }
    for (int g = 0; g < kHidden * kChunks; ++g, ++n) {
      PETS_COPY_WAIT();
      __syncthreads();   // chunk n landed; every thread is done with chunk n - 1
      if (n + 1 < total_chunks) {
        fetch_chunk(ring + ((n + 1) & 1) * kH * kChunk, w2, w3, w4,
                    (g + 1) % (kHidden * kChunks), tid);
        PETS_COPY_COMMIT();
      }
      const float4* wc = reinterpret_cast<const float4*>(ring + (n & 1) * kH * kChunk);
      const float* ac = act + (g % kChunks) * kChunk * kRows + lane;
#pragma unroll
      for (int q = 0; q < kChunk / 4; ++q) {
        float av[4][kRowsPerThread];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) av[kk][i] = ac[(4 * q + kk) * kRows + 32 * i];
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const float4 w = wc[(col0 + j) * (kChunk / 4) + q];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) {
            acc[i][j] = fmaf(w.x, av[0][i], acc[i][j]);
            acc[i][j] = fmaf(w.y, av[1][i], acc[i][j]);
            acc[i][j] = fmaf(w.z, av[2][i], acc[i][j]);
            acc[i][j] = fmaf(w.w, av[3][i], acc[i][j]);
          }
        }
      }
      if (g % kChunks == kChunks - 1) {
        // the layer's outputs over its inputs, once every thread has read them
        __syncthreads();
        const float* b = bh + (g / kChunks) * kH + col0;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const float bj = b[j];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) {
            act[(col0 + j) * kRows + lane + 32 * i] = swish(__fadd_rn(acc[i][j], bj));
            acc[i][j] = 0.f;
          }
        }
      }
    }
    __syncthreads();

    // the head: output `warp` of the thread's rows
    {
      float h[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) h[i] = 0.f;
      const float4* w5v = reinterpret_cast<const float4*>(w5s + warp * kH);
      const float* ac = act + lane;
#pragma unroll 5
      for (int q = 0; q < kH / 4; ++q) {
        const float4 w = w5v[q];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          h[i] = fmaf(w.x, ac[(4 * q) * kRows + 32 * i], h[i]);
          h[i] = fmaf(w.y, ac[(4 * q + 1) * kRows + 32 * i], h[i]);
          h[i] = fmaf(w.z, ac[(4 * q + 2) * kRows + 32 * i], h[i]);
          h[i] = fmaf(w.w, ac[(4 * q + 3) * kRows + 32 * i], h[i]);
        }
      }
      const float b = b5s[warp];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        hout[warp * kRows + lane + 32 * i] = __fadd_rn(h[i], b);
    }
    __syncthreads();

    // the particle's step: the bounded log-variance, the sampled change, the
    // kinematics of the old state, the cost's terms of the new one
    if (holder) {
      const float4 e4 = eps4[tid];
      const float ev[kOut] = {e4.x, e4.y, e4.z, e4.w};
      float s[kS];
#pragma unroll
      for (int i = 0; i < kS; ++i) s[i] = ps[i * kRows + tid];
      float dyn[kOut];
#pragma unroll
      for (int i = 0; i < kOut; ++i) {
        float l = hout[(kOut + i) * kRows + tid];
        l = __fsub_rn(lv_max[i], softplus(__fsub_rn(lv_max[i], l)));
        l = __fadd_rn(lv_min[i], softplus(__fsub_rn(l, lv_min[i])));
        dyn[i] = __fadd_rn(__fadd_rn(s[3 + i], hout[i * kRows + tid]),
                           __fmul_rn(expf(__fmul_rn(0.5f, l)), ev[i]));
      }
      const float yaw = s[2], vx = s[4], vy = s[5];
      const float cs = cosf(yaw), sn = sinf(yaw);
      const float d[3] = {__fsub_rn(__fmul_rn(vx, cs), __fmul_rn(vy, sn)),
                          __fadd_rn(__fmul_rn(vx, sn), __fmul_rn(vy, cs)), -s[6]};
#pragma unroll
      for (int i = 0; i < 3; ++i) s[i] = __fadd_rn(s[i], __fmul_rn(d[i], dt));
#pragma unroll
      for (int i = 0; i < kOut; ++i) s[3 + i] = dyn[i];
#pragma unroll
      for (int i = 0; i < kS; ++i) ps[i * kRows + tid] = s[i];
      ps[kS * kRows + tid] = __fadd_rn(ps[kS * kRows + tid],
                                       min_sq_distance(s_ref, a.num_ref, cx, cy, s[0], s[1]));
      const float dv = __fsub_rn(s[4], v_ref);
      ps[(kS + 1) * kRows + tid] = __fadd_rn(ps[(kS + 1) * kRows + tid], __fmul_rn(dv, dv));
      if (t + 1 < a.tm1) {
#pragma unroll
        for (int i = 0; i < kOut; ++i) zs[i * kRows + tid] = (s[3 + i] - mu[i]) / sg[i];
        zs[4 * kRows + tid] = (un[kU * tid] - mu[4]) / sg[4];
        zs[5 * kRows + tid] = (un[kU * tid + 1] - mu[5]) / sg[5];
      }
    }
    __syncthreads();
  }

  if (holder && first + tid < m) {
    a.costs[static_cast<size_t>(e) * m + first + tid] =
        __fadd_rn(__fmul_rn(*a.path_w, ps[kS * kRows + tid]),
                  __fmul_rn(*a.v_w, ps[(kS + 1) * kRows + tid]));
  }
  if (blockIdx.x == 0 && tid == 0) {
    const unsigned long long n_evals = static_cast<unsigned long long>(a.k) * kParticles *
                                       static_cast<unsigned long long>(a.tm1);
    if (a.evals != nullptr) atomicAdd(a.evals, n_evals);
    if (a.fused != nullptr) atomicAdd(a.fused, n_evals);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// --- host side ------------------------------------------------------------------

extern "C" {

int pets_rollout_threads() { return kThreads; }

int pets_rollout_rows() { return kRows; }

int pets_rollout_chunk() { return kChunk; }

int pets_rollout_max_ref() { return kMaxRef; }

// The parameters of the entry point, one letter each: i int, p pointer
// (kernels/pets_rollout.py SIGNATURE, which the binding holds equal to this).
const char* pets_rollout_signature() {
  return "pets_rollout_cost:" "ppppppppppppppppppppppppp" "iiip";
}

const char* pets_rollout_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The raw costs (E, K·P/E) of K sequences' P particles on `stream`, laid out
// as models/pets_pe.py's states_cost returns them: each particle rolled out
// from state (7,) under its sequence's controls (T-1, K, 2) and its normals
// (T-1, K·P, 4), through member e's network (w1 (E, 200, 6), b1 (E, 200),
// w2 ... w4 (E, 200, 200), b2 ... b4 (E, 200), w5 (E, 8, 200), b5 (E, 8)),
// the standardiser mu_in, sigma_in (6,) and the bounds max_logvar,
// min_logvar (4,), scored against the window ref_xy (R, 2) with dt, v_ref,
// path_weight and v_weight one float each; all float32 on the device,
// contiguous, normals and w2 ... w4 on 16 bytes. evals and fused (1 int64
// each) may be null; K·P·(T-1) is added to each. Returns the cudaError_t of
// the launch (0 on success), cudaErrorInvalidValue for K < 1, T-1 < 0, R
// outside [1, kMaxRef], a null operand (controls and normals may be null
// where T-1 is 0) or one off its alignment.
int pets_rollout_cost(const float* state, const float* controls, const float* normals,
                      const float* w1, const float* b1, const float* w2, const float* b2,
                      const float* w3, const float* b3, const float* w4, const float* b4,
                      const float* w5, const float* b5, const float* mu_in,
                      const float* sigma_in, const float* max_logvar,
                      const float* min_logvar, const float* ref_xy, const float* dt,
                      const float* v_ref, const float* path_w, const float* v_w,
                      float* costs, long long* evals, long long* fused, int k, int tm1,
                      int num_ref, void* stream) {
  const void* operands[] = {state, w1, b1, w2, b2, w3, b3, w4, b4, w5, b5, mu_in, sigma_in,
                            max_logvar, min_logvar, ref_xy, dt, v_ref, path_w, v_w, costs};
  for (const void* p : operands) {
    if (p == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (k < 1 || tm1 < 0 || num_ref < 1 || num_ref > kMaxRef ||
      (tm1 > 0 && (controls == nullptr || normals == nullptr || !aligned16(normals))) ||
      !aligned16(w2) || !aligned16(w3) || !aligned16(w4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // above 48 KB a block's shared memory is asked for, once a device
  static bool raised[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= 64 || !raised[device]) {
    err = cudaFuncSetAttribute(pets_rollout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kFixedBytes + kMaxRef * sizeof(float4)));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device >= 0 && device < 64) raised[device] = true;
  }
  Args a = {state, controls, normals, w1, b1, w2, b2, w3, b3, w4, b4, w5, b5, mu_in, sigma_in,
            max_logvar, min_logvar, ref_xy, dt, v_ref, path_w, v_w, costs,
            reinterpret_cast<unsigned long long*>(evals),
            reinterpret_cast<unsigned long long*>(fused), k, tm1, num_ref};
  const int rows = k * kPer;
  const unsigned blocks = static_cast<unsigned>(kMembers * ((rows + kRows - 1) / kRows));
  const size_t smem = kFixedBytes + static_cast<size_t>(num_ref) * sizeof(float4);
  pets_rollout_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
