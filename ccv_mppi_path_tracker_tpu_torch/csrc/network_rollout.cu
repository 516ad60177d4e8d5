// The eager update's rollout and tracking cost over AutoRally's learned
// dynamics (models/autorally_nn.py): every sample's Euler rollout under its
// sampled controls through the 6-32-32-4 tanh network and the kinematic pose
// derivative, and its cost, in one launch, written for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package has no network model, and the
// port's op-by-op version (models/autorally_nn.py rollout, then cost) is
// plain PyTorch. It was added for that version's launch chain: each of the
// T-1 Euler steps was ~25 launches (three skinny float32 GEMMs, tanh,
// concatenations, strided elementwise ops, the distance scan's reductions),
// each streaming a (K, 7) state, a (K, 6) input or a (K, 32) activation
// through HBM, ~780 launches and ~4.6 ms of device time an update at K=102400,
// T=30 for ~9 GFLOP (benchmark/work_nn.py).
//
// What bounds this kernel: instruction issue. A sample's T-1 network
// evaluations are 1344 multiply-adds and 64 precise tanhf each, beside two
// sincosf and a scan of the R window points per state; the only HBM traffic
// is the (T-1, K, 2) controls in and the K costs out (~24 MB at the cell's
// shape, ~7 us at 3.35 TB/s). No tensor-core format keeps the
// configuration's float32 with TF32 off, so the work runs on the CUDA cores.
//
// Design, and what each part does about that:
// - A thread computes kPer = 2 samples, samples b*kPer*kThreads + p*kThreads
//   + tid of block b, so that each weight read from shared memory feeds two
//   samples' multiply-adds: one broadcast LDS.128 a clock an SM would
//   otherwise tie with the four FFMA warp instructions a clock. The loads of
//   the controls are coalesced (neighbouring threads, neighbouring samples).
// - The states and activations stay in registers: a sample's 7 states, its
//   32 first-layer activations, and its 4 outputs. The third layer is folded
//   into the second: after each second-layer unit's tanh its column of W3 is
//   added into the 4 outputs, so the second layer's activations never live
//   together. The mask of a ragged K: a thread past K computes the last
//   sample again and stores nothing.
// - The 1412 weights and biases and the centred reference window go to
//   shared memory once a block, read from the device tensors at every launch
//   (never baked into the launch's arguments), so a CUDA graph's replay sees
//   weights changed in place. Layouts: W1 rows padded to 8 (w, b1, 0), two
//   float4s a unit; W2's row j with b2[j] and W3's column j after it, ten
//   float4s a unit; the window as (2 rc_x, 2 rc_y, |rc|^2, 0) a point.
// - The unit loop of the second layer is unrolled twice, so that each
//   thread has four independent multiply-add chains (two samples, two units)
//   to hide the FFMA latency beside its warp's neighbours on the SM.
// - Blocks of one warp, so that the K/2 threads spread over the 132 SMs in
//   one wave with at most one warp above the mean on any SM; the launch
//   bound keeps the registers at 128 or under, for 16 blocks an SM.
// - Arithmetic: float32 throughout, precise tanhf, sinf and cosf (no
//   fast-math flag, no intrinsic of lower precision), no tensor cores. Each
//   operation is rounded as the op-by-op version rounds it, so that a
//   sample's cost lands within a few units in the last place of that
//   version's (the softmax over K costs at lambda 1 turns a cost's error
//   into the update's): the three layers as cuBLAS's FFMA GEMMs compute
//   them, each dot product one chain of multiply-adds in ascending order
//   from 0 and the bias added after it; everything else one rounding an
//   operation, with __fmul_rn / __fadd_rn / __fsub_rn where nvcc would
//   otherwise contract a product into a sum: the Euler step s + (dt s'),
//   the pose derivative (v_x cos - v_y sin, v_x sin + v_y cos, -yaw_mder),
//   the centred distance scan of ops/mindist.py (c = ref_0; |xc|^2 + min_j
//   ((|rc_j|^2 - xc_x 2 rc_x) - xc_y 2 rc_y), clamped to [0, 100^2]), the
//   speed error's square, and path_weight * path + v_weight * speed. Only
//   the sums over time run in another order (one chain here).
// - Block 0's thread 0 adds K (T-1) to the model.nn_evals and model.nn_fused
//   device counters (utils/profiling.py), where the wrapper passes them.
// The entry point is named without the benchmark's fused-kernel name, whose
// substring its trace reader matches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kS = 7;             // x, y, yaw, roll, v_x, v_y, yaw_mder
constexpr int kU = 2;             // steering, throttle
constexpr int kIn = 6;            // the network's input: roll, v_x, v_y, yaw_mder, u
constexpr int kH = 32;            // both hidden layers
constexpr int kOut = 4;           // roll', v_x', v_y', yaw_mder'
constexpr int kThreads = 32;      // a block: one warp
constexpr int kPer = 2;           // samples a thread
constexpr int kMaxRef = 1024;     // window points (16 B of shared memory each)
constexpr float kDistCap2 = 100.0f * 100.0f;   // ops/mindist.py DIST_CAP^2
constexpr int kW1Row = 2;         // float4s a first-layer unit: w (6), b1, 0
constexpr int kW2Row = 10;        // float4s a second-layer unit: w (32), b2, 0 0 0, W3's column

struct Args {
  const float* state;      // (7,) the start state of every sample
  const float* controls;   // (T-1, K, 2)
  const float* w1;         // (32, 6)
  const float* b1;         // (32,)
  const float* w2;         // (32, 32)
  const float* b2;         // (32,)
  const float* w3;         // (4, 32)
  const float* b3;         // (4,)
  const float* ref_xy;     // (R, 2)
  const float* dt;
  const float* v_ref;
  const float* path_w;
  const float* v_w;
  float* costs;            // (K,)
  unsigned long long* evals;   // model.nn_evals, or null
  unsigned long long* fused;   // model.nn_fused, or null
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

__global__ void __launch_bounds__(kThreads, 16) network_rollout_kernel(Args a) {
  __shared__ float4 s_w1[kH * kW1Row];
  __shared__ float4 s_w2[kH * kW2Row];
  __shared__ float4 s_b3;
  extern __shared__ float4 s_ref[];

  const int tid = threadIdx.x;
  float* w1 = reinterpret_cast<float*>(s_w1);
  for (int e = tid; e < kH * kW1Row * 4; e += kThreads) {
    const int j = e / (kW1Row * 4), i = e % (kW1Row * 4);
    w1[e] = i < kIn ? a.w1[j * kIn + i] : (i == kIn ? a.b1[j] : 0.f);
  }
  float* w2 = reinterpret_cast<float*>(s_w2);
  for (int e = tid; e < kH * kW2Row * 4; e += kThreads) {
    const int j = e / (kW2Row * 4), i = e % (kW2Row * 4);
    float v = 0.f;
    if (i < kH) v = a.w2[j * kH + i];
    else if (i == kH) v = a.b2[j];
    else if (i >= kW2Row * 4 - kOut) v = a.w3[(i - (kW2Row * 4 - kOut)) * kH + j];
    w2[e] = v;
  }
  if (tid < kOut) reinterpret_cast<float*>(&s_b3)[tid] = a.b3[tid];
  const float cx = a.ref_xy[0], cy = a.ref_xy[1];
  for (int j = tid; j < a.num_ref; j += kThreads) {
    const float rx = __fsub_rn(a.ref_xy[2 * j], cx), ry = __fsub_rn(a.ref_xy[2 * j + 1], cy);
    s_ref[j] = make_float4(2.f * rx, 2.f * ry, __fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry)),
                           0.f);
  }
  __syncthreads();

  const float dt = *a.dt, v_ref = *a.v_ref;
  const int first = blockIdx.x * (kThreads * kPer) + tid;
  int kk[kPer];
  float s[kPer][kS];
  float path[kPer], vel[kPer];
  {
    float s0[kS];
#pragma unroll
    for (int i = 0; i < kS; ++i) s0[i] = a.state[i];
    const float d0 = min_sq_distance(s_ref, a.num_ref, cx, cy, s0[0], s0[1]);
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      kk[p] = min(first + p * kThreads, a.k - 1);
#pragma unroll
      for (int i = 0; i < kS; ++i) s[p][i] = s0[i];
      path[p] = d0;
      vel[p] = 0.f;
    }
  }
  const float4 b3 = s_b3;
  const float* u_t = a.controls;
  const size_t step_stride = static_cast<size_t>(a.k) * kU;
  for (int t = 0; t < a.tm1; ++t, u_t += step_stride) {
    // the first layer, from each sample's old state and its controls
    float h[kPer][kH];
    {
      float z[kPer][kIn];
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        z[p][0] = s[p][3];
        z[p][1] = s[p][4];
        z[p][2] = s[p][5];
        z[p][3] = s[p][6];
        z[p][4] = __ldg(u_t + kU * kk[p]);
        z[p][5] = __ldg(u_t + kU * kk[p] + 1);
      }
#pragma unroll
      for (int j = 0; j < kH; ++j) {
        const float4 wa = s_w1[j * kW1Row], wb = s_w1[j * kW1Row + 1];
#pragma unroll
        for (int p = 0; p < kPer; ++p) {
          float acc = fmaf(wa.x, z[p][0], 0.f);
          acc = fmaf(wa.y, z[p][1], acc);
          acc = fmaf(wa.z, z[p][2], acc);
          acc = fmaf(wa.w, z[p][3], acc);
          acc = fmaf(wb.x, z[p][4], acc);
          acc = fmaf(wb.y, z[p][5], acc);
          h[p][j] = tanhf(__fadd_rn(acc, wb.z));
        }
      }
    }
    // the second layer, each unit's tanh folded into the outputs by W3's column
    float o[kPer][kOut];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
#pragma unroll
      for (int i = 0; i < kOut; ++i) o[p][i] = 0.f;
    }
#pragma unroll 2
    for (int j = 0; j < kH; ++j) {
      const float4* row = s_w2 + j * kW2Row;
      float acc[kPer];
#pragma unroll
      for (int p = 0; p < kPer; ++p) acc[p] = 0.f;
#pragma unroll
      for (int q = 0; q < kH / 4; ++q) {
        const float4 w = row[q];
#pragma unroll
        for (int p = 0; p < kPer; ++p) {
          acc[p] = fmaf(w.x, h[p][4 * q], acc[p]);
          acc[p] = fmaf(w.y, h[p][4 * q + 1], acc[p]);
          acc[p] = fmaf(w.z, h[p][4 * q + 2], acc[p]);
          acc[p] = fmaf(w.w, h[p][4 * q + 3], acc[p]);
        }
      }
      const float b2 = row[kH / 4].x;
      const float4 c3 = row[kW2Row - 1];   // W3[:, j]
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        const float g = tanhf(__fadd_rn(acc[p], b2));
        o[p][0] = fmaf(c3.x, g, o[p][0]);
        o[p][1] = fmaf(c3.y, g, o[p][1]);
        o[p][2] = fmaf(c3.z, g, o[p][2]);
        o[p][3] = fmaf(c3.w, g, o[p][3]);
      }
    }
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      o[p][0] = __fadd_rn(o[p][0], b3.x);
      o[p][1] = __fadd_rn(o[p][1], b3.y);
      o[p][2] = __fadd_rn(o[p][2], b3.z);
      o[p][3] = __fadd_rn(o[p][3], b3.w);
    }
    // the kinematics, the Euler step, the cost's terms of the new state
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const float yaw = s[p][2], vx = s[p][4], vy = s[p][5];
      const float cs = cosf(yaw), sn = sinf(yaw);
      const float d[kS] = {__fsub_rn(__fmul_rn(vx, cs), __fmul_rn(vy, sn)),
                           __fadd_rn(__fmul_rn(vx, sn), __fmul_rn(vy, cs)),
                           -s[p][6], o[p][0], o[p][1], o[p][2], o[p][3]};
#pragma unroll
      for (int i = 0; i < kS; ++i) s[p][i] = __fadd_rn(s[p][i], __fmul_rn(d[i], dt));
      path[p] += min_sq_distance(s_ref, a.num_ref, cx, cy, s[p][0], s[p][1]);
      const float dv = __fsub_rn(s[p][4], v_ref);
      vel[p] = __fadd_rn(vel[p], __fmul_rn(dv, dv));
    }
  }
  const float pw = *a.path_w, vw = *a.v_w;
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int k = first + p * kThreads;
    if (k < a.k) a.costs[k] = __fadd_rn(__fmul_rn(pw, path[p]), __fmul_rn(vw, vel[p]));
  }
  if (blockIdx.x == 0 && tid == 0) {
    const unsigned long long n =
        static_cast<unsigned long long>(a.k) * static_cast<unsigned long long>(a.tm1);
    if (a.evals != nullptr) atomicAdd(a.evals, n);
    if (a.fused != nullptr) atomicAdd(a.fused, n);
  }
}

}  // namespace

// --- host side ------------------------------------------------------------------

extern "C" {

int network_rollout_threads() { return kThreads; }

int network_rollout_samples_per_thread() { return kPer; }

int network_rollout_max_ref() { return kMaxRef; }

// The parameters of the entry point, one letter each: i int, p pointer
// (kernels/network_rollout.py SIGNATURE, which the binding holds equal to
// this).
const char* network_rollout_signature() {
  return "network_rollout_cost:" "pppppppppppppppp" "iiip";
}

const char* network_rollout_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The costs (K,) of K samples on `stream`: each the Euler rollout of the
// network model from `state` (7,) under its controls, controls (T-1, K, 2),
// with the weights w1 (32, 6), b1 (32,), w2 (32, 32), b2 (32,), w3 (4, 32),
// b3 (4,), scored against the window ref_xy (R, 2) with dt, v_ref,
// path_weight and v_weight one float each; all float32 on the device,
// contiguous. evals and fused (1 int64 each) may be null; K (T-1) is added
// to each. Returns the cudaError_t of the launch (0 on success),
// cudaErrorInvalidValue for K < 1, T-1 < 0, R outside [1, kMaxRef] or a null
// operand (controls may be null where T-1 is 0).
int network_rollout_cost(const float* state, const float* controls, const float* w1,
                         const float* b1, const float* w2, const float* b2, const float* w3,
                         const float* b3, const float* ref_xy, const float* dt,
                         const float* v_ref, const float* path_w, const float* v_w,
                         float* costs, long long* evals, long long* fused, int k, int tm1,
                         int num_ref, void* stream) {
  const void* operands[] = {state, w1, b1, w2, b2, w3, b3, ref_xy, dt, v_ref, path_w, v_w,
                            costs};
  for (const void* p : operands) {
    if (p == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (k < 1 || tm1 < 0 || num_ref < 1 || num_ref > kMaxRef || (tm1 > 0 && controls == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a = {state, controls, w1, b1, w2, b2, w3, b3, ref_xy, dt, v_ref, path_w, v_w, costs,
            reinterpret_cast<unsigned long long*>(evals),
            reinterpret_cast<unsigned long long*>(fused), k, tm1, num_ref};
  const int per_block = kThreads * kPer;
  const unsigned blocks = static_cast<unsigned>((k + per_block - 1) / per_block);
  const size_t smem = static_cast<size_t>(num_ref) * sizeof(float4);
  network_rollout_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
