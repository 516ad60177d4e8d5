// The refine stage of the Gauss-Newton-refined full-body update: the
// num_steps Levenberg-Marquardt-guarded Gauss-Newton steps of one robot's
// control sequence in one launch, written for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's refinement
// (ccv_mppi_path_tracker_tpu/diff/gradients.py gauss_newton_refine) is plain
// JAX, and so is the port's op-by-op version (diff/gradients.py
// gauss_newton_refine_plain). It was added for that version's launch chain:
// on the card a refined update ran about 1650 small launches after the fused
// kernel (forward-mode AD over 145 tangents, matmuls, cholesky_ex,
// cholesky_solve, torch.where), 2.5 ms of device time for 23.6 MFLOP of work
// (benchmark/work_refine.py), so latency, not arithmetic, bounded it.
//
// What bounds this kernel: the serial chains of a small dense problem on one
// SM, and the barriers between its phases. At T=30, U=5 the unknowns are
// n = 145 and the residuals m = 141; a step is a Jacobian, J^T J (about 0.5
// MFLOP once the zeros of causality are skipped), a 145x145 Cholesky
// factorization (1 MFLOP, but 145 dependent pivots), a triangular solve and
// one evaluation. One block cannot spread that over the card's 132 SMs, and
// no tensor-core format keeps the configuration's float32, so the least time
// is set by the dependent chains and the block's barriers, not by the FP32
// rate or by bytes.
//
// Design, and what each part does about that:
// - One block of kThreads threads a robot (grid 1 here), everything in
//   dynamic shared memory: J (m x np, np = n rounded up to kTile), A = J^T J +
//   lambda I (np x np, row stride np + 4 so that the rows of a tile fall on
//   distinct banks) with the right-hand side J^T r as one more row, the
//   inverses of the factor's diagonal blocks, the vectors, two sets of the
//   primal quantities and the centred reference window. About 218 KB at T=30
//   (gauss_newton_smem_bytes); the wrapper refuses a shape that does not fit
//   the 227 KB a block may take.
// - Every value that varies between CUDA-graph replays (the sampled update,
//   the pose, the window, dt, the box, the weights, v_ref, the body
//   parameters) is read from device memory; num_steps, damping and the shapes
//   are launch constants.
// - Evaluation: the closed-form full-body rollout (prefix sums on a few
//   lanes) and the residuals of diff/gradients.py _batched_residuals in its
//   row order (path distance, velocity error, lateral ZMP, roll-rate change,
//   min(v, 0), initial yaw, each times the square root of its weight), each
//   operation rounded as the op-by-op version rounds it (no contraction into
//   FMAs). Beside each row it keeps the parts of the row's tangents that do
//   not depend on the direction, with the op-by-op version's derivative
//   rules: amin's tangent averaged over tied minima, clamp passing the tangent
//   on [0, DIST_CAP^2] bounds included, the distance sqrt(d^2 + 1e-12), and
//   the ZMP row's tangent along roll_v and pitch_v at every earlier time. The
//   trial point's primal goes to the second set, so a rejected step leaves
//   the current point's in place: only the first step evaluates it.
// - The Jacobian by forward mode, one tangent direction a thread's work item
//   (its path rows, or its other rows), over the shared primal; min(v, 0)'s
//   tangent is 1/2 at v = 0. Entries that causality or the residuals'
//   structure make zero are zeroed once and never written. Each item adds its
//   share of J^T r.
// - J^T J in float32 FMAs on the CUDA cores (no TF32, no bf16): the lower
//   kTile x kTile blocks only, an 8x8 register tile a thread from float4
//   reads of J, over the rows of each residual kind at which both blocks'
//   columns can be nonzero.
// - The Cholesky factorization by panels of kTile columns, two barriers a
//   panel: warp 0 inverts the panel's diagonal factor while the other warps
//   solve the panel below it, the right-hand side's row included (so the
//   forward solve L y = J^T r falls out of the factorization); then warp 0
//   updates and factors the next diagonal block (by halves: one lane factors
//   each kH x kH half in registers, kH lanes solve the off-diagonal half)
//   while the other warps update the rest of the trailing matrix (4x4
//   register tiles). A non-positive or NaN pivot marks the step as failed: it
//   is rejected, and nothing indexes by a value, so it cannot fault.
// - The back substitution L^T delta = y by blocks: a thread owns a row, the
//   diagonal blocks are applied through their inverses, one barrier a block.
// - The trial point u - delta clamped to the box (NaN kept, as torch.clamp
//   keeps it), its residuals and its cost; the accept is cost_new < cost,
//   strict, and no failed factorization; lambda is halved on an accept and
//   multiplied by 10 on a reject, from `damping` at each launch.
// - Thread 0 adds the steps and the accepts to the refine.lm_steps /
//   refine.lm_accepted device counters and the steps to refine.fused_steps
//   (utils/profiling.py), where the wrapper passes them.
// The entry point is named without the benchmark's fused-kernel name, whose
// substring its trace reader matches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kU = 5;              // full_body's controls: v, w, direction, roll_v, pitch_v
constexpr int kS = 5;              // and states: x, y, yaw, roll, pitch
constexpr int kThreads = 256;
constexpr int kTile = 16;          // the blocks of J^T J, the Cholesky panels, the solves
constexpr int kH = kTile / 2;      // the halves of a diagonal block's factor
constexpr int kMaxSmem = 232448;   // what a block may take on sm_90 (227 KB)
constexpr int kMaxDevices = 64;
constexpr float kDistCap2 = 100.0f * 100.0f;   // ops/mindist.py DIST_CAP^2
constexpr float kEps = 1e-12f;                 // smooths sqrt(d^2) at d = 0

// Per-time arrays (each of round4(T) floats), in this order.
enum {
  TV_YAW, TV_ROLL, TV_PITCH, TV_X, TV_Y,             // states, t < T
  TV_CH, TV_SH, TV_RX, TV_RY,                         // cos/sin of heading, rates, t < T-1
  TV_GX, TV_GY,                                       // path rows' tangent, t < T-2
  TV_CD, TV_SD, TV_DA, TV_AC, TV_BY, TV_HG,           // ZMP rows, t < T-2
  TV_CR, TV_SR, TV_CP, TV_SP, TV_COMZ, TV_Z3, TV_Z4,
  TV_COUNT
};

// Scalar slots.
enum {
  S_DT, S_SW_PATH, S_SW_V, S_SW_ZMP, S_SW_ROLL, S_SW_BACK, S_SW_YAW, S_VREF,
  S_NEG_M, S_C, S_NEG_C, S_IXX_DT, S_BZ, S_INV_DT, S_INV_BZ, S_YAWREF0, S_CX, S_CY,
  S_COST, S_COST_NEW,
  S_STATE,                     // kS slots
  S_LO = S_STATE + kS,         // kU slots
  S_HI = S_LO + kU,            // kU slots
  S_FAIL = S_HI + kU,          // int
  S_ACCEPT,                    // int
  S_COUNT
};
constexpr int kScalars = (S_COUNT + 3) / 4 * 4;

__host__ __device__ inline int round_up(int x, int to) { return (x + to - 1) / to * to; }

// The shared-memory plan of one launch: sizes and float offsets.
struct Plan {
  int R, tm1, tm2, n, np, lda, m, nb, tp;
  int A, J, Dinv, rd, u, un, g, y, d, r, rn, tv, ref, sc, floats;
};

__host__ __device__ inline Plan make_plan(int horizon, int num_ref) {
  Plan p;
  p.R = num_ref;
  p.tm1 = horizon - 1;
  p.tm2 = horizon - 2;
  p.n = p.tm1 * kU;
  p.np = round_up(p.n, kTile);
  p.lda = p.np + 4;
  p.m = 5 * p.tm2 + 1;
  p.nb = p.np / kTile;
  p.tp = round_up(horizon, 4);
  const int mp = round_up(p.m, 4);
  const int rp = round_up(num_ref, 4);
  int at = 0;
  p.A = at;    at += (p.np + 1) * p.lda;   // and below it the right-hand side's row
  p.J = at;    at += p.m * p.np;
  p.Dinv = at; at += p.nb * kTile * kTile;
  p.rd = at;   at += p.np;
  p.u = at;    at += p.np;
  p.un = at;   at += p.np;
  p.g = at;    at += p.np;
  p.y = at;    at += p.np;
  p.d = at;    at += p.np;
  p.r = at;    at += mp;
  p.rn = at;   at += mp;
  p.tv = at;   at += 2 * TV_COUNT * p.tp;   // the current point's and the trial's
  p.ref = at;  at += 3 * rp;
  p.sc = at;   at += kScalars;
  p.floats = at;
  return p;
}

// Argument block of the kernel.
struct Args {
  const float *u, *state, *ref_xy, *ref_yaw, *dt, *u_min, *u_max;
  const float *v_ref, *path_w, *v_w, *zmp_w, *roll_v_w, *back_w, *yaw_w;
  const float *mass, *base2com, *inertia, *gravity_z;
  float* u_out;
  unsigned long long* counts;   // [steps, accepted] or null
  unsigned long long* fused;    // [fused steps] or null
  int horizon, num_ref, num_steps;
  float damping;
};

// Roundings of the op-by-op version: one operation, one rounding.
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }

// One candidate of the centred distance scan (ops/mindist.py):
// (|rc_j|^2 - xc0 * 2 rc_j0) - xc1 * 2 rc_j1.
__device__ __forceinline__ float scan_term(const float* ref, int rp, int j, float xc0,
                                           float xc1) {
  return fsub(fsub(ref[2 * rp + j], fmul(xc0, ref[j])), fmul(xc1, ref[rp + j]));
}

// torch.clamp: NaN stays NaN.
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// The lateral ZMP row t's tangent along the direction of control (s, j),
// with the op-by-op version's derivative rules, times the row's weight.
__device__ __forceinline__ float zmp_tangent(const float* sc, const float* tv, int tp,
                                             const float* uv, int t, int s, int j) {
  const float dt = sc[S_DT];
  const bool here = s == t, next = s == t + 1;
  const float droll = (j == 3 && s < t) ? dt : 0.f;
  const float dpitch = (j == 4 && s < t) ? dt : 0.f;
  const float cr = tv[TV_CR * tp + t], sr = tv[TV_SR * tp + t];
  const float cp = tv[TV_CP * tp + t], sp = tv[TV_SP * tp + t];
  const float c = sc[S_C];
  const float dcomy = fmul(fmul(droll, cr), sc[S_NEG_C]);
  const float dcomz = fadd(fmul(fmul(fmul(dpitch, -sp), c), cr),
                           fmul(fmul(droll, -sr), fmul(c, cp)));
  const float dv0 = (j == 0 && here) ? 1.f : 0.f, dv1 = (j == 0 && next) ? 1.f : 0.f;
  const float dw = (j == 1 && here) ? 1.f : 0.f, ddir = (j == 2 && here) ? 1.f : 0.f;
  const float dr0 = (j == 3 && here) ? 1.f : 0.f, dr1 = (j == 3 && next) ? 1.f : 0.f;
  const float v_t = uv[t * kU], w_t = uv[t * kU + 1];
  const float cd = tv[TV_CD * tp + t], sd = tv[TV_SD * tp + t];
  const float dda = fmul(fsub(dv1, dv0), sc[S_INV_DT]);
  const float dac = fadd(fmul(dv0, w_t), fmul(dw, v_t));
  const float day = fadd(fadd(fmul(dda, sd), fmul(fmul(ddir, cd), tv[TV_DA * tp + t])),
                         fadd(fmul(dac, cd), fmul(fmul(ddir, -sd), tv[TV_AC * tp + t])));
  const float dby = fmul(sc[S_NEG_M], day);
  const float dhg = fmul(fsub(dr1, dr0), sc[S_IXX_DT]);
  const float dmox = fsub(fsub(fmul(dcomy, sc[S_BZ]), fadd(fmul(dcomz, tv[TV_BY * tp + t]),
                                                           fmul(dby, tv[TV_COMZ * tp + t]))),
                          dhg);
  return fmul(fmul(dmox, sc[S_INV_BZ]), sc[S_SW_ZMP]);
}

// The residuals of the sequence uv (tm1 x kU) into rv, its cost into
// *cost, and the primal quantities the Jacobian reads into the per-time
// arrays. Five barriers; every thread calls it.
__device__ void evaluate(const Plan& P, float* sm, const float* uv, float* rv, float* cost,
                         float* tv) {
  const int tid = threadIdx.x;
  const int tm1 = P.tm1, tm2 = P.tm2, tp = P.tp;
  const float* sc = sm + P.sc;
  float* yaw = tv + TV_YAW * tp;
  float* roll = tv + TV_ROLL * tp;
  float* pitch = tv + TV_PITCH * tp;
  float* xs = tv + TV_X * tp;
  float* ys = tv + TV_Y * tp;
  float* ch = tv + TV_CH * tp;
  float* sh = tv + TV_SH * tp;
  float* rx = tv + TV_RX * tp;
  float* ry = tv + TV_RY * tp;
  const float dt = sc[S_DT];

  // (1) yaw's prefix sum on thread 0; the rows that read the controls alone,
  // and the ZMP terms of the base's acceleration, on the other warps
  if (tid == 0) {
    const float yaw0 = sc[S_STATE + 2];
    float cs = 0.f;
    yaw[0] = fadd(yaw0, 0.f);
#pragma unroll 8
    for (int t = 1; t <= tm1; ++t) {
      cs = fadd(cs, uv[(t - 1) * kU + 1]);
      yaw[t] = fadd(yaw0, fmul(cs, dt));
    }
  }
  for (int t = tid - 32; t >= 0 && t < tm2; t += kThreads - 32) {
    const float v0 = uv[t * kU], v1 = uv[(t + 1) * kU], w0 = uv[t * kU + 1];
    const float dir = uv[t * kU + 2], rv0 = uv[t * kU + 3], rv1 = uv[(t + 1) * kU + 3];
    rv[tm2 + t] = fmul(sc[S_SW_V], fsub(v0, sc[S_VREF]));
    rv[3 * tm2 + t] = fmul(sc[S_SW_ROLL], fsub(rv1, rv0));
    const float back = (v0 < 0.f || v0 != v0) ? v0 : 0.f;   // torch.minimum(v, 0)
    rv[4 * tm2 + t] = fmul(sc[S_SW_BACK], back);
    const float da = fdiv(fsub(v1, v0), dt);
    const float ac = fmul(v0, w0);
    const float cd = cosf(dir), sd = sinf(dir);
    const float ay = fadd(fmul(da, sd), fmul(ac, cd));
    tv[TV_DA * tp + t] = da;
    tv[TV_AC * tp + t] = ac;
    tv[TV_CD * tp + t] = cd;
    tv[TV_SD * tp + t] = sd;
    tv[TV_BY * tp + t] = fmul(sc[S_NEG_M], ay);
    tv[TV_HG * tp + t] = fmul(fsub(rv1, rv0), sc[S_IXX_DT]);
    if (t == 0) {
      rv[5 * tm2] = fmul(sc[S_SW_YAW], fsub(fadd(sc[S_STATE + 2], 0.f), sc[S_YAWREF0]));
    }
  }
  __syncthreads();

  // (2) headings and the position rates
  for (int t = tid; t < tm1; t += kThreads) {
    const float h = fadd(yaw[t], uv[t * kU + 2]);
    const float c = cosf(h), s = sinf(h), v = uv[t * kU];
    ch[t] = c;
    sh[t] = s;
    rx[t] = fmul(v, c);
    ry[t] = fmul(v, s);
  }
  __syncthreads();

  // (3) the prefix sums of x, y, roll and pitch, one lane each
  if (tid < 4) {
    const float* rate = tid == 0 ? rx : tid == 1 ? ry : uv + (tid == 2 ? 3 : 4);
    const int stride = tid < 2 ? 1 : kU;
    float* out = tid == 0 ? xs : tid == 1 ? ys : tid == 2 ? roll : pitch;
    const float s0 = sc[S_STATE + (tid < 2 ? tid : tid + 1)];
    float cs = 0.f;
    out[0] = fadd(s0, 0.f);
#pragma unroll 8
    for (int t = 1; t <= tm1; ++t) {
      cs = fadd(cs, rate[(t - 1) * stride]);
      out[t] = fadd(s0, fmul(cs, dt));
    }
  }
  __syncthreads();

  // (4) the path rows on the first warp, the ZMP rows on the others; beside
  // each row the parts of its tangents that do not depend on the direction:
  // a path row's tangent is Gx dx + Gy dy along a position tangent (dx, dy),
  // with amin's tangent averaged over tied minima and clamp passing it on
  // [0, DIST_CAP^2]; the ZMP row of time t moves alike with roll_v at every
  // s < t (Z3) and with pitch_v at every s < t (Z4)
  const float* ref = sm + P.ref;
  const int rp = round_up(P.R, 4);
  for (int t = tid; t < tm2 && tid < 32; t += 32) {
    const float xc0 = fsub(xs[t], sc[S_CX]), xc1 = fsub(ys[t], sc[S_CY]);
    const float pn = fadd(fmul(xc0, xc0), fmul(xc1, xc1));
    float mn = INFINITY;
    int c = 0, a = 0;
    bool nan = false;
#pragma unroll 4
    for (int j = 0; j < P.R; ++j) {
      const float v = scan_term(ref, rp, j, xc0, xc1);
      if (v < mn) {
        mn = v;
        c = 1;
        a = j;
      } else if (v == mn) {
        ++c;
      }
      nan |= v != v;
    }
    if (nan) mn = NAN;   // torch.amin propagates NaN
    const float raw = fadd(pn, mn);
    const float d = __fsqrt_rn(fadd(clamp_nan(raw, 0.f, kDistCap2), kEps));
    rv[t] = fmul(sc[S_SW_PATH], d);
    float ax = ref[a], ay = ref[rp + a];   // 2 (ref - c) at the minimum, or their mean
    if (c > 1) {
      ax = 0.f;
      ay = 0.f;
      for (int j = 0; j < P.R; ++j) {
        if (scan_term(ref, rp, j, xc0, xc1) == mn) {
          ax = fadd(ax, ref[j]);
          ay = fadd(ay, ref[rp + j]);
        }
      }
      ax = fdiv(ax, static_cast<float>(c));
      ay = fdiv(ay, static_cast<float>(c));
    }
    const bool pass = raw >= 0.f && raw <= kDistCap2;
    const float w = pass ? fmul(fdiv(1.f, fmul(2.f, d)), sc[S_SW_PATH]) : 0.f;
    tv[TV_GX * tp + t] = fmul(w, fsub(fmul(2.f, xc0), ax));
    tv[TV_GY * tp + t] = fmul(w, fsub(fmul(2.f, xc1), ay));
  }
  for (int t = tid - 32; t >= 0 && t < tm2; t += kThreads - 32) {
    const float rl = roll[t], pt = pitch[t];
    const float cr = cosf(rl), sr = sinf(rl), cp = cosf(pt), sp = sinf(pt);
    const float comy = fmul(sc[S_NEG_C], sr);
    const float comz = fmul(fmul(sc[S_C], cp), cr);
    const float bz = sc[S_BZ];
    const float mox = fsub(fsub(fmul(comy, bz), fmul(comz, tv[TV_BY * tp + t])),
                           tv[TV_HG * tp + t]);
    rv[2 * tm2 + t] = fmul(sc[S_SW_ZMP], fdiv(mox, bz));
    tv[TV_CR * tp + t] = cr;
    tv[TV_SR * tp + t] = sr;
    tv[TV_CP * tp + t] = cp;
    tv[TV_SP * tp + t] = sp;
    tv[TV_COMZ * tp + t] = comz;
    tv[TV_Z3 * tp + t] = t >= 1 ? zmp_tangent(sc, tv, tp, uv, t, t - 1, 3) : 0.f;
    tv[TV_Z4 * tp + t] = t >= 1 ? zmp_tangent(sc, tv, tp, uv, t, t - 1, 4) : 0.f;
  }
  __syncthreads();

  // (5) the cost, the sum of squares, on the first warp
  if (tid < 32) {
    float s = 0.f;
    for (int i = tid; i < P.m; i += 32) s = fadd(s, fmul(rv[i], rv[i]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s = fadd(s, __shfl_xor_sync(0xffffffffu, s, o));
    if (tid == 0) *cost = s;
  }
  __syncthreads();
}

// J's entries of the direction of control (s, j), k = s * kU + j, at the
// point evaluate() last saw; each a thread's work item. Rows that causality
// or the residuals' structure make zero are zeroed once and not written:
// the path distance of time t moves with v, w and the direction at s < t;
// the velocity error and min(v, 0) of time s with v at s; the ZMP with v at
// s and s + 1, w and the direction at s, roll_v at s and s + 1 and through
// the roll at s < t, pitch_v through the pitch at s < t; the roll-rate change
// of times s - 1 and s with roll_v at s.
// path != 0: the path rows of a direction with j < 3, its share of J^T r
// into y[k]; else the other rows, their share into g[k].
__device__ void jacobian_item(const Plan& P, float* sm, const float* uv, const float* rv,
                              const float* tv, int k, bool path) {
  const int tm2 = P.tm2, tp = P.tp, np = P.np;
  const int s = k / kU, j = k % kU;
  const float* sc = sm + P.sc;
  float* J = sm + P.J;
  float gk = 0.f;
  if (path) {
    const float* ch = tv + TV_CH * tp;
    const float* sh = tv + TV_SH * tp;
    const float* gx = tv + TV_GX * tp;
    const float* gy = tv + TV_GY * tp;
    const float dt = sc[S_DT];
    // the prefix sums of the position rates' tangents from time s + 1 on: v
    // and the direction move the rate at s only, w the heading after s
    const float v_s = uv[s * kU];
    float cx = j == 0 ? ch[s] : j == 2 ? fmul(-sh[s], v_s) : 0.f;
    float cy = j == 0 ? sh[s] : j == 2 ? fmul(ch[s], v_s) : 0.f;
    for (int t = s + 1; t < tm2; ++t) {
      const float jp = fadd(fmul(gx[t], fmul(cx, dt)), fmul(gy[t], fmul(cy, dt)));
      J[t * np + k] = jp;
      gk = fmaf(jp, rv[t], gk);
      if (j == 1) {
        const float v_t = uv[t * kU];
        cx = fadd(cx, fmul(fmul(dt, -sh[t]), v_t));
        cy = fadd(cy, fmul(fmul(dt, ch[t]), v_t));
      }
    }
    sm[P.y + k] = gk;
    return;
  }
  if (j == 0 && s < tm2) {   // velocity error and min(v, 0)
    const float v_s = uv[s * kU];
    const float slope = v_s == 0.f ? 0.5f : (v_s < 0.f ? 1.f : 0.f);
    const float jv = sc[S_SW_V], jb = fmul(slope, sc[S_SW_BACK]);
    J[(tm2 + s) * np + k] = jv;
    J[(4 * tm2 + s) * np + k] = jb;
    gk += jv * rv[tm2 + s] + jb * rv[4 * tm2 + s];
  }
  if (j == 3) {              // roll-rate change
    if (s >= 1 && s - 1 < tm2) {
      J[(3 * tm2 + s - 1) * np + k] = sc[S_SW_ROLL];
      gk += sc[S_SW_ROLL] * rv[3 * tm2 + s - 1];
    }
    if (s < tm2) {
      J[(3 * tm2 + s) * np + k] = -sc[S_SW_ROLL];
      gk += -sc[S_SW_ROLL] * rv[3 * tm2 + s];
    }
  }
  // the lateral ZMP at times s - 1 and s (v, w, the direction, roll_v), and
  // after s through the roll (Z3) or the pitch (Z4)
  if (j < 4) {
    for (int t = max(s - 1, 0); t < min(s + 1, tm2); ++t) {
      const float jz = zmp_tangent(sc, tv, tp, uv, t, s, j);
      J[(2 * tm2 + t) * np + k] = jz;
      gk += jz * rv[2 * tm2 + t];
    }
  }
  if (j >= 3) {
    const float* z = tv + (j == 3 ? TV_Z3 : TV_Z4) * tp;
    for (int t = s + 1; t < tm2; ++t) {
      J[(2 * tm2 + t) * np + k] = z[t];
      gk = fmaf(z[t], rv[2 * tm2 + t], gk);
    }
  }
  sm[P.g + k] = gk;
}

// A = J^T J + lambda I on the lower kTile x kTile blocks; the padded
// unknowns get 1 on the diagonal. Four threads a block, an 8 x 8 register
// tile each (the upper right one of a diagonal block skipped), the blocks in
// order so that a warp's blocks take about as many rows.
__device__ void normal_matrix(const Plan& P, float* sm, float lam) {
  const int tid = threadIdx.x;
  const int np = P.np, lda = P.lda, tm2 = P.tm2;
  const float* J = sm + P.J;
  float* A = sm + P.A;
  const int units = 2 * P.nb * (P.nb + 1);
  for (int w = tid; w < units; w += kThreads) {
    const int q = w >> 2, a = (w >> 1) & 1, b = w & 1;
    int I = 0;
    while ((I + 1) * (I + 2) / 2 <= q) ++I;
    const int Jb = q - I * (I + 1) / 2;
    if (I == Jb && b > a) continue;
    // the rows of each kind at which both blocks' columns can be nonzero,
    // from the times s of the blocks' controls (I >= Jb): the path distance
    // at t > s, the velocity error and min(v, 0) at t = s, the ZMP at
    // t >= s - 1, the roll-rate change at t = s - 1 and t = s
    const int sI0 = kTile * I / kU, sJ0 = kTile * Jb / kU;
    const int sI1 = (kTile * I + kTile - 1) / kU, sJ1 = (kTile * Jb + kTile - 1) / kU;
    const int both0 = max(sI0, sJ0), both1 = min(sI1, sJ1) + 1;
    const int lo[5] = {sI0 + 1, both0, sI0 - 1, both0 - 1, both0};
    const int hi[5] = {tm2, both1, tm2, both1, both1};
    const int ci = kTile * I + 8 * a, cj = kTile * Jb + 8 * b;
    float acc[8][8];
#pragma unroll
    for (int x = 0; x < 8; ++x)
#pragma unroll
      for (int y = 0; y < 8; ++y) acc[x][y] = 0.f;
#pragma unroll
    for (int kind = 0; kind < 5; ++kind) {
      const int t1 = min(hi[kind], tm2);
      for (int t = max(lo[kind], 0); t < t1; ++t) {
        const float* row = J + (kind * tm2 + t) * np;
        const float4 i0 = *reinterpret_cast<const float4*>(row + ci);
        const float4 i1 = *reinterpret_cast<const float4*>(row + ci + 4);
        const float4 j0 = *reinterpret_cast<const float4*>(row + cj);
        const float4 j1 = *reinterpret_cast<const float4*>(row + cj + 4);
        const float vi[8] = {i0.x, i0.y, i0.z, i0.w, i1.x, i1.y, i1.z, i1.w};
        const float vj[8] = {j0.x, j0.y, j0.z, j0.w, j1.x, j1.y, j1.z, j1.w};
#pragma unroll
        for (int x = 0; x < 8; ++x)
#pragma unroll
          for (int y = 0; y < 8; ++y) acc[x][y] = fmaf(vi[x], vj[y], acc[x][y]);
      }
    }
#pragma unroll
    for (int x = 0; x < 8; ++x)
#pragma unroll
      for (int y = 0; y < 8; ++y) {
        const int i = ci + x, jj = cj + y;
        float v = acc[x][y];
        if (i == jj) v = i < P.n ? fadd(v, lam) : 1.f;
        A[i * lda + jj] = v;
      }
  }
}

// The factor of a kH x kH diagonal block H (lower, row stride lda) in place
// by one thread, the block's lower triangle in its registers: the pivots'
// chain then waits on no shuffle or barrier. The pivots' reciprocal square
// roots into rd; a pivot that is not > 0 sets the fail flag.
__device__ __forceinline__ void factor_half(float* H, int lda, float* rd, int* flags) {
  float m[kH][kH];
#pragma unroll
  for (int i = 0; i < kH; ++i)
#pragma unroll
    for (int c = 0; c < kH; ++c)
      if (c <= i) m[i][c] = H[i * lda + c];
  bool ok = true;
#pragma unroll
  for (int c = 0; c < kH; ++c) {
    const float piv = m[c][c];
    const float r = rsqrtf(piv);
    ok = ok && piv > 0.f;
    rd[c] = r;
    m[c][c] = piv * r;
#pragma unroll
    for (int i = c + 1; i < kH; ++i) m[i][c] *= r;
#pragma unroll
    for (int j = c + 1; j < kH; ++j)
#pragma unroll
      for (int i = j; i < kH; ++i) m[i][j] = fmaf(-m[i][c], m[j][c], m[i][j]);
  }
#pragma unroll
  for (int i = 0; i < kH; ++i)
#pragma unroll
    for (int c = 0; c < kH; ++c)
      if (c <= i) H[i * lda + c] = m[i][c];
  if (!ok) flags[S_FAIL] = 1;
}

// One warp's factor of the kTile x kTile diagonal block D in place, by halves:
// lane 0 factors the upper left, kH lanes solve the lower left against it,
// the warp updates the lower right, lane 0 factors it. The reciprocal
// square roots of the pivots into rd.
__device__ __forceinline__ void factor_diagonal(float* D, int lda, float* rd, int* flags) {
  const int lane = threadIdx.x & 31;
  if (lane == 0) factor_half(D, lda, rd, flags);
  __syncwarp();
  if (lane < kH) {
    float* row = D + (kH + lane) * lda;
    float a[kH];
#pragma unroll
    for (int c = 0; c < kH; ++c) a[c] = row[c];
#pragma unroll
    for (int c = 0; c < kH; ++c) {
      a[c] *= rd[c];
#pragma unroll
      for (int c2 = 0; c2 < kH; ++c2)
        if (c2 > c) a[c2] = fmaf(-a[c], D[c2 * lda + c], a[c2]);
    }
#pragma unroll
    for (int c = 0; c < kH; ++c) row[c] = a[c];
  }
  __syncwarp();
  constexpr int kPer = kH * kH / 32;   // entries of the lower right a lane
  {
    const int e0 = lane * kPer, i = kH + e0 / kH, j0 = kH + e0 % kH;
    float acc[kPer];
#pragma unroll
    for (int y = 0; y < kPer; ++y) {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int c = 0; c < kH; c += 2) {
        s0 = fmaf(D[i * lda + c], D[(j0 + y) * lda + c], s0);
        s1 = fmaf(D[i * lda + c + 1], D[(j0 + y) * lda + c + 1], s1);
      }
      acc[y] = s0 + s1;
    }
#pragma unroll
    for (int y = 0; y < kPer; ++y) D[i * lda + j0 + y] -= acc[y];
  }
  __syncwarp();
  if (lane == 0) factor_half(D + kH * lda + kH, lda, rd + kH, flags);
}

// The lower Cholesky factor of A in place by panels of kTile columns, the
// reciprocals of its diagonal into rdiag and the inverses of its kTile x kTile
// diagonal blocks into Dinv, two barriers a panel: (1) warp 0 inverts the
// panel's diagonal factor while the other warps solve the panel below it;
// (2) the other warps update the trailing lower blocks but the next diagonal
// one, which warp 0 updates and factors (a look-ahead: the serial factor runs
// beside the update).
__device__ void cholesky(const Plan& P, float* sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int np = P.np, lda = P.lda, nb = P.nb;
  float* A = sm + P.A;
  float* Dinv = sm + P.Dinv;
  float* rdiag = sm + P.rd;
  int* flags = reinterpret_cast<int*>(sm + P.sc);
  if (warp == 0) factor_diagonal(A, lda, rdiag, flags);
  __syncthreads();
  for (int p = 0; p < nb; ++p) {
    const int r0 = p * kTile;
    const float* D = A + r0 * lda + r0;
    const float* rd = rdiag + r0;
    if (warp == 0) {
      // the inverse of the diagonal factor, lane j < kTile computing column j
      // by forward substitution on e_j
      const int j = lane & (kTile - 1);
      float x[kTile];
#pragma unroll
      for (int i = 0; i < kTile; ++i) x[i] = i == j ? 1.f : 0.f;
#pragma unroll
      for (int k = 0; k < kTile; ++k) {
        x[k] *= rd[k];
#pragma unroll
        for (int i = 0; i < kTile; ++i)
          if (i > k) x[i] = fmaf(-D[i * lda + k], x[k], x[i]);
      }
      if (lane < kTile) {
#pragma unroll
        for (int i = 0; i < kTile; ++i) Dinv[p * kTile * kTile + i * kTile + j] = x[i];
      }
    } else {
      // the panel below, and the right-hand side's row: row i of L21 solves
      // x L11^T = a (the right-hand side's, y_p = L_pp^{-1} g_p)
      for (int i = r0 + kTile + tid - 32; i <= np; i += kThreads - 32) {
        float* row = A + i * lda + r0;
        float a[kTile];
#pragma unroll
        for (int q = 0; q < kTile / 4; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(row + 4 * q);
          a[4 * q] = v.x;
          a[4 * q + 1] = v.y;
          a[4 * q + 2] = v.z;
          a[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int c = 0; c < kTile; ++c) {
          a[c] *= rd[c];
#pragma unroll
          for (int c2 = 0; c2 < kTile; ++c2)
            if (c2 > c) a[c2] = fmaf(-a[c], D[c2 * lda + c], a[c2]);
        }
#pragma unroll
        for (int q = 0; q < kTile / 4; ++q) {
          *reinterpret_cast<float4*>(row + 4 * q) =
              make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
        }
      }
    }
    __syncthreads();
    const int rem = nb - p - 1;
    if (rem == 0) break;
    if (warp == 0) {
      // the next diagonal block: D' = D - L L^T over this panel, kPer
      // consecutive entries of one row a lane; then its factor
      constexpr int kPer = kTile * kTile / 32;
      const int r1 = r0 + kTile, e0 = lane * kPer, i = e0 / kTile, j0 = e0 % kTile;
      const float4* li = reinterpret_cast<const float4*>(A + (r1 + i) * lda + r0);
      float4 lrow[kTile / 4];
#pragma unroll
      for (int q = 0; q < kTile / 4; ++q) lrow[q] = li[q];
      float acc[kPer];
#pragma unroll
      for (int y = 0; y < kPer; ++y) {
        const float4* lj = reinterpret_cast<const float4*>(A + (r1 + j0 + y) * lda + r0);
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int q = 0; q < kTile / 4; ++q) {
          const float4 w = lj[q];
          s0 = fmaf(lrow[q].x, w.x, s0);
          s1 = fmaf(lrow[q].y, w.y, s1);
          s0 = fmaf(lrow[q].z, w.z, s0);
          s1 = fmaf(lrow[q].w, w.w, s1);
        }
        acc[y] = s0 + s1;
      }
      float* e = A + (r1 + i) * lda + r1 + j0;
#pragma unroll
      for (int y = 0; y < kPer; ++y) e[y] -= acc[y];
      __syncwarp();
      factor_diagonal(A + r1 * lda + r1, lda, rdiag + r1, flags);
    } else {
      // the other trailing lower blocks: A22 -= L21 L21^T, kQ x kQ threads a
      // kTile x kTile block, a 4 x 4 tile each, the rows of a tile kQ apart
      constexpr int kQ = kTile / 4;
      const int tasks = rem * (rem + 1) / 2, units = kQ * kQ * (tasks - 1);
      for (int w = tid - 32; w < units + kTile * rem; w += kThreads - 32) {
        if (w >= units) {
          // the right-hand side's row: g_J -= L21 y_p, one column a thread
          const int col = kTile * (p + 1) + w - units;
          const float4* gy = reinterpret_cast<const float4*>(A + np * lda + r0);
          const float4* lj = reinterpret_cast<const float4*>(A + col * lda + r0);
          float s0 = 0.f, s1 = 0.f;
#pragma unroll
          for (int q = 0; q < kTile / 4; ++q) {
            const float4 u4 = gy[q], w4 = lj[q];
            s0 = fmaf(u4.x, w4.x, s0);
            s1 = fmaf(u4.y, w4.y, s1);
            s0 = fmaf(u4.z, w4.z, s0);
            s1 = fmaf(u4.w, w4.w, s1);
          }
          A[np * lda + col] -= s0 + s1;
          continue;
        }
        const int q = 1 + w / (kQ * kQ), a = (w / kQ) % kQ, b = w % kQ;
        int i1 = 0;
        while ((i1 + 1) * (i1 + 2) / 2 <= q) ++i1;
        const int I = p + 1 + i1, Jb = p + 1 + q - i1 * (i1 + 1) / 2;
        const int ri = kTile * I + a, rj = kTile * Jb + b;
        float acc[4][4];
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) acc[x][y] = 0.f;
#pragma unroll
        for (int cc = 0; cc < kTile / 4; ++cc) {
          float4 li[4], lj[4];
#pragma unroll
          for (int x = 0; x < 4; ++x)
            li[x] = *reinterpret_cast<const float4*>(A + (ri + kQ * x) * lda + r0 + 4 * cc);
#pragma unroll
          for (int y = 0; y < 4; ++y)
            lj[y] = *reinterpret_cast<const float4*>(A + (rj + kQ * y) * lda + r0 + 4 * cc);
#pragma unroll
          for (int x = 0; x < 4; ++x)
#pragma unroll
            for (int y = 0; y < 4; ++y) {
              acc[x][y] = fmaf(li[x].x, lj[y].x, acc[x][y]);
              acc[x][y] = fmaf(li[x].y, lj[y].y, acc[x][y]);
              acc[x][y] = fmaf(li[x].z, lj[y].z, acc[x][y]);
              acc[x][y] = fmaf(li[x].w, lj[y].w, acc[x][y]);
            }
        }
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) A[(ri + kQ * x) * lda + rj + kQ * y] -= acc[x][y];
      }
    }
    __syncthreads();
  }
}

// delta = L^{-T} y, y = L^{-1} g the right-hand side's row of the factor,
// a thread a row, the diagonal blocks through their inverses (kTile lanes of
// one warp), one barrier a block. delta into sm + P.d.
__device__ void solve(const Plan& P, float* sm) {
  const int tid = threadIdx.x;
  const int np = P.np, lda = P.lda, nb = P.nb;
  const float* A = sm + P.A;
  const float* Dinv = sm + P.Dinv;
  float* sh = sm + P.un;   // scratch: the block's right-hand side (un is free here)
  float* d = sm + P.d;
  const int blk = tid / kTile, l = tid % kTile;
  float yi = tid < np ? A[np * lda + tid] : 0.f;
  for (int b = nb - 1; b >= 0; --b) {
    if (blk == b) sh[tid] = yi;
    __syncwarp();
    if (blk == b) {
      // d_b = inv(L_bb)^T y_b, column l of the inverse (zero above its diagonal)
      const float* inv = Dinv + b * kTile * kTile + l;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int c = 0; c < kTile; c += 2) {
        s0 = fmaf(inv[c * kTile], sh[b * kTile + c], s0);
        s1 = fmaf(inv[(c + 1) * kTile], sh[b * kTile + c + 1], s1);
      }
      d[tid] = s0 + s1;
    }
    __syncthreads();
    if (tid < b * kTile) {
      const float* col = A + b * kTile * lda + tid;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int c = 0; c < kTile; c += 2) {
        s0 = fmaf(col[c * lda], d[b * kTile + c], s0);
        s1 = fmaf(col[(c + 1) * lda], d[b * kTile + c + 1], s1);
      }
      yi -= s0 + s1;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) gauss_newton_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  const Plan P = make_plan(a.horizon, a.num_ref);
  const int tid = threadIdx.x;
  float* sc = sm + P.sc;
  int* flags = reinterpret_cast<int*>(sc);
  float* u = sm + P.u;
  float* un = sm + P.un;
  float* r = sm + P.r;
  float* rn = sm + P.rn;

  // inputs, read at every launch (a graph's replay reads their current values)
  if (tid == 0) {
    const float dt = *a.dt, m = *a.mass, c = *a.base2com;
    sc[S_DT] = dt;
    sc[S_SW_PATH] = __fsqrt_rn(*a.path_w);
    sc[S_SW_V] = __fsqrt_rn(*a.v_w);
    sc[S_SW_ZMP] = __fsqrt_rn(*a.zmp_w);
    sc[S_SW_ROLL] = __fsqrt_rn(*a.roll_v_w);
    sc[S_SW_BACK] = __fsqrt_rn(*a.back_w);
    sc[S_SW_YAW] = __fsqrt_rn(*a.yaw_w);
    sc[S_VREF] = *a.v_ref;
    sc[S_NEG_M] = -m;
    sc[S_C] = c;
    sc[S_NEG_C] = -c;
    sc[S_IXX_DT] = fdiv(a.inertia[0], dt);
    sc[S_BZ] = fmul(m, fsub(*a.gravity_z, 0.f));
    sc[S_INV_DT] = 1.f / dt;
    sc[S_INV_BZ] = 1.f / sc[S_BZ];
    sc[S_YAWREF0] = a.ref_yaw[0];
    sc[S_CX] = a.ref_xy[0];
    sc[S_CY] = a.ref_xy[1];
    flags[S_FAIL] = 0;
  }
  if (tid < kS) sc[S_STATE + tid] = a.state[tid];
  if (tid < kU) {
    sc[S_LO + tid] = a.u_min[tid];
    sc[S_HI + tid] = a.u_max[tid];
  }
  {
    // the centred window (ops/mindist.py center_ref): 2 (ref - c), |ref - c|^2
    float* ref = sm + P.ref;
    const int rp = round_up(P.R, 4);
    const float cx = a.ref_xy[0], cy = a.ref_xy[1];
    for (int j = tid; j < P.R; j += kThreads) {
      const float rx = fsub(a.ref_xy[2 * j], cx), ry = fsub(a.ref_xy[2 * j + 1], cy);
      ref[j] = fmul(2.f, rx);
      ref[rp + j] = fmul(2.f, ry);
      ref[2 * rp + j] = fadd(fmul(rx, rx), fmul(ry, ry));
    }
  }
  for (int k = tid; k < P.np; k += kThreads) {
    u[k] = k < P.n ? a.u[k] : 0.f;
    sm[P.g + k] = 0.f;
  }
  for (int e = tid; e < P.m * P.np; e += kThreads) sm[P.J + e] = 0.f;
  __syncthreads();

  // The residuals and the primal of the current point and of the trial
  // point live in two buffers each: a rejected step leaves the current
  // point's in place, an accepted one swaps them, so only the first step
  // evaluates the current point.
  const int tv_size = TV_COUNT * P.tp;
  int cur = 0;
  evaluate(P, sm, u, r, sc + S_COST, sm + P.tv);
  float lam = a.damping;
  int accepts = 0;
  for (int step = 0; step < a.num_steps; ++step) {
    float* rv = cur ? rn : r;
    float* rv_trial = cur ? r : rn;
    float* tv = sm + P.tv + cur * tv_size;
    float* tv_trial = sm + P.tv + (1 - cur) * tv_size;
    if (tid < P.n) {
      jacobian_item(P, sm, u, rv, tv, tid, false);
    } else if (tid < P.n + 3 * P.tm1) {
      const int q = tid - P.n;
      jacobian_item(P, sm, u, rv, tv, q / 3 * kU + q % 3, true);
    }
    __syncthreads();
    // J^T r, both halves, into the right-hand side's row below A
    for (int k = tid; k < P.np; k += kThreads) {
      sm[P.A + P.np * P.lda + k] =
          k < P.n ? (k % kU < 3 ? sm[P.g + k] + sm[P.y + k] : sm[P.g + k]) : 0.f;
    }
    normal_matrix(P, sm, lam);
    __syncthreads();
    cholesky(P, sm);
    solve(P, sm);
    // the trial point, clamped to the box
    for (int k = tid; k < P.n; k += kThreads) {
      un[k] = clamp_nan(fsub(u[k], sm[P.d + k]), sc[S_LO + k % kU], sc[S_HI + k % kU]);
    }
    __syncthreads();
    evaluate(P, sm, un, rv_trial, sc + S_COST_NEW, tv_trial);
    if (tid == 0) {
      const bool ok = !flags[S_FAIL] && sc[S_COST_NEW] < sc[S_COST];
      flags[S_ACCEPT] = ok;
      flags[S_FAIL] = 0;
      if (ok) sc[S_COST] = sc[S_COST_NEW];
    }
    __syncthreads();
    const bool accept = flags[S_ACCEPT] != 0;
    if (accept) {
      for (int k = tid; k < P.n; k += kThreads) u[k] = un[k];
      cur = 1 - cur;
    }
    lam = accept ? fmul(lam, 0.5f) : fmul(lam, 10.f);
    accepts += accept;
    __syncthreads();
  }
  for (int k = tid; k < P.n; k += kThreads) a.u_out[k] = u[k];
  if (tid == 0) {
    if (a.counts != nullptr) {
      atomicAdd(a.counts, static_cast<unsigned long long>(a.num_steps));
      atomicAdd(a.counts + 1, static_cast<unsigned long long>(accepts));
    }
    if (a.fused != nullptr) atomicAdd(a.fused, static_cast<unsigned long long>(a.num_steps));
  }
}

}  // namespace

// --- host side ------------------------------------------------------------------

extern "C" {

int gauss_newton_threads() { return kThreads; }

int gauss_newton_max_smem() { return kMaxSmem; }

// Dynamic shared memory bytes of one launch at horizon T with u_dim controls
// and num_ref window points; -1 for a shape the kernel has no plan for
// (u_dim other than full_body's 5, T < 3, no window point). The result may
// exceed gauss_newton_max_smem(): such a launch is refused.
int gauss_newton_smem_bytes(int horizon, int u_dim, int num_ref) {
  if (u_dim != kU || horizon < 3 || num_ref < 1) return -1;
  return make_plan(horizon, num_ref).floats * 4;
}

// The parameters of the entry point, one letter each: i int, f float, p
// pointer (kernels/gauss_newton.py SIGNATURE, which the binding holds equal
// to this).
const char* gauss_newton_signature() {
  return "gauss_newton:" "ppppppppppppppppppppp" "iiifp";
}

const char* gauss_newton_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Runs num_steps guarded Gauss-Newton steps of one full_body robot on
// `stream`: u (T-1, 5) the sampled update, state (5,), ref_xy (R, 2),
// ref_yaw (at least 1), dt, the seven cost weights and v_ref, mass,
// base2com, gravity_z one float each, inertia (3,), u_min and u_max (5,),
// all float32 on the device; writes the refined sequence to u_out (T-1, 5).
// counts (2 int64: steps, accepted) and fused (1 int64) may be null; they
// are added to. Returns the cudaError_t of the launch (0 on success),
// cudaErrorInvalidValue for a shape without a plan or over the shared-memory
// limit, or a null operand.
int gauss_newton(const float* u, const float* state, const float* ref_xy,
                 const float* ref_yaw, const float* dt, const float* u_min,
                 const float* u_max, const float* v_ref, const float* path_w,
                 const float* v_w, const float* zmp_w, const float* roll_v_w,
                 const float* back_w, const float* yaw_w, const float* mass,
                 const float* base2com, const float* inertia, const float* gravity_z,
                 float* u_out, long long* counts, long long* fused, int horizon,
                 int num_ref, int num_steps, float damping, void* stream) {
  const int bytes = gauss_newton_smem_bytes(horizon, kU, num_ref);
  const void* operands[] = {u, state, ref_xy, ref_yaw, dt, u_min, u_max, v_ref, path_w,
                            v_w, zmp_w, roll_v_w, back_w, yaw_w, mass, base2com, inertia,
                            gravity_z, u_out};
  for (const void* p : operands) {
    if (p == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  }
  // a thread a row of A, and a thread a Jacobian work item (8 a time step)
  if (bytes < 0 || bytes > kMaxSmem || num_steps < 0 ||
      make_plan(horizon, num_ref).np > kThreads || 8 * (horizon - 1) > kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices || !done[dev]) {
    e = cudaFuncSetAttribute(gauss_newton_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < kMaxDevices) done[dev] = true;
  }
  Args a = {u, state, ref_xy, ref_yaw, dt, u_min, u_max, v_ref, path_w, v_w, zmp_w,
            roll_v_w, back_w, yaw_w, mass, base2com, inertia, gravity_z, u_out,
            reinterpret_cast<unsigned long long*>(counts),
            reinterpret_cast<unsigned long long*>(fused), horizon, num_ref, num_steps,
            damping};
  gauss_newton_kernel<<<1, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
