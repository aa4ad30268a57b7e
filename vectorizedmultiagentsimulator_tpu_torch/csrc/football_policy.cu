// Football's scripted-AI planner as one CUDA kernel for Hopper (sm_90a):
// for each env and AI teammate, the first-max of S + 1 candidate targets
// under the 5-term position value of AgentPolicy.get_pos_value.
//
// Replaces the TPU kernel vectorizedmultiagentsimulator_tpu/ops/
// football_policy_pallas.py::_make_kernel (launched by
// fused_best_positions).  Its plain PyTorch version is ops/
// football_policy_cuda.py::best_positions_plain; that module also holds
// the wrapper, the launch counter and the autograd.Function whose backward
// re-runs the plain version.
//
// Operands.  agents_pos [B, T, 2] and normals [B, T, S, 2] contiguous;
// curr_target [B, T, 2] by its batch and teammate strides; the ball's and
// the two nets' positions [B, 2] by their batch strides, so the caller
// hands over the columns of the world's stacked state.pos as they are;
// noise [B, T, S + 1] contiguous or null; out [B, T, 2].  The kernel
// draws nothing: the normals and the noise come from the caller, unscaled.
// It scales them itself, sample = (normal * sigma) * spread and noise *
// noise_scale, the caller's fp32 products in their order.
//
// Layout.  One thread per row (env, teammate), its S + 1 candidates one
// after another in registers.  Neighbouring threads are neighbouring
// teammates of one env, then the next env, so the per-teammate reads and
// the write are contiguous across a warp; the env's T agent positions (the
// teammate-repulsion term), its ball and its nets come from L1.  The TPU
// kernel's [rows, B] transposes serve the TPU's lane layout and are left
// out.
//
// What bounds it on the H100.  At football 5v5 at 30k envs (T = 5, S = 2)
// an env reads 46 floats and writes 10: 6.7 MB a call, 2.0 us at 3.35
// TB/s, against about 1,000 operations an env (0.5 us at the fp32 rate)
// if each expf, sqrtf and division counted as one.  They do not: each is
// a chain of a dozen dependent instructions (no fast math, IEEE rounding),
// about 25 of them a candidate, so the launch is bound by issuing those
// chains, not by bytes.  A lane a candidate (four lanes a row at S = 2,
// the fourth idle) and staging an env's operands in shared memory were
// both measured slower on the H100 80GB HBM3 (700 W): they issue more
// instructions for the same chains.
//
// Parity with the plain version.  Built with -fmad=false and without fast
// math (sqrtf, expf, IEEE division), it repeats the plain version's
// operations in their order: each norm as x*x + y*y then sqrtf, the
// teammate squares summed in teammate order (the agent's own term, 0 in
// the plain version, left out: adding 0 changes no bit), the wall terms
// in their stacked (0, v) / (h, 0) form, the five terms added left to
// right and divided by 5, the noise and candidate 0's margin added last.
// A different candidate moves an output by up to the pitch's width, so
// the two must select the same candidate row by row; they may differ only
// where two values tie to within an ulp of the card's libm against the
// host's.
//
// Compiled as host C++ (no __CUDACC__), the same per-thread body runs as a
// loop over the rows, which is how the CPU tests run this source.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define DEV __device__ __forceinline__
#else
#include <cmath>
#define DEV inline
#endif

#define VMT_THREADS 128

// The static planner parameters.  ops/football_policy_cuda.py mirrors this
// struct field for field (_Params), fills it once per PlannerParams and
// passes its host address to vmt_football_best_positions.  goal_x_hi is
// fp32(clamp_x + goal_x), the x bound inside the goal mouth.
struct Params {
  int T, S, has_noise;
  float clamp_y, clamp_x, goal_y, goal_x_hi, wall_w2, wall_l2, margin0;
  float sigma, spread, noise_scale;
};

// The operands of one call (mirrored by _Operands).  Strides count floats.
struct Operands {
  const float* agents_pos;
  const float* curr_target;
  long long ct_b, ct_t;
  const float* normals;
  const float* ball;
  long long ball_b;
  const float* target_net;
  long long tnet_b;
  const float* own_net;
  long long onet_b;
  const float* noise;
  float* out;
  int B;
};

namespace {

DEV float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

DEV float norm2(float x, float y) {
  return sqrtf(x * x + y * y);
}

// A read of an operand, through the read-only data path on the card (the
// operands live in device memory the launch does not write).
DEV float ld(const float* x) {
#ifdef __CUDACC__
  return __ldg(x);
#else
  return *x;
#endif
}

// The best position of row k = env * T + teammate.
DEV void plan_one(int k, const Operands& o, const Params& p) {
  const int T = p.T, S = p.S;
  const int b = k / T, t = k - b * T;
  const float* ap = o.agents_pos + (size_t)b * T * 2;
  const float ax = ld(ap + 2 * t), ay = ld(ap + 2 * t + 1);
  const float* ball = o.ball + (size_t)b * o.ball_b;
  const float* tnet = o.target_net + (size_t)b * o.tnet_b;
  const float* onet = o.own_net + (size_t)b * o.onet_b;
  const float bx = ld(ball), by = ld(ball + 1);
  const float tnx = ld(tnet), tny = ld(tnet + 1);
  const float onx = ld(onet), ony = ld(onet + 1);
  const float* ct = o.curr_target + (size_t)b * o.ct_b + (size_t)t * o.ct_t;
  const float* nrm = o.normals + (size_t)k * S * 2;
  const float* noise =
      p.has_noise ? o.noise + (size_t)k * (S + 1) : nullptr;

  float best_x = 0.0f, best_y = 0.0f, best_val = 0.0f;
  for (int c = 0; c <= S; ++c) {
    // candidate c: the current target, then sample c - 1 around the ball
    // (even samples) or the agent (odd ones)
    float rx, ry;
    if (c == 0) {
      rx = ld(ct);
      ry = ld(ct + 1);
    } else {
      const bool on_ball = (c - 1) % 2 == 0;
      const float* n = nrm + 2 * (c - 1);
      rx = ld(n) * p.sigma * p.spread + (on_ball ? bx : ax);
      ry = ld(n + 1) * p.sigma * p.spread + (on_ball ? by : ay);
    }

    // clamp_pos: the goal mouth extends the x range
    const float py = clampf(ry, -p.clamp_y, p.clamp_y);
    const bool inside_goal_y = fabsf(py) < p.goal_y;
    const float px = inside_goal_y ? clampf(rx, -p.goal_x_hi, p.goal_x_hi)
                                   : clampf(rx, -p.clamp_x, p.clamp_x);

    // ball proximity and direction
    const float bvx = bx - px, bvy = by - py;
    const float ball_norm = norm2(bvx, bvy);
    const float bden = fmaxf(ball_norm, 1e-12f);
    const float bhx = ball_norm > 0.0f ? bvx / bden : 0.0f;
    const float bhy = ball_norm > 0.0f ? bvy / bden : 0.0f;
    const float d2 = ball_norm * ball_norm;
    const float ball_dist_value = expf(-2.0f * (d2 * d2));

    // shooting-side and defend dot products
    const float nvx = tnx - px, nvy = tny - py;
    const float net_norm = fmaxf(norm2(nvx, nvy), 1e-12f);
    const float side_dot = bhx * (nvx / net_norm) + bhy * (nvy / net_norm);
    const float side_value = fminf(side_dot + 1.25f, 1.0f);
    const float ovx = (onx - px) / net_norm, ovy = (ony - py) / net_norm;
    const float defend_value = fmaxf(bhx * -ovx + bhy * -ovy, 0.0f);

    // wall repulsion, in the stacked displacement form
    const float top = -py + p.wall_w2, bottom = py + p.wall_w2;
    const float left = px + p.wall_l2, right = -px + p.wall_l2;
    const float vd = fminf(top, bottom) * (bottom < top ? -1.0f : 1.0f);
    const float hd = fminf(left, right) * (left < right ? -1.0f : 1.0f);
    const float wall_v = norm2(0.0f, vd), wall_h = norm2(hd, 0.0f);
    const float wall_value =
        -norm2(expf(-8.0f * wall_v), expf(-8.0f * wall_h)) + 1.0f;

    float value = wall_value;
    if (T > 1) {
      // teammate repulsion over the other teammates in order; the agent's
      // own term is 0 (NaN from a NaN position), and adding 0 to a sum of
      // squares changes no bit, so it is left out of the loop
      float acc = 0.0f;
      for (int i = 0; i < T - 1; ++i) {
        const int j = i + (i >= t);
        const float e = expf(
            -5.0f * norm2(ld(ap + 2 * j) - px, ld(ap + 2 * j + 1) - py));
        acc = i == 0 ? e * e : acc + e * e;
      }
      const float own_x = ax - px, own_y = ay - py;
      if (own_x != own_x || own_y != own_y) acc = NAN;
      value = value + (-sqrtf(acc) + 1.0f);
    }
    value = (value + ball_dist_value + side_value + defend_value) / 5.0f;
    if (p.has_noise) value = value + ld(noise + c) * p.noise_scale;

    // first-max fold: strictly greater replaces, ties keep the earliest
    if (c == 0) {
      best_x = px;
      best_y = py;
      best_val = value + p.margin0;
    } else {
      if (value > best_val) {
        best_x = px;
        best_y = py;
      }
      best_val = fmaxf(best_val, value);
    }
  }
  o.out[2 * (size_t)k] = best_x;
  o.out[2 * (size_t)k + 1] = best_y;
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(VMT_THREADS)
best_positions_kernel(Operands o, Params p) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= o.B * p.T) return;
  plan_one(k, o, p);
}
#endif

}  // namespace

// Plain C entry point, loaded with ctypes.  The operand pointers in `o`
// are device pointers to float32 data the caller has checked (o->noise may
// be null when p->has_noise is 0); `o` and `p` are host pointers.  The
// launch goes on `stream` (PyTorch's current stream).  Returns
// cudaGetLastError() after the launch, 0 on success; it does not
// synchronise.
// Compiled as host C++, the same entry point runs plan_one over every row
// on host pointers and returns 0 (1 for invalid sizes).
extern "C" int vmt_football_best_positions(const Operands* o, const Params* p,
                                           void* stream) {
  const long long n = (long long)o->B * p->T;
  const bool bad = o->B <= 0 || p->T <= 0 || p->S < 0 || n >= (1ll << 31) ||
                   (p->has_noise && !o->noise);
#ifdef __CUDACC__
  if (bad) return (int)cudaErrorInvalidValue;
  const int blocks = (int)((n + VMT_THREADS - 1) / VMT_THREADS);
  best_positions_kernel<<<blocks, VMT_THREADS, 0, (cudaStream_t)stream>>>(
      *o, *p);
  return (int)cudaGetLastError();
#else
  (void)stream;
  if (bad) return 1;
  for (int k = 0; k < (int)n; ++k) plan_one(k, *o, *p);
  return 0;
#endif
}
