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
// Layout.  One thread per (env, teammate) in the port's native layout:
// agents_pos / curr_target [B, T, 2], samples [B, T, S, 2], ball and nets
// [B, 2], value_noise [B, T, S + 1], out [B, T, 2].  Neighbouring threads
// are neighbouring teammates of one env, then the next env, so the
// per-teammate reads and the write are contiguous across a warp; the env's
// T agent positions (the teammate-repulsion term) come from L1.  The TPU
// kernel's [rows, B] transposes serve the TPU's lane layout and are left
// out.  The samples and the value noise are drawn outside: the kernel is a
// pure function of its operands.
//
// What bounds it on the H100.  At football 5v5 at 30k envs (T = 5, S = 2)
// an env reads 46 floats and writes 10: 6.7 MB a call, 2.0 us at 3.35
// TB/s, against about 900 operations an env (0.4 us at the fp32 rate), so
// bytes bound it; at that size a launch is dominated by its fixed cost.
// The design keeps the whole candidate build, the value and the fold in
// registers: one read of each operand, one write of the result.
//
// Parity with the plain version.  Built with -fmad=false and without fast
// math (sqrtf, expf, IEEE division), it repeats the plain version's
// operations in their order: each norm as x*x + y*y then sqrtf, the
// teammate squares summed in teammate order with the agent's own term
// multiplied by 0, the wall terms in their stacked (0, v) / (h, 0) form,
// the five terms added left to right and divided by 5, the noise and
// candidate 0's margin added last.  A different candidate moves an output
// by up to the pitch's width, so the two must select the same candidate
// row by row; they may differ only where two values tie to within an ulp.
//
// Compiled as host C++ (no __CUDACC__), the same per-thread body runs as a
// loop over the (env, teammate) index, which is how the CPU tests run this
// source.

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
};

namespace {

DEV float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

DEV float norm2(float x, float y) {
  return sqrtf(x * x + y * y);
}

// The best position of (env, teammate) number k = env * T + teammate.
DEV void plan_one(long long k, const float* __restrict__ agents_pos,
                  const float* __restrict__ curr_target,
                  const float* __restrict__ samples,
                  const float* __restrict__ ball_pos,
                  const float* __restrict__ target_net_pos,
                  const float* __restrict__ own_net_pos,
                  const float* __restrict__ value_noise,
                  float* __restrict__ out, const Params& p) {
  const int T = p.T, S = p.S;
  const int b = (int)(k / T), t = (int)(k % T);
  const float* ap = agents_pos + (size_t)b * T * 2;
  const float ax = ap[2 * t], ay = ap[2 * t + 1];
  const float bx = ball_pos[2 * b], by = ball_pos[2 * b + 1];
  const float tnx = target_net_pos[2 * b], tny = target_net_pos[2 * b + 1];
  const float onx = own_net_pos[2 * b], ony = own_net_pos[2 * b + 1];
  const float* smp = samples + (size_t)k * S * 2;

  float best_x = 0.0f, best_y = 0.0f, best_val = 0.0f;
  for (int c = 0; c <= S; ++c) {
    // candidate c: the current target, then sample c - 1 around the ball
    // (even samples) or the agent (odd ones)
    float rx, ry;
    if (c == 0) {
      rx = curr_target[2 * k];
      ry = curr_target[2 * k + 1];
    } else if ((c - 1) % 2 == 0) {
      rx = smp[2 * (c - 1)] + bx;
      ry = smp[2 * (c - 1) + 1] + by;
    } else {
      rx = smp[2 * (c - 1)] + ax;
      ry = smp[2 * (c - 1) + 1] + ay;
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
      // teammate repulsion, the agent's own term zeroed
      float acc = 0.0f;
      for (int j = 0; j < T; ++j) {
        const float e =
            expf(-5.0f * norm2(ap[2 * j] - px, ap[2 * j + 1] - py)) *
            (j == t ? 0.0f : 1.0f);
        acc = j == 0 ? e * e : acc + e * e;
      }
      value = value + (-sqrtf(acc) + 1.0f);
    }
    value = (value + ball_dist_value + side_value + defend_value) / 5.0f;
    if (p.has_noise) value = value + value_noise[(size_t)k * (S + 1) + c];

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
  out[2 * k] = best_x;
  out[2 * k + 1] = best_y;
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(VMT_THREADS)
best_positions_kernel(const float* __restrict__ agents_pos,
                      const float* __restrict__ curr_target,
                      const float* __restrict__ samples,
                      const float* __restrict__ ball_pos,
                      const float* __restrict__ target_net_pos,
                      const float* __restrict__ own_net_pos,
                      const float* __restrict__ value_noise,
                      float* __restrict__ out, Params p, int B) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (long long)B * p.T) return;
  plan_one(k, agents_pos, curr_target, samples, ball_pos, target_net_pos,
           own_net_pos, value_noise, out, p);
}
#endif

}  // namespace

// Plain C entry point, loaded with ctypes.  Every tensor pointer is a
// device pointer to a contiguous float32 tensor the caller has checked
// (value_noise may be null when p->has_noise is 0); `p` is a host pointer
// to the planner's Params.  The launch goes on `stream` (PyTorch's current
// stream).  Returns cudaGetLastError() after the launch, 0 on success; it
// does not synchronise.
// Compiled as host C++, the same entry point runs plan_one over every
// (env, teammate) on host pointers and returns 0 (1 for invalid sizes).
extern "C" int vmt_football_best_positions(
    const float* agents_pos, const float* curr_target, const float* samples,
    const float* ball_pos, const float* target_net_pos,
    const float* own_net_pos, const float* value_noise, float* out,
    const Params* p, int B, void* stream) {
  const long long n = (long long)B * p->T;
#ifdef __CUDACC__
  if (B <= 0 || p->T <= 0 || p->S < 0 || (p->has_noise && !value_noise))
    return (int)cudaErrorInvalidValue;
  const int blocks = (int)((n + VMT_THREADS - 1) / VMT_THREADS);
  best_positions_kernel<<<blocks, VMT_THREADS, 0, (cudaStream_t)stream>>>(
      agents_pos, curr_target, samples, ball_pos, target_net_pos, own_net_pos,
      value_noise, out, *p, B);
  return (int)cudaGetLastError();
#else
  (void)stream;
  if (B <= 0 || p->T <= 0 || p->S < 0 || (p->has_noise && !value_noise))
    return 1;
  for (long long k = 0; k < n; ++k)
    plan_one(k, agents_pos, curr_target, samples, ball_pos, target_net_pos,
             own_net_pos, value_noise, out, *p);
  return 0;
#endif
}
