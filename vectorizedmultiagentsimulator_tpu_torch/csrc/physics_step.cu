// One whole physics step of the vectorized world, all substeps, as one
// CUDA kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel vectorizedmultiagentsimulator_tpu/ops/
// physics_pallas.py::_make_kernel (the Pallas body that fused_step and
// fused_step_packed launch).  Its plain PyTorch version is
// World._step_core in core/world.py; ops/physics_cuda.py holds the
// wrapper, the launch counter and the autograd.Function whose backward
// re-runs the plain version.
//
// What it computes, per env: action force/torque of movable/rotatable
// agents; static gravity x mass and per-env dyn_gravity; linear and
// angular friction; the sphere-sphere (ss) and box-sphere (bs, solid or
// hollow) soft contacts; drag on substep 0; semi-implicit Euler with the
// max_speed, v_range and x/y semidim clamps, over every substep.  Worlds
// with line or box-box pairs, joints or per-env mass step through the
// plain version (physics_cuda.step_supported decides at finalize).
//
// What bounds it on the H100.  For transport (N=6 entities, A=4 agents)
// an env moves 144 B of state in (pos, vel, rot, ang_vel), 144 B out and
// 48 B of action force/torque: about 340 B, so 30k envs move about 10 MB a
// step, a few microseconds at 3.35 TB/s.  Memory is not the limit: launch
// overhead and each thread's arithmetic over n_pairs x substeps are.  One
// thread per env makes the whole step one launch with no inter-thread
// communication, and keeps every intermediate (per-entity force sums, the
// contact geometry) in registers and thread-local memory, never in device
// memory.  The native [B, N, .] layout is read and written as the plain
// version has it, out of place; a structure-of-arrays layout with the env
// batch contiguous (coalesced loads) is later work.
//
// Parity with the plain version.  This file is built with -fmad=false
// and repeats the plain version's operations in its order: the box
// sides in the world frame, the 4-side first-minimum with a strict '<',
// softplus as max(x,0) + log1p(exp(-|x|)) (torch.logaddexp's formula),
// sqrtf/sinf/cosf/expf/log1pf without fast math.  The contact tests
// (dist > dist_min) then see the plain version's bits, so a one-ulp
// difference never switches a contact on in one and off in the other.
// What differs is the order of the per-entity force sums (the plain
// version sums pair contributions with a matmul).

#include <cuda_runtime.h>

#define VMT_MAX_ENTITIES 64
#define VMT_THREADS 128
#define VMT_LINE_MIN_DIST (4.0f / 6e2f)

namespace {

struct Tables {
  const int* movable;      // [N]
  const int* rotatable;    // [N]
  const float* mass;       // [N]
  const float* moment;     // [N]
  const float* drag;       // [N]
  const float* max_speed;  // [N], inf = none
  const float* v_range;    // [N], inf = none
  const float* gravity;    // [N, 2], world + static entity gravity
  const int* dyn_row;      // [N], row into dyn_g or -1
  const float* radius;     // [N]
  const float* length;     // [N]
  const float* width;      // [N]
  const int* hollow;       // [N]
  const float* lin_fric;   // [N]
  const float* ang_fric;   // [N]
  const int* ss_pairs;     // [n_ss, 2] (sphere a, sphere b)
  const int* bs_pairs;     // [n_bs, 2] (box, sphere)
};

struct Dims {
  int B, N, A, n_landmarks, D, n_ss, n_bs, substeps;
  float sub_dt, contact_margin, collision_force;
  int has_x_semidim, has_y_semidim;
  float x_semidim, y_semidim;
};

// TorchUtils.safe_norm of (x, y): 0 at the zero vector.
__device__ __forceinline__ float safe_norm2(float x, float y) {
  float sq = x * x + y * y;
  return sq > 0.0f ? sqrtf(sq) : 0.0f;
}

// World._constraint_forces: soft repulsive contact force on entity a along
// (dx, dy) = pos_a - pos_b; entity b gets its negation.
__device__ __forceinline__ void soft_contact(float dx, float dy,
                                             float dist_min, const Dims& d,
                                             float* fx, float* fy) {
  float dist = safe_norm2(dx, dy);
  float x = (dist_min - dist) / d.contact_margin;
  float pen = (fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)))) * d.contact_margin;
  float den = dist > 0.0f ? dist : 1e-8f;
  bool zero = (dist < 1e-6f) || (dist > dist_min);
  *fx = zero ? 0.0f : d.collision_force * dx / den * pen;
  *fy = zero ? 0.0f : d.collision_force * dy / den * pen;
}

// geometry.closest_point_line: closest point on a segment given by its
// centre, rotation and length to the query point (qx, qy).
__device__ __forceinline__ void closest_on_line(float lx, float ly, float c,
                                                float s, float len, float qx,
                                                float qy, float* ox,
                                                float* oy) {
  float dot = (lx - qx) * c + (ly - qy) * s;
  float sign = (dot > 0.0f) ? 1.0f : ((dot < 0.0f) ? -1.0f : 0.0f);  // jnp.sign(0) == 0
  float dist = fminf(fabsf(dot), len / 2.0f);
  float m = sign * dist;
  *ox = lx - m * c;
  *oy = ly - m * s;
}

// geometry.closest_point_box: the 4 sides in the reference order
// (+length, -length, +width, -width), first minimum.
__device__ __forceinline__ void closest_on_box(float bx, float by, float rot,
                                               float width, float length,
                                               float qx, float qy, float* ox,
                                               float* oy) {
  float hc = cosf(rot), hs = sinf(rot);
  float prot = rot + 1.57079632679489662f;
  float pc = cosf(prot), ps = sinf(prot);
  float hl = length / 2.0f, hw = width / 2.0f;
  float sx[4] = {bx + hc * hl, bx - hc * hl, bx + pc * hw, bx - pc * hw};
  float sy[4] = {by + hs * hl, by - hs * hl, by + ps * hw, by - ps * hw};
  float sc[4] = {pc, pc, hc, hc};
  float ss[4] = {ps, ps, hs, hs};
  float sl[4] = {width, width, length, length};
  float best_x = 0.0f, best_y = 0.0f, best_d = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float cx, cy;
    closest_on_line(sx[k], sy[k], sc[k], ss[k], sl[k], qx, qy, &cx, &cy);
    float dd = safe_norm2(qx - cx, qy - cy);
    if (k == 0 || dd < best_d) {
      best_x = cx;
      best_y = cy;
      best_d = dd;
    }
  }
  *ox = best_x;
  *oy = best_y;
}

__global__ void __launch_bounds__(VMT_THREADS)
physics_step_kernel(const float* __restrict__ pos, const float* __restrict__ vel,
                    const float* __restrict__ rot,
                    const float* __restrict__ ang_vel,
                    const float* __restrict__ force_a,
                    const float* __restrict__ torque_a,
                    const float* __restrict__ dyn_g, float* __restrict__ out_pos,
                    float* __restrict__ out_vel, float* __restrict__ out_rot,
                    float* __restrict__ out_ang_vel, Tables t, Dims d) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= d.B) return;
  const int N = d.N;

  float px[VMT_MAX_ENTITIES], py[VMT_MAX_ENTITIES];
  float vx[VMT_MAX_ENTITIES], vy[VMT_MAX_ENTITIES];
  float th[VMT_MAX_ENTITIES], w[VMT_MAX_ENTITIES];
  // Forces that stay fixed over the substeps: action + gravity.
  float bfx[VMT_MAX_ENTITIES], bfy[VMT_MAX_ENTITIES], btq[VMT_MAX_ENTITIES];
  // Per-substep pair force/torque sums.
  float cfx[VMT_MAX_ENTITIES], cfy[VMT_MAX_ENTITIES], ctq[VMT_MAX_ENTITIES];

  const size_t pb = (size_t)b * N;
  for (int i = 0; i < N; ++i) {
    px[i] = pos[(pb + i) * 2];
    py[i] = pos[(pb + i) * 2 + 1];
    vx[i] = vel[(pb + i) * 2];
    vy[i] = vel[(pb + i) * 2 + 1];
    th[i] = rot[pb + i];
    w[i] = ang_vel[pb + i];
    bfx[i] = 0.0f;
    bfy[i] = 0.0f;
    btq[i] = 0.0f;
  }
  // Action force/torque (landmarks get none; immovable agents masked).
  for (int j = 0; j < d.A; ++j) {
    const int i = d.n_landmarks + j;
    const size_t ab = (size_t)b * d.A + j;
    if (t.movable[i]) {
      bfx[i] = force_a[ab * 2];
      bfy[i] = force_a[ab * 2 + 1];
    }
    if (t.rotatable[i]) btq[i] = torque_a[ab];
  }
  // Gravity: static table x mass, plus the per-env dyn_gravity row.
  for (int i = 0; i < N; ++i) {
    if (!t.movable[i]) continue;
    float gx = t.gravity[2 * i] * t.mass[i];
    float gy = t.gravity[2 * i + 1] * t.mass[i];
    const int k = t.dyn_row[i];
    if (k >= 0) {
      const size_t gb = ((size_t)b * d.D + k) * 2;
      gx = gx + dyn_g[gb] * t.mass[i];
      gy = gy + dyn_g[gb + 1] * t.mass[i];
    }
    bfx[i] = bfx[i] + gx;
    bfy[i] = bfy[i] + gy;
  }

  const float dt = d.sub_dt;
  for (int substep = 0; substep < d.substeps; ++substep) {
    for (int i = 0; i < N; ++i) {
      cfx[i] = 0.0f;
      cfy[i] = 0.0f;
      ctq[i] = 0.0f;
    }

    // ---- sphere-sphere contacts (core.py:2294-2339) ---- //
    for (int p = 0; p < d.n_ss; ++p) {
      const int a = t.ss_pairs[2 * p], c = t.ss_pairs[2 * p + 1];
      float fx, fy;
      soft_contact(px[a] - px[c], py[a] - py[c], t.radius[a] + t.radius[c], d,
                   &fx, &fy);
      if (t.movable[a]) {
        cfx[a] += fx;
        cfy[a] += fy;
      }
      if (t.movable[c]) {
        cfx[c] += -fx;
        cfy[c] += -fy;
      }
    }

    // ---- box-sphere contacts (core.py:2459-2552) ---- //
    for (int p = 0; p < d.n_bs; ++p) {
      const int bi = t.bs_pairs[2 * p], si = t.bs_pairs[2 * p + 1];
      float clx, cly;
      closest_on_box(px[bi], py[bi], th[bi], t.width[bi], t.length[bi],
                     px[si], py[si], &clx, &cly);
      float ix = clx, iy = cly, d_extra = 0.0f;
      if (!t.hollow[bi]) {
        // geometry.inner_point_box: project the contact point toward the
        // box centre; a degenerate ray gives surface + surface.
        float v_x = clx - px[si], v_y = cly - py[si];
        float u_x = px[bi] - clx, u_y = py[bi] - cly;
        float vn = safe_norm2(v_x, v_y);
        float safe = fmaxf(vn, 1e-12f);
        float x_mag = (v_x * u_x + v_y * u_y) / safe;
        float ox = v_x / safe * x_mag, oy = v_y / safe * x_mag;
        if (vn == 0.0f) {
          ox = clx;
          oy = cly;
          x_mag = 0.0f;
        }
        ix = clx + ox;
        iy = cly + oy;
        d_extra = fabsf(x_mag);
      }
      float fx, fy;  // force on the sphere
      soft_contact(px[si] - ix, py[si] - iy,
                   t.radius[si] + VMT_LINE_MIN_DIST + d_extra, d, &fx, &fy);
      if (t.movable[si]) {
        cfx[si] += fx;
        cfy[si] += fy;
      }
      const float fbx = -fx, fby = -fy;  // force on the box
      if (t.movable[bi]) {
        cfx[bi] += fbx;
        cfy[bi] += fby;
      }
      if (t.rotatable[bi]) {
        const float rx = clx - px[bi], ry = cly - py[bi];
        ctq[bi] += rx * fby - ry * fbx;
      }
    }

    // ---- forces, then integrate (core.py:2860-2908) ---- //
    for (int i = 0; i < N; ++i) {
      float fx = bfx[i], fy = bfy[i], tq = btq[i];
      // static/kinetic friction (core.py:2054-2073)
      if (t.lin_fric[i] > 0.0f) {
        const float speed = safe_norm2(vx[i], vy[i]);
        if (speed != 0.0f) {
          const float fc = t.lin_fric[i] * t.mass[i];
          fx = fx + -(vx[i] / speed) * fminf(fc, fabsf(vx[i]) / dt * t.mass[i]);
          fy = fy + -(vy[i] / speed) * fminf(fc, fabsf(vy[i]) / dt * t.mass[i]);
        }
      }
      if (t.ang_fric[i] > 0.0f) {
        const float aspeed = safe_norm2(w[i], 0.0f);
        if (aspeed != 0.0f) {
          const float tc = t.ang_fric[i] * t.moment[i];
          tq = tq + -(w[i] / aspeed) * fminf(tc, fabsf(w[i]) / dt * t.moment[i]);
        }
      }
      fx = fx + cfx[i];
      fy = fy + cfy[i];
      tq = tq + ctq[i];

      if (t.movable[i]) {
        if (substep == 0) {
          const float keep = 1.0f - t.drag[i];
          vx[i] = vx[i] * keep;
          vy[i] = vy[i] * keep;
        }
        float nvx = vx[i] + fx / t.mass[i] * dt;
        float nvy = vy[i] + fy / t.mass[i] * dt;
        const float ms = t.max_speed[i];
        if (isfinite(ms)) {
          const float n = safe_norm2(nvx, nvy);
          if (n > ms) {
            const float safe = fmaxf(n, 1e-12f);
            nvx = nvx / safe * ms;
            nvy = nvy / safe * ms;
          }
        }
        const float vr = t.v_range[i];
        if (isfinite(vr)) {
          nvx = fminf(fmaxf(nvx, -vr), vr);
          nvy = fminf(fmaxf(nvy, -vr), vr);
        }
        vx[i] = nvx;
        vy[i] = nvy;
        float npx = px[i] + nvx * dt;
        float npy = py[i] + nvy * dt;
        if (d.has_x_semidim) npx = fminf(fmaxf(npx, -d.x_semidim), d.x_semidim);
        if (d.has_y_semidim) npy = fminf(fmaxf(npy, -d.y_semidim), d.y_semidim);
        px[i] = npx;
        py[i] = npy;
      }
      if (t.rotatable[i]) {
        if (substep == 0) w[i] = w[i] * (1.0f - t.drag[i]);
        w[i] = w[i] + tq / t.moment[i] * dt;
        th[i] = th[i] + w[i] * dt;
      }
    }
  }

  for (int i = 0; i < N; ++i) {
    out_pos[(pb + i) * 2] = px[i];
    out_pos[(pb + i) * 2 + 1] = py[i];
    out_vel[(pb + i) * 2] = vx[i];
    out_vel[(pb + i) * 2 + 1] = vy[i];
    out_rot[pb + i] = th[i];
    out_ang_vel[pb + i] = w[i];
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Every pointer is a device
// pointer to a contiguous tensor the caller has checked; the launch goes on
// `stream` (PyTorch's current stream).  Returns cudaGetLastError() after
// the launch, 0 on success; it does not synchronise.
extern "C" int vmt_physics_step(
    const float* pos, const float* vel, const float* rot, const float* ang_vel,
    const float* force_a, const float* torque_a, const float* dyn_g,
    float* out_pos, float* out_vel, float* out_rot, float* out_ang_vel,
    const int* movable, const int* rotatable, const float* mass,
    const float* moment, const float* drag, const float* max_speed,
    const float* v_range, const float* gravity, const int* dyn_row,
    const float* radius, const float* length, const float* width,
    const int* hollow, const float* lin_fric, const float* ang_fric,
    const int* ss_pairs, const int* bs_pairs, int B, int N, int A,
    int n_landmarks, int D, int n_ss, int n_bs, int substeps, float sub_dt,
    float contact_margin, float collision_force, int has_x_semidim,
    float x_semidim, int has_y_semidim, float y_semidim, void* stream) {
  if (N > VMT_MAX_ENTITIES || B <= 0) return (int)cudaErrorInvalidValue;
  Tables t{movable, rotatable, mass,   moment, drag,     max_speed,
           v_range, gravity,   dyn_row, radius, length,   width,
           hollow,  lin_fric,  ang_fric, ss_pairs, bs_pairs};
  Dims d{B,      N,          A,       n_landmarks,    D,
         n_ss,   n_bs,       substeps, sub_dt,        contact_margin,
         collision_force, has_x_semidim, has_y_semidim, x_semidim, y_semidim};
  const int blocks = (B + VMT_THREADS - 1) / VMT_THREADS;
  physics_step_kernel<<<blocks, VMT_THREADS, 0, (cudaStream_t)stream>>>(
      pos, vel, rot, ang_vel, force_a, torque_a, dyn_g, out_pos, out_vel,
      out_rot, out_ang_vel, t, d);
  return (int)cudaGetLastError();
}
