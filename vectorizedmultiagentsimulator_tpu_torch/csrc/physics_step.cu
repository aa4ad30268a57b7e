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
// angular friction; the soft contacts of all six pair classes:
// sphere-sphere (ss), box-sphere (bs), line-sphere (ls), line-line (ll),
// box-line (bl) and box-box (bb), boxes solid or hollow; drag on substep
// 0; semi-implicit Euler with the max_speed, v_range and x/y semidim
// clamps, over every substep.  Worlds with joints or per-env mass step
// through the plain version (physics_cuda.step_supported decides at
// finalize).
//
// What bounds it on the H100.  For transport (N=6 entities, A=4 agents)
// an env moves 144 B of state in (pos, vel, rot, ang_vel), 144 B out and
// 48 B of action force/torque: about 340 B, so 30k envs move about 10 MB a
// step, a few microseconds at 3.35 TB/s.  Memory is not the limit: launch
// overhead and each thread's arithmetic over n_pairs x substeps are (a
// box-box pair is 32 segment-segment tests, a box-line pair 4).  One
// thread per env makes the whole step one launch with no inter-thread
// communication, and keeps every intermediate (per-entity force sums, the
// contact geometry) in registers and thread-local memory, never in device
// memory.  The native [B, N, .] layout is read and written as the plain
// version has it, out of place; a structure-of-arrays layout with the env
// batch contiguous (coalesced loads) is later work.
//
// Parity with the plain version.  This file is built with -fmad=false
// and repeats the plain version's operations in its order: box sides in
// the world frame from cos/sin of rot and rot + pi/2, the segment-segment
// closest points as intersection test + 4 endpoint projections, the
// 4-side and 8-candidate first-minimum folds with a strict '<', the
// inner point of solid boxes, softplus as max(x,0) + log1p(exp(-|x|))
// (torch.logaddexp's formula), sqrtf/sinf/cosf/expf/log1pf without fast
// math.  The contact tests (dist > dist_min) then see the plain version's
// bits, so a one-ulp difference never switches a contact on in one and
// off in the other.  What differs is the order of the per-entity force
// sums (the plain version sums pair contributions with a matmul).

#include <cuda_runtime.h>

#define VMT_MAX_ENTITIES 64
#define VMT_THREADS 128
#define VMT_LINE_MIN_DIST (4.0f / 6e2f)

// The pair classes, in the order of their rows in Tables::pairs
// (ops/physics_cuda.py KERNEL_CLASSES).
enum PairClass { SS, BS, LS, LL, BL, BB, N_CLASSES };

// Static tables, device pointers.  ops/physics_cuda.py mirrors this struct
// field for field (_Tables), fills it once per world and passes its host
// address to vmt_physics_step.
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
  // [P, 2], every class's pairs, class by class: ss (sphere a, sphere b),
  // bs (box, sphere), ls (line, sphere), ll (line a, line b), bl (box,
  // line), bb (box a, box b).
  const int* pairs;
};

// Sizes and scalars, mirrored as _Dims in ops/physics_cuda.py.
struct Dims {
  int B, N, A, n_landmarks, D, substeps;
  // Class c's pairs are the rows [pair_start[c], pair_start[c + 1]).
  int pair_start[N_CLASSES + 1];
  float sub_dt, contact_margin, collision_force;
  int has_x_semidim, has_y_semidim;
  float x_semidim, y_semidim;
};

namespace {

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

// A segment: centre, direction (cos, sin of its rotation), length.
struct Seg {
  float x, y, c, s, len;
};

__device__ __forceinline__ Seg make_seg(float x, float y, float rot,
                                        float len) {
  return Seg{x, y, cosf(rot), sinf(rot), len};
}

__device__ __forceinline__ void closest_on_seg(const Seg& g, float qx,
                                               float qy, float* ox,
                                               float* oy) {
  closest_on_line(g.x, g.y, g.c, g.s, g.len, qx, qy, ox, oy);
}

// geometry.all_lines_box: the 4 sides in the reference order (+length,
// -length, +width, -width).
__device__ __forceinline__ void box_sides(float bx, float by, float rot,
                                          float width, float length,
                                          Seg* sides) {
  float hc = cosf(rot), hs = sinf(rot);
  float prot = rot + 1.57079632679489662f;
  float pc = cosf(prot), ps = sinf(prot);
  float hl = length / 2.0f, hw = width / 2.0f;
  sides[0] = Seg{bx + hc * hl, by + hs * hl, pc, ps, width};
  sides[1] = Seg{bx - hc * hl, by - hs * hl, pc, ps, width};
  sides[2] = Seg{bx + pc * hw, by + ps * hw, hc, hs, length};
  sides[3] = Seg{bx - pc * hw, by - ps * hw, hc, hs, length};
}

// geometry.closest_point_box: first minimum over the 4 sides.
__device__ __forceinline__ void closest_on_box(float bx, float by, float rot,
                                               float width, float length,
                                               float qx, float qy, float* ox,
                                               float* oy) {
  Seg sides[4];
  box_sides(bx, by, rot, width, length, sides);
  float best_x = 0.0f, best_y = 0.0f, best_d = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float cx, cy;
    closest_on_seg(sides[k], qx, qy, &cx, &cy);
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

// geometry.closest_points_line_line: the closest point pair (on a, on b)
// of two segments: their intersection if they cross, else the first
// minimum of the 4 endpoint projections.
__device__ __forceinline__ void closest_seg_seg(const Seg& a, const Seg& b,
                                                float* pax, float* pay,
                                                float* pbx, float* pby) {
  // geometry.line_extrema
  const float ha = a.len / 2.0f, hb = b.len / 2.0f;
  const float hax = ha * a.c, hay = ha * a.s, hbx = hb * b.c, hby = hb * b.s;
  const float a1x = a.x + hax, a1y = a.y + hay, a2x = a.x - hax, a2y = a.y - hay;
  const float b1x = b.x + hbx, b1y = b.y + hby, b2x = b.x - hbx, b2y = b.y - hby;
  // geometry.intersection_line_line
  const float rx = a2x - a1x, ry = a2y - a1y;
  const float sx = b2x - b1x, sy = b2y - b1y;
  const float qpx = b1x - a1x, qpy = b1y - a1y;
  const float cross_qp_r = qpx * ry - qpy * rx;
  const float cross_qp_s = qpx * sy - qpy * sx;
  const float cross_r_s = rx * sy - ry * sx;
  const bool parallel = cross_r_s == 0.0f;
  const float den = parallel ? 1.0f : cross_r_s;
  const float u = parallel ? -1.0f : cross_qp_r / den;
  const float t = parallel ? -1.0f : cross_qp_s / den;
  const bool crossing = !parallel && (0.0f <= t) && (t <= 1.0f) &&
                        (0.0f <= u) && (u <= 1.0f);
  if (crossing) {
    const float ix = a1x + t * rx, iy = a1y + t * ry;
    *pax = ix;
    *pay = iy;
    *pbx = ix;
    *pby = iy;
    return;
  }
  // Candidates (on a, on b): a1, a2 projected on b; b1, b2 projected on a;
  // first minimum of their distances.
  float bax = a1x, bay = a1y, bbx, bby;
  closest_on_seg(b, a1x, a1y, &bbx, &bby);
  float best_d = safe_norm2(bax - bbx, bay - bby);
  auto consider = [&](float cax, float cay, float cbx, float cby) {
    const float dd = safe_norm2(cax - cbx, cay - cby);
    if (dd < best_d) {
      bax = cax;
      bay = cay;
      bbx = cbx;
      bby = cby;
      best_d = dd;
    }
  };
  float qx, qy;
  closest_on_seg(b, a2x, a2y, &qx, &qy);
  consider(a2x, a2y, qx, qy);
  closest_on_seg(a, b1x, b1y, &qx, &qy);
  consider(qx, qy, b1x, b1y);
  closest_on_seg(a, b2x, b2y, &qx, &qy);
  consider(qx, qy, b2x, b2y);
  *pax = bax;
  *pay = bay;
  *pbx = bbx;
  *pby = bby;
}

// geometry.closest_line_box: the closest (box point, segment point) pair,
// first minimum over the box's 4 sides.
__device__ __forceinline__ void closest_box_seg(const Seg* sides, const Seg& g,
                                                float* bx, float* by,
                                                float* gx, float* gy) {
  float best_d = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float p1x, p1y, p2x, p2y;
    closest_seg_seg(sides[k], g, &p1x, &p1y, &p2x, &p2y);
    const float dd = safe_norm2(p1x - p2x, p1y - p2y);
    if (k == 0 || dd < best_d) {
      best_d = dd;
      *bx = p1x;
      *by = p1y;
      *gx = p2x;
      *gy = p2y;
    }
  }
}

// geometry.closest_box_box: each side of a against box b, then each side
// of b against box a (8 candidates, reference order), first minimum.
__device__ __forceinline__ void closest_box_box(const Seg* sa, const Seg* sb,
                                                float* pax, float* pay,
                                                float* pbx, float* pby) {
  float best_d = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float onax, onay, onbx, onby;
    if (k < 4) {
      closest_box_seg(sb, sa[k], &onbx, &onby, &onax, &onay);
    } else {
      closest_box_seg(sa, sb[k - 4], &onax, &onay, &onbx, &onby);
    }
    const float dd = safe_norm2(onax - onbx, onay - onby);
    if (k == 0 || dd < best_d) {
      best_d = dd;
      *pax = onax;
      *pay = onay;
      *pbx = onbx;
      *pby = onby;
    }
  }
}

// World._inner_points: for a solid box, geometry.inner_point_box projects
// the surface contact point toward the box centre (cx, cy) along the
// outside-point->surface ray, and returns the extra contact distance; a
// degenerate ray gives surface + surface.  A hollow box keeps the surface
// point and no extra distance.
__device__ __forceinline__ void inner_point(bool hollow, float outx,
                                            float outy, float surfx,
                                            float surfy, float cx, float cy,
                                            float* ix, float* iy,
                                            float* extra) {
  if (hollow) {
    *ix = surfx;
    *iy = surfy;
    *extra = 0.0f;
    return;
  }
  const float v_x = surfx - outx, v_y = surfy - outy;
  const float u_x = cx - surfx, u_y = cy - surfy;
  const float vn = safe_norm2(v_x, v_y);
  const float safe = fmaxf(vn, 1e-12f);
  float x_mag = (v_x * u_x + v_y * u_y) / safe;
  float ox = v_x / safe * x_mag, oy = v_y / safe * x_mag;
  if (vn == 0.0f) {
    ox = surfx;
    oy = surfy;
    x_mag = 0.0f;
  }
  *ix = surfx + ox;
  *iy = surfy + oy;
  *extra = fabsf(x_mag);
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

  // Pair contributions: forces to movable entities, torques (r x f about
  // the entity's centre, TorchUtils.compute_torque) to rotatable ones, as
  // the plain version's incidence matrices mask them.
  auto add_force = [&](int i, float fx, float fy) {
    if (t.movable[i]) {
      cfx[i] += fx;
      cfy[i] += fy;
    }
  };
  auto add_torque = [&](int i, float rx, float ry, float fx, float fy) {
    if (t.rotatable[i]) ctq[i] += rx * fy - ry * fx;
  };

  const float dt = d.sub_dt;
  for (int substep = 0; substep < d.substeps; ++substep) {
    for (int i = 0; i < N; ++i) {
      cfx[i] = 0.0f;
      cfy[i] = 0.0f;
      ctq[i] = 0.0f;
    }

    // ---- sphere-sphere contacts (core.py:2294-2339) ---- //
    for (int p = d.pair_start[SS]; p < d.pair_start[SS + 1]; ++p) {
      const int a = t.pairs[2 * p], c = t.pairs[2 * p + 1];
      float fx, fy;
      soft_contact(px[a] - px[c], py[a] - py[c], t.radius[a] + t.radius[c], d,
                   &fx, &fy);
      add_force(a, fx, fy);
      add_force(c, -fx, -fy);
    }

    // ---- box-sphere contacts (core.py:2459-2552) ---- //
    for (int p = d.pair_start[BS]; p < d.pair_start[BS + 1]; ++p) {
      const int bi = t.pairs[2 * p], si = t.pairs[2 * p + 1];
      float clx, cly;
      closest_on_box(px[bi], py[bi], th[bi], t.width[bi], t.length[bi],
                     px[si], py[si], &clx, &cly);
      float ix, iy, d_extra;
      inner_point(t.hollow[bi], px[si], py[si], clx, cly, px[bi], py[bi], &ix,
                  &iy, &d_extra);
      float fx, fy;  // force on the sphere
      soft_contact(px[si] - ix, py[si] - iy,
                   t.radius[si] + VMT_LINE_MIN_DIST + d_extra, d, &fx, &fy);
      add_force(si, fx, fy);
      add_force(bi, -fx, -fy);
      add_torque(bi, clx - px[bi], cly - py[bi], -fx, -fy);
    }

    // ---- line-sphere contacts (core.py:2341-2392) ---- //
    for (int p = d.pair_start[LS]; p < d.pair_start[LS + 1]; ++p) {
      const int li = t.pairs[2 * p], si = t.pairs[2 * p + 1];
      const Seg line = make_seg(px[li], py[li], th[li], t.length[li]);
      float clx, cly;
      closest_on_seg(line, px[si], py[si], &clx, &cly);
      float fx, fy;  // force on the sphere
      soft_contact(px[si] - clx, py[si] - cly,
                   t.radius[si] + VMT_LINE_MIN_DIST, d, &fx, &fy);
      add_force(si, fx, fy);
      add_force(li, -fx, -fy);
      add_torque(li, clx - px[li], cly - py[li], -fx, -fy);
    }

    // ---- line-line contacts (core.py:2394-2457) ---- //
    for (int p = d.pair_start[LL]; p < d.pair_start[LL + 1]; ++p) {
      const int ia = t.pairs[2 * p], ib = t.pairs[2 * p + 1];
      float pax, pay, pbx, pby;
      closest_seg_seg(make_seg(px[ia], py[ia], th[ia], t.length[ia]),
                      make_seg(px[ib], py[ib], th[ib], t.length[ib]), &pax,
                      &pay, &pbx, &pby);
      float fx, fy;  // force on a
      soft_contact(pax - pbx, pay - pby, VMT_LINE_MIN_DIST, d, &fx, &fy);
      add_force(ia, fx, fy);
      add_force(ib, -fx, -fy);
      add_torque(ia, pax - px[ia], pay - py[ia], fx, fy);
      add_torque(ib, pbx - px[ib], pby - py[ib], -fx, -fy);
    }

    // ---- box-line contacts (core.py:2554-2653) ---- //
    for (int p = d.pair_start[BL]; p < d.pair_start[BL + 1]; ++p) {
      const int bi = t.pairs[2 * p], li = t.pairs[2 * p + 1];
      Seg sides[4];
      box_sides(px[bi], py[bi], th[bi], t.width[bi], t.length[bi], sides);
      float pbx, pby, plx, ply;
      closest_box_seg(sides, make_seg(px[li], py[li], th[li], t.length[li]),
                      &pbx, &pby, &plx, &ply);
      float ix, iy, d_extra;
      inner_point(t.hollow[bi], plx, ply, pbx, pby, px[bi], py[bi], &ix, &iy,
                  &d_extra);
      float fx, fy;  // force on the box
      soft_contact(ix - plx, iy - ply, VMT_LINE_MIN_DIST + d_extra, d, &fx,
                   &fy);
      add_force(bi, fx, fy);
      add_force(li, -fx, -fy);
      add_torque(bi, pbx - px[bi], pby - py[bi], fx, fy);
      add_torque(li, plx - px[li], ply - py[li], -fx, -fy);
    }

    // ---- box-box contacts (core.py:2655-2786) ---- //
    for (int p = d.pair_start[BB]; p < d.pair_start[BB + 1]; ++p) {
      const int ia = t.pairs[2 * p], ib = t.pairs[2 * p + 1];
      Seg sa[4], sb[4];
      box_sides(px[ia], py[ia], th[ia], t.width[ia], t.length[ia], sa);
      box_sides(px[ib], py[ib], th[ib], t.width[ib], t.length[ib], sb);
      float pax, pay, pbx, pby;
      closest_box_box(sa, sb, &pax, &pay, &pbx, &pby);
      float iax, iay, da, ibx, iby, db;
      inner_point(t.hollow[ia], pbx, pby, pax, pay, px[ia], py[ia], &iax, &iay,
                  &da);
      inner_point(t.hollow[ib], pax, pay, pbx, pby, px[ib], py[ib], &ibx, &iby,
                  &db);
      float fx, fy;  // force on a
      soft_contact(iax - ibx, iay - iby, da + db + VMT_LINE_MIN_DIST, d, &fx,
                   &fy);
      add_force(ia, fx, fy);
      add_force(ib, -fx, -fy);
      add_torque(ia, pax - px[ia], pay - py[ia], fx, fy);
      add_torque(ib, pbx - px[ib], pby - py[ib], -fx, -fy);
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

// Plain C entry point, loaded with ctypes.  Every tensor pointer is a
// device pointer to a contiguous tensor the caller has checked; `t` and `d`
// are host pointers to the world's Tables and Dims, built once at
// finalize.  The launch goes on `stream` (PyTorch's current stream).
// Returns cudaGetLastError() after the launch, 0 on success; it does not
// synchronise.
extern "C" int vmt_physics_step(
    const float* pos, const float* vel, const float* rot, const float* ang_vel,
    const float* force_a, const float* torque_a, const float* dyn_g,
    float* out_pos, float* out_vel, float* out_rot, float* out_ang_vel,
    const Tables* t, const Dims* d, void* stream) {
  if (d->N > VMT_MAX_ENTITIES || d->B <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (d->B + VMT_THREADS - 1) / VMT_THREADS;
  physics_step_kernel<<<blocks, VMT_THREADS, 0, (cudaStream_t)stream>>>(
      pos, vel, rot, ang_vel, force_a, torque_a, dyn_g, out_pos, out_vel,
      out_rot, out_ang_vel, *t, *d);
  return (int)cudaGetLastError();
}
