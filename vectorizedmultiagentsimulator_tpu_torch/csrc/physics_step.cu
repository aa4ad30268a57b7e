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
// angular friction; the joint constraints (the attractive and the
// repulsive soft force between the two anchor points, their lever-arm
// torques, and the fixed-rotation torque of constraints that do not
// rotate, physics_pallas.py:366-402); the soft contacts of all six pair
// classes: sphere-sphere (ss), box-sphere (bs), line-sphere (ls),
// line-line (ll), box-line (bl) and box-box (bb), boxes solid or hollow;
// drag on substep 0; semi-implicit Euler with the max_speed, v_range and
// x/y semidim clamps, over every substep.  Worlds with per-env mass or a
// per-env joint fixed rotation step through the plain version
// (physics_cuda.step_supported decides at finalize).
//
// What bounds it on the H100.  An env moves its state in and out once
// (transport: about 340 B, 10 MB at 30k envs, a few microseconds at
// 3.35 TB/s); the arithmetic is n_pairs x substeps per env (a box-box pair
// is 32 segment-segment tests, a box-line pair 4, a joint constraint about
// three sphere-sphere pairs): joint_passage (23 entities, 10 substeps, 54
// pairs, 3 constraints) is about 7.5e4 operations an env, 0.03 ms of the
// card's fp32 rate at 30k envs.  What held the first design back (one
// thread an env) was latency: twelve per-thread entity arrays
// indexed through the pair table lived in local memory (a 3,104-byte
// stack), 30k envs were only about 7 warps an SM to hide it, neighbouring
// threads read state N x 8 bytes apart, and the static tables were read
// from global memory inside the loops.
//
// Design.  A group of `lanes` threads (a power of two up to 8; Dims::lanes,
// chosen at finalize from the world's weighted pair cost) steps one env,
// and a block of 32 x lanes threads steps 32 envs: warp l holds lane l of
// all 32 envs, so the 32 threads of a warp always work on the same pair or
// constraint of 32 envs, as one thread an env did, and no warp diverges on
// which item it takes.  The block's shared memory holds the static tables
// (loaded once a block), its envs' state (sized by the world's N, envs at
// an odd stride so the same entity of the warp's 32 envs sits in 32
// distinct banks) and one row of per-entity force/torque sums per lane and
// env.  State is read and written through shared memory as the contiguous
// runs of the native [B, N, 2] / [B, N] tensors that the block's envs
// cover, neighbouring threads on neighbouring words.  Each substep the
// lanes take the joint constraints and then the pairs of each class in
// table order round-robin (item k to lane k % lanes), each adding into its
// own row; then each lane integrates the entities i = lane, lane + lanes,
// ... with the rows added in lane order, and refreshes the cos and sin of
// each entity's rotation (and of it + pi/2) that every pair of the next
// substep reads, where each pair computed its own before: most of the
// operations of a box or line pair were those cosf/sinf.  No atomics: two
// launches give the same bits, and lanes = 1 gives the first design's sums
// in its order.
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
// sums (the plain version sums pair contributions with a matmul; here
// each lane's items in order, then the lanes in order).  A joint world is
// stiff (joint_force 900 over 10-15 substeps), so that difference grows
// about 2x a substep there.
//
// Compiled as host C++ (no __CUDACC__), the same phases run as loops over
// the thread index, block after block, which is how the CPU tests run
// this source.

#include <cmath>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define DEV __device__ __forceinline__
#define HD __host__ __device__ __forceinline__
#define PHASE_BEGIN { const int tid = threadIdx.x;
#define PHASE_END } __syncthreads();

#else
#include <cstddef>
#include <vector>
#define DEV inline
#define HD inline
#define PHASE_BEGIN for (int tid = 0; tid < VMT_WARP * d.lanes; ++tid) {
#define PHASE_END }
using std::isfinite;
#endif

#define VMT_MAX_ENTITIES 64
#define VMT_WARP 32      // envs a block: one a thread of each warp
#define VMT_MAX_LANES 8  // warps a block
// Blocks of VMT_MAX_LANES warps an SM that the register budget is set for
// (__launch_bounds__): 2 caps a thread at 128 registers, without spills;
// 3 and 4 (80 and 64 registers) spilled and ran slower on the H100.
#define VMT_MIN_BLOCKS 2
#define VMT_MAX_SMEM_BYTES 232448
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
  // [J, 3] per joint constraint: entity a, entity b, rotate (0/1).
  const int* joint_idx;
  // [J, 6] per joint constraint: anchor offset of a (x, y) and of b
  // (x, y) in the entity's frame, rest distance, static fixed rotation.
  const float* joint_geom;
};

// Sizes and scalars, mirrored as _Dims in ops/physics_cuda.py.
struct Dims {
  int B, N, A, n_landmarks, D, substeps, J;
  // Class c's pairs are the rows [pair_start[c], pair_start[c + 1]).
  int pair_start[N_CLASSES + 1];
  float sub_dt, contact_margin, collision_force, joint_force,
      torque_constraint_force;
  int has_x_semidim, has_y_semidim;
  float x_semidim, y_semidim;
  // Threads per env: a power of two up to 32 (physics_cuda.lane_group).
  int lanes;
};

namespace {

// TorchUtils.safe_norm of (x, y): 0 at the zero vector.
DEV float safe_norm2(float x, float y) {
  float sq = x * x + y * y;
  return sq > 0.0f ? sqrtf(sq) : 0.0f;
}

// World._constraint_forces: soft force on entity a along (dx, dy) =
// pos_a - pos_b, times `mult`; entity b gets its negation.  Repulsive, it
// is zero beyond dist_min; attractive (joints), inside it.
DEV void constraint_force(float dx, float dy, float dist_min, float mult,
                          bool attractive, const Dims& d, float* fx,
                          float* fy) {
  const float sign = attractive ? -1.0f : 1.0f;
  float dist = safe_norm2(dx, dy);
  float x = (dist_min - dist) * sign / d.contact_margin;
  float pen = (fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)))) * d.contact_margin;
  float den = dist > 0.0f ? dist : 1e-8f;
  bool far = attractive ? (dist < dist_min) : (dist > dist_min);
  bool zero = (dist < 1e-6f) || far;
  const float sm = sign * mult;
  *fx = zero ? 0.0f : sm * dx / den * pen;
  *fy = zero ? 0.0f : sm * dy / den * pen;
}

// The repulsive contact force of the six pair classes.
DEV void soft_contact(float dx, float dy, float dist_min, const Dims& d,
                      float* fx, float* fy) {
  constraint_force(dx, dy, dist_min, d.collision_force, false, d, fx, fy);
}

// geometry.closest_point_line: closest point on a segment given by its
// centre, rotation and length to the query point (qx, qy).
DEV void closest_on_line(float lx, float ly, float c, float s, float len,
                         float qx, float qy, float* ox, float* oy) {
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

// An entity's pose: centre, cos and sin of its rotation and of its
// rotation + pi/2 (what geometry.all_lines_box turns a box's sides by),
// computed once a substep per entity; every pair reads the same bits.
struct Pose {
  float x, y, c, s, pc, ps;
};

DEV void trig(float rot, float* c, float* s, float* pc, float* ps) {
  *c = cosf(rot);
  *s = sinf(rot);
  const float prot = rot + 1.57079632679489662f;
  *pc = cosf(prot);
  *ps = sinf(prot);
}

DEV Seg make_seg(const Pose& p, float len) { return Seg{p.x, p.y, p.c, p.s, len}; }

DEV void closest_on_seg(const Seg& g, float qx, float qy, float* ox,
                        float* oy) {
  closest_on_line(g.x, g.y, g.c, g.s, g.len, qx, qy, ox, oy);
}

// geometry.all_lines_box: the 4 sides in the reference order (+length,
// -length, +width, -width).
DEV void box_sides(const Pose& p, float width, float length, Seg* sides) {
  const float bx = p.x, by = p.y, hc = p.c, hs = p.s, pc = p.pc, ps = p.ps;
  float hl = length / 2.0f, hw = width / 2.0f;
  sides[0] = Seg{bx + hc * hl, by + hs * hl, pc, ps, width};
  sides[1] = Seg{bx - hc * hl, by - hs * hl, pc, ps, width};
  sides[2] = Seg{bx + pc * hw, by + ps * hw, hc, hs, length};
  sides[3] = Seg{bx - pc * hw, by - ps * hw, hc, hs, length};
}

// geometry.closest_point_box: first minimum over the 4 sides.
DEV void closest_on_box(const Pose& p, float width, float length, float qx,
                        float qy, float* ox, float* oy) {
  Seg sides[4];
  box_sides(p, width, length, sides);
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
DEV void closest_seg_seg(const Seg& a, const Seg& b, float* pax, float* pay,
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
DEV void closest_box_seg(const Seg* sides, const Seg& g, float* bx, float* by,
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
DEV void closest_box_box(const Seg* sa, const Seg* sb, float* pax, float* pay,
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
DEV void inner_point(bool hollow, float outx, float outy, float surfx,
                     float surfy, float cx, float cy, float* ix, float* iy,
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

// ---- The block's shared memory ---- //
//
// The world's static tables, loaded once a block, then the state of the
// block's E = VMT_WARP envs, one array a field with the envs at a stride of
// NS = N | 1 words (odd: the same entity of a warp's envs falls in distinct
// banks), then each lane's per-entity force and torque sums of the current
// substep, [lanes][3][E][NS].  Ints and floats live in regions of their
// own.  Both the card and the host build carve it with `carve`.
struct Shared {
  int *movable, *rotatable, *dyn_row, *hollow, *pairs, *joint_idx;
  float *mass, *moment, *drag, *max_speed, *v_range, *gravity, *radius,
      *length, *width, *lin_fric, *ang_fric, *joint_geom;
  // [E * NS] each; ct, st, cp, sp: cos and sin of th and of th + pi/2
  float *px, *py, *vx, *vy, *th, *w, *bfx, *bfy, *btq, *ct, *st, *cp, *sp;
  // [lanes][3][E][NS]: fx, fy, torque sums
  float* part;
};

HD int n_pairs(const Dims& d) { return d.pair_start[N_CLASSES]; }
HD int env_stride(const Dims& d) { return d.N | 1; }
HD int envs_per_block(const Dims&) { return VMT_WARP; }

HD int int_words(const Dims& d) { return 4 * d.N + 2 * n_pairs(d) + 3 * d.J; }

HD int float_words(const Dims& d) {
  const int E = envs_per_block(d), NS = env_stride(d);
  return 12 * d.N + 6 * d.J + 13 * E * NS + E * d.lanes * 3 * NS;
}

HD int shared_bytes(const Dims& d) {
  return 4 * (int_words(d) + float_words(d));
}

DEV Shared carve(void* base, const Dims& d) {
  Shared s;
  const int N = d.N, E = envs_per_block(d), NS = env_stride(d);
  int* ip = static_cast<int*>(base);
  s.movable = ip; ip += N;
  s.rotatable = ip; ip += N;
  s.dyn_row = ip; ip += N;
  s.hollow = ip; ip += N;
  s.pairs = ip; ip += 2 * n_pairs(d);
  s.joint_idx = ip; ip += 3 * d.J;
  float* fp = reinterpret_cast<float*>(ip);
  s.mass = fp; fp += N;
  s.moment = fp; fp += N;
  s.drag = fp; fp += N;
  s.max_speed = fp; fp += N;
  s.v_range = fp; fp += N;
  s.gravity = fp; fp += 2 * N;
  s.radius = fp; fp += N;
  s.length = fp; fp += N;
  s.width = fp; fp += N;
  s.lin_fric = fp; fp += N;
  s.ang_fric = fp; fp += N;
  s.joint_geom = fp; fp += 6 * d.J;
  float** fields[13] = {&s.px, &s.py, &s.vx, &s.vy, &s.th, &s.w, &s.bfx,
                        &s.bfy, &s.btq, &s.ct, &s.st, &s.cp, &s.sp};
  for (int f = 0; f < 13; ++f) {
    *fields[f] = fp;
    fp += E * NS;
  }
  s.part = fp;
  return s;
}

// One env's view: its entities' state (pointers offset to the env) and one
// lane's sums.
struct EnvView {
  const float *px, *py, *th, *ct, *st, *cp, *sp;
  float *cfx, *cfy, *ctq;
};

DEV Pose pose(const EnvView& v, int i) {
  return Pose{v.px[i], v.py[i], v.ct[i], v.st[i], v.cp[i], v.sp[i]};
}

// Pair contributions: forces to movable entities, torques (r x f about the
// entity's centre, TorchUtils.compute_torque) to rotatable ones, as the
// plain version's incidence matrices mask them.
DEV void add_force(const Shared& s, const EnvView& v, int i, float fx,
                   float fy) {
  if (s.movable[i]) {
    v.cfx[i] += fx;
    v.cfy[i] += fy;
  }
}

DEV void add_torque(const Shared& s, const EnvView& v, int i, float rx,
                    float ry, float fx, float fy) {
  if (s.rotatable[i]) v.ctq[i] += rx * fy - ry * fx;
}

// Joint constraint j (core.py:2201-2292).
DEV void joint_item(int j, const Shared& s, const EnvView& v, const Dims& d) {
  const float *px = v.px, *py = v.py, *th = v.th;
  const int ia = s.joint_idx[3 * j], ib = s.joint_idx[3 * j + 1];
  const bool rotate = s.joint_idx[3 * j + 2] != 0;
  const float* g = s.joint_geom + 6 * j;
  // TorchUtils.rotate_vector of each anchor offset, added to the centre.
  const float ca = v.ct[ia], sa = v.st[ia];
  const float cb = v.ct[ib], sb = v.st[ib];
  const float pjax = px[ia] + (g[0] * ca - g[1] * sa);
  const float pjay = py[ia] + (g[0] * sa + g[1] * ca);
  const float pjbx = px[ib] + (g[2] * cb - g[3] * sb);
  const float pjby = py[ib] + (g[2] * sb + g[3] * cb);
  float fx1, fy1, fx2, fy2;  // attractive, repulsive; on a
  constraint_force(pjax - pjbx, pjay - pjby, g[4], d.joint_force, true, d,
                   &fx1, &fy1);
  constraint_force(pjax - pjbx, pjay - pjby, g[4], d.joint_force, false, d,
                   &fx2, &fy2);
  const float fx = fx1 + fx2, fy = fy1 + fy2;
  add_force(s, v, ia, fx, fy);
  add_force(s, v, ib, -fx, -fy);
  // Lever-arm torques r x f, r = anchor point - centre.
  const float rax = pjax - px[ia], ray = pjay - py[ia];
  const float rbx = pjbx - px[ib], rby = pjby - py[ib];
  float ta = rax * fy - ray * fx;
  float tb = rbx * (-fy) - rby * (-fx);
  if (!rotate) {
    // World._constraint_torques with rot_b + fixed rotation.
    const float dr = th[ia] - (th[ib] + g[5]);
    const float adr = safe_norm2(dr, 0.0f);
    const float sgn = (dr > 0.0f) ? 1.0f : ((dr < 0.0f) ? -1.0f : 0.0f);
    float tq = d.torque_constraint_force * sgn * (expf(adr) - 1.0f);
    if (adr < 1e-9f) tq = 0.0f;
    ta = ta + -tq;
    tb = tb + tq;
  }
  if (s.rotatable[ia]) v.ctq[ia] += ta;
  if (s.rotatable[ib]) v.ctq[ib] += tb;
}

// Row p of the packed pair table, of whichever class it belongs to.
DEV void pair_item(int p, const Shared& s, const EnvView& v, const Dims& d) {
  const float *px = v.px, *py = v.py;
  const int ia = s.pairs[2 * p], ib = s.pairs[2 * p + 1];
  if (p < d.pair_start[SS + 1]) {
    // sphere-sphere (core.py:2294-2339)
    float fx, fy;
    soft_contact(px[ia] - px[ib], py[ia] - py[ib],
                 s.radius[ia] + s.radius[ib], d, &fx, &fy);
    add_force(s, v, ia, fx, fy);
    add_force(s, v, ib, -fx, -fy);
  } else if (p < d.pair_start[BS + 1]) {
    // box-sphere (core.py:2459-2552)
    const int bi = ia, si = ib;
    float clx, cly;
    closest_on_box(pose(v, bi), s.width[bi], s.length[bi], px[si], py[si],
                   &clx, &cly);
    float ix, iy, d_extra;
    inner_point(s.hollow[bi], px[si], py[si], clx, cly, px[bi], py[bi], &ix,
                &iy, &d_extra);
    float fx, fy;  // force on the sphere
    soft_contact(px[si] - ix, py[si] - iy,
                 s.radius[si] + VMT_LINE_MIN_DIST + d_extra, d, &fx, &fy);
    add_force(s, v, si, fx, fy);
    add_force(s, v, bi, -fx, -fy);
    add_torque(s, v, bi, clx - px[bi], cly - py[bi], -fx, -fy);
  } else if (p < d.pair_start[LS + 1]) {
    // line-sphere (core.py:2341-2392)
    const int li = ia, si = ib;
    const Seg line = make_seg(pose(v, li), s.length[li]);
    float clx, cly;
    closest_on_seg(line, px[si], py[si], &clx, &cly);
    float fx, fy;  // force on the sphere
    soft_contact(px[si] - clx, py[si] - cly, s.radius[si] + VMT_LINE_MIN_DIST,
                 d, &fx, &fy);
    add_force(s, v, si, fx, fy);
    add_force(s, v, li, -fx, -fy);
    add_torque(s, v, li, clx - px[li], cly - py[li], -fx, -fy);
  } else if (p < d.pair_start[LL + 1]) {
    // line-line (core.py:2394-2457)
    float pax, pay, pbx, pby;
    closest_seg_seg(make_seg(pose(v, ia), s.length[ia]),
                    make_seg(pose(v, ib), s.length[ib]), &pax, &pay, &pbx,
                    &pby);
    float fx, fy;  // force on a
    soft_contact(pax - pbx, pay - pby, VMT_LINE_MIN_DIST, d, &fx, &fy);
    add_force(s, v, ia, fx, fy);
    add_force(s, v, ib, -fx, -fy);
    add_torque(s, v, ia, pax - px[ia], pay - py[ia], fx, fy);
    add_torque(s, v, ib, pbx - px[ib], pby - py[ib], -fx, -fy);
  } else if (p < d.pair_start[BL + 1]) {
    // box-line (core.py:2554-2653)
    const int bi = ia, li = ib;
    Seg sides[4];
    box_sides(pose(v, bi), s.width[bi], s.length[bi], sides);
    float pbx, pby, plx, ply;
    closest_box_seg(sides, make_seg(pose(v, li), s.length[li]),
                    &pbx, &pby, &plx, &ply);
    float ix, iy, d_extra;
    inner_point(s.hollow[bi], plx, ply, pbx, pby, px[bi], py[bi], &ix, &iy,
                &d_extra);
    float fx, fy;  // force on the box
    soft_contact(ix - plx, iy - ply, VMT_LINE_MIN_DIST + d_extra, d, &fx, &fy);
    add_force(s, v, bi, fx, fy);
    add_force(s, v, li, -fx, -fy);
    add_torque(s, v, bi, pbx - px[bi], pby - py[bi], fx, fy);
    add_torque(s, v, li, plx - px[li], ply - py[li], -fx, -fy);
  } else {
    // box-box (core.py:2655-2786)
    Seg sa[4], sb[4];
    box_sides(pose(v, ia), s.width[ia], s.length[ia], sa);
    box_sides(pose(v, ib), s.width[ib], s.length[ib], sb);
    float pax, pay, pbx, pby;
    closest_box_box(sa, sb, &pax, &pay, &pbx, &pby);
    float iax, iay, da, ibx, iby, db;
    inner_point(s.hollow[ia], pbx, pby, pax, pay, px[ia], py[ia], &iax, &iay,
                &da);
    inner_point(s.hollow[ib], pax, pay, pbx, pby, px[ib], py[ib], &ibx, &iby,
                &db);
    float fx, fy;  // force on a
    soft_contact(iax - ibx, iay - iby, da + db + VMT_LINE_MIN_DIST, d, &fx,
                 &fy);
    add_force(s, v, ia, fx, fy);
    add_force(s, v, ib, -fx, -fy);
    add_torque(s, v, ia, pax - px[ia], pay - py[ia], fx, fy);
    add_torque(s, v, ib, pbx - px[ib], pby - py[ib], -fx, -fy);
  }
}

// Forces, then semi-implicit Euler for entity i of env e (core.py:2860-2908):
// the lanes' sums added in lane order.
DEV void integrate(int e, int i, int substep, const Shared& s, const Dims& d) {
  const int G = d.lanes, NS = env_stride(d), at = e * NS + i;
  const int C = VMT_WARP * NS;  // from one sum to the next
  const float* part = s.part + e * NS + i;
  float cfx = part[0], cfy = part[C], ctq = part[2 * C];
  for (int l = 1; l < G; ++l) {
    const float* q = part + l * 3 * C;
    cfx = cfx + q[0];
    cfy = cfy + q[C];
    ctq = ctq + q[2 * C];
  }
  const float dt = d.sub_dt;
  float vx = s.vx[at], vy = s.vy[at], w = s.w[at];
  float fx = s.bfx[at], fy = s.bfy[at], tq = s.btq[at];
  // static/kinetic friction (core.py:2054-2073)
  if (s.lin_fric[i] > 0.0f) {
    const float speed = safe_norm2(vx, vy);
    if (speed != 0.0f) {
      const float fc = s.lin_fric[i] * s.mass[i];
      fx = fx + -(vx / speed) * fminf(fc, fabsf(vx) / dt * s.mass[i]);
      fy = fy + -(vy / speed) * fminf(fc, fabsf(vy) / dt * s.mass[i]);
    }
  }
  if (s.ang_fric[i] > 0.0f) {
    const float aspeed = safe_norm2(w, 0.0f);
    if (aspeed != 0.0f) {
      const float tc = s.ang_fric[i] * s.moment[i];
      tq = tq + -(w / aspeed) * fminf(tc, fabsf(w) / dt * s.moment[i]);
    }
  }
  fx = fx + cfx;
  fy = fy + cfy;
  tq = tq + ctq;

  if (s.movable[i]) {
    if (substep == 0) {
      const float keep = 1.0f - s.drag[i];
      vx = vx * keep;
      vy = vy * keep;
    }
    float nvx = vx + fx / s.mass[i] * dt;
    float nvy = vy + fy / s.mass[i] * dt;
    const float ms = s.max_speed[i];
    if (isfinite(ms)) {
      const float n = safe_norm2(nvx, nvy);
      if (n > ms) {
        const float safe = fmaxf(n, 1e-12f);
        nvx = nvx / safe * ms;
        nvy = nvy / safe * ms;
      }
    }
    const float vr = s.v_range[i];
    if (isfinite(vr)) {
      nvx = fminf(fmaxf(nvx, -vr), vr);
      nvy = fminf(fmaxf(nvy, -vr), vr);
    }
    s.vx[at] = nvx;
    s.vy[at] = nvy;
    float npx = s.px[at] + nvx * dt;
    float npy = s.py[at] + nvy * dt;
    if (d.has_x_semidim) npx = fminf(fmaxf(npx, -d.x_semidim), d.x_semidim);
    if (d.has_y_semidim) npy = fminf(fmaxf(npy, -d.y_semidim), d.y_semidim);
    s.px[at] = npx;
    s.py[at] = npy;
  }
  if (s.rotatable[i]) {
    if (substep == 0) w = w * (1.0f - s.drag[i]);
    w = w + tq / s.moment[i] * dt;
    s.w[at] = w;
    s.th[at] = s.th[at] + w * dt;
    trig(s.th[at], s.ct + at, s.st + at, s.cp + at, s.sp + at);
  }
}

// Everything one block does for its envs [block * E, block * E + E): the
// body is a sequence of phases over the block's threads, each ended by a
// barrier; no thread reads in a phase what another thread writes in it.
// Thread tid is lane tid / 32 of env tid % 32.  Built as host C++, a phase
// is a loop over the thread index.
DEV void block_body(int block, void* smem, const float* __restrict__ pos,
                    const float* __restrict__ vel,
                    const float* __restrict__ rot,
                    const float* __restrict__ ang_vel,
                    const float* __restrict__ force_a,
                    const float* __restrict__ torque_a,
                    const float* __restrict__ dyn_g,
                    float* __restrict__ out_pos, float* __restrict__ out_vel,
                    float* __restrict__ out_rot,
                    float* __restrict__ out_ang_vel, const Tables& t,
                    const Dims& d) {
  const Shared s = carve(smem, d);
  const int N = d.N, G = d.lanes, E = envs_per_block(d), NS = env_stride(d);
  const int NTH = VMT_WARP * G;  // threads
  const size_t b0 = (size_t)block * E;
  const int nE = (int)(d.B - b0 < (size_t)E ? d.B - b0 : E);
  const int P = n_pairs(d);

  // The static tables, and the envs' state read as the contiguous runs
  // [b0 N, (b0 + nE) N) of the native layouts, neighbouring threads on
  // neighbouring words.
  PHASE_BEGIN
    for (int i = tid; i < N; i += NTH) {
      s.movable[i] = t.movable[i];
      s.rotatable[i] = t.rotatable[i];
      s.dyn_row[i] = t.dyn_row[i];
      s.hollow[i] = t.hollow[i];
      s.mass[i] = t.mass[i];
      s.moment[i] = t.moment[i];
      s.drag[i] = t.drag[i];
      s.max_speed[i] = t.max_speed[i];
      s.v_range[i] = t.v_range[i];
      s.radius[i] = t.radius[i];
      s.length[i] = t.length[i];
      s.width[i] = t.width[i];
      s.lin_fric[i] = t.lin_fric[i];
      s.ang_fric[i] = t.ang_fric[i];
    }
    for (int i = tid; i < 2 * N; i += NTH) s.gravity[i] = t.gravity[i];
    for (int i = tid; i < 2 * P; i += NTH) s.pairs[i] = t.pairs[i];
    for (int i = tid; i < 3 * d.J; i += NTH)
      s.joint_idx[i] = t.joint_idx[i];
    for (int i = tid; i < 6 * d.J; i += NTH)
      s.joint_geom[i] = t.joint_geom[i];
    for (int k = tid; k < 2 * nE * N; k += NTH) {
      const int e = k / (2 * N), r = k - e * 2 * N, at = e * NS + (r >> 1);
      const float p = pos[b0 * 2 * N + k], v = vel[b0 * 2 * N + k];
      if (r & 1) {
        s.py[at] = p;
        s.vy[at] = v;
      } else {
        s.px[at] = p;
        s.vx[at] = v;
      }
    }
    for (int k = tid; k < nE * N; k += NTH) {
      const int e = k / N, at = e * NS + (k - e * N);
      s.th[at] = rot[b0 * N + k];
      s.w[at] = ang_vel[b0 * N + k];
    }
  PHASE_END

  // Forces that stay fixed over the substeps: action force/torque
  // (landmarks get none; immovable agents masked), then gravity: static
  // table x mass, plus the per-env dyn_gravity row.
  PHASE_BEGIN
    for (int k = tid; k < nE * N; k += NTH) {
      const int e = k / N, i = k - e * N, at = e * NS + i;
      const size_t b = b0 + e;
      float fx = 0.0f, fy = 0.0f, tq = 0.0f;
      const int j = i - d.n_landmarks;
      if (j >= 0 && j < d.A) {
        const size_t ab = b * d.A + j;
        if (s.movable[i]) {
          fx = force_a[ab * 2];
          fy = force_a[ab * 2 + 1];
        }
        if (s.rotatable[i]) tq = torque_a[ab];
      }
      if (s.movable[i]) {
        float gx = s.gravity[2 * i] * s.mass[i];
        float gy = s.gravity[2 * i + 1] * s.mass[i];
        const int r = s.dyn_row[i];
        if (r >= 0) {
          const size_t gb = (b * d.D + r) * 2;
          gx = gx + dyn_g[gb] * s.mass[i];
          gy = gy + dyn_g[gb + 1] * s.mass[i];
        }
        fx = fx + gx;
        fy = fy + gy;
      }
      s.bfx[at] = fx;
      s.bfy[at] = fy;
      s.btq[at] = tq;
      trig(s.th[at], s.ct + at, s.st + at, s.cp + at, s.sp + at);
    }
  PHASE_END

  for (int substep = 0; substep < d.substeps; ++substep) {
    // Each lane zeroes its own sums, then takes the items l, l + G, ... of
    // the list (joint constraints, then the pair classes in table order).
    PHASE_BEGIN
      const int e = tid % VMT_WARP, l = tid / VMT_WARP;
      if (e < nE) {
        const int C = VMT_WARP * NS;
        float* own = s.part + l * 3 * C + e * NS;
        for (int i = 0; i < N; ++i) {
          own[i] = 0.0f;
          own[C + i] = 0.0f;
          own[2 * C + i] = 0.0f;
        }
        const EnvView v{s.px + e * NS, s.py + e * NS, s.th + e * NS,
                        s.ct + e * NS, s.st + e * NS, s.cp + e * NS,
                        s.sp + e * NS, own, own + C, own + 2 * C};
        for (int k = l; k < d.J + P; k += G) {
          if (k < d.J)
            joint_item(k, s, v, d);
          else
            pair_item(k - d.J, s, v, d);
        }
      }
    PHASE_END
    PHASE_BEGIN
      const int e = tid % VMT_WARP, l = tid / VMT_WARP;
      if (e < nE)
        for (int i = l; i < N; i += G) integrate(e, i, substep, s, d);
    PHASE_END
  }

  PHASE_BEGIN
    for (int k = tid; k < 2 * nE * N; k += NTH) {
      const int e = k / (2 * N), r = k - e * 2 * N, at = e * NS + (r >> 1);
      out_pos[b0 * 2 * N + k] = (r & 1) ? s.py[at] : s.px[at];
      out_vel[b0 * 2 * N + k] = (r & 1) ? s.vy[at] : s.vx[at];
    }
    for (int k = tid; k < nE * N; k += NTH) {
      const int e = k / N, at = e * NS + (k - e * N);
      out_rot[b0 * N + k] = s.th[at];
      out_ang_vel[b0 * N + k] = s.w[at];
    }
  PHASE_END
}

// What the kernel takes (host and device): at most VMT_MAX_ENTITIES
// entities, lanes a power of two up to VMT_MAX_LANES, a block's shared
// memory within the card's.
HD bool dims_ok(const Dims& d) {
  return d.N <= VMT_MAX_ENTITIES && d.N > 0 && d.B > 0 && d.lanes >= 1 &&
         d.lanes <= VMT_MAX_LANES && (d.lanes & (d.lanes - 1)) == 0 &&
         shared_bytes(d) <= VMT_MAX_SMEM_BYTES;
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(VMT_WARP * VMT_MAX_LANES, VMT_MIN_BLOCKS)
physics_step_kernel(const float* __restrict__ pos, const float* __restrict__ vel,
                    const float* __restrict__ rot,
                    const float* __restrict__ ang_vel,
                    const float* __restrict__ force_a,
                    const float* __restrict__ torque_a,
                    const float* __restrict__ dyn_g, float* __restrict__ out_pos,
                    float* __restrict__ out_vel, float* __restrict__ out_rot,
                    float* __restrict__ out_ang_vel, Tables t, Dims d) {
  extern __shared__ float4 smem4[];
  block_body(blockIdx.x, smem4, pos, vel, rot, ang_vel, force_a, torque_a,
             dyn_g, out_pos, out_vel, out_rot, out_ang_vel, t, d);
}
#endif

}  // namespace

// A block's shared memory for these Dims (bytes), for the wrapper and the
// tests; 0 if the kernel does not take them.
extern "C" int vmt_physics_smem_bytes(const Dims* d) {
  return dims_ok(*d) ? shared_bytes(*d) : 0;
}

// Plain C entry point, loaded with ctypes.  Every tensor pointer is a
// device pointer to a contiguous tensor the caller has checked; `t` and `d`
// are host pointers to the world's Tables and Dims, built once at
// finalize.  The launch goes on `stream` (PyTorch's current stream).
// Returns cudaGetLastError() after the launch, 0 on success; it does not
// synchronise.  Built as host C++, the pointers are host pointers, the
// blocks run one after the other and `stream` is not read.
extern "C" int vmt_physics_step(
    const float* pos, const float* vel, const float* rot, const float* ang_vel,
    const float* force_a, const float* torque_a, const float* dyn_g,
    float* out_pos, float* out_vel, float* out_rot, float* out_ang_vel,
    const Tables* t, const Dims* d, void* stream) {
  const int blocks = (d->B + VMT_WARP - 1) / VMT_WARP;
#ifdef __CUDACC__
  if (!dims_ok(*d)) return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        physics_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        VMT_MAX_SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  physics_step_kernel<<<blocks, VMT_WARP * d->lanes, shared_bytes(*d),
                        (cudaStream_t)stream>>>(
      pos, vel, rot, ang_vel, force_a, torque_a, dyn_g, out_pos, out_vel,
      out_rot, out_ang_vel, *t, *d);
  return (int)cudaGetLastError();
#else
  (void)stream;
  if (!dims_ok(*d)) return 1;
  std::vector<float> smem((shared_bytes(*d) + 3) / 4);
  for (int block = 0; block < blocks; ++block)
    block_body(block, smem.data(), pos, vel, rot, ang_vel, force_a, torque_a,
               dyn_g, out_pos, out_vel, out_rot, out_ang_vel, *t, *d);
  return 0;
#endif
}
