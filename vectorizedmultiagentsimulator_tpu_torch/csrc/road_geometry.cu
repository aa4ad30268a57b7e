// road_traffic's path geometry as three CUDA kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels of vectorizedmultiagentsimulator_tpu/ops/
// road_geometry_pallas.py:
//   agent_geometry_kernel    <- _make_agent_kernel   (fused_geometry)
//   (agent_geometry_staged_kernel, the same with the tables in shared
//   memory, kept for the placement comparison)
//   pair_collisions_kernel   <- _make_pair_kernel    (fused_geometry)
//   neighbor_obs_kernel      <- _make_neighbor_obs_kernel
//                               (fused_neighbor_obs)
// Their plain PyTorch versions are ops/road_geometry.py::geometry_plain and
// ::neighbor_obs_plain; ops/road_geometry_cuda.py holds the wrappers, the
// launch counts, the device path tables and chunk boxes, and the
// autograd.Functions whose backward re-runs the plain versions.  The TPU
// kernels' one-hot matrix gathers and bf16 3-way table split serve the
// TPU's matrix unit and are left out: a lane reads its path's rows
// directly.
//
// Agent geometry.  Inputs pos [B, A, 2], rot [B, A], path_id [B, A]
// int32; the static tables (centre line, left and right boundaries
// [n_paths, P, 2], 40 x 185 x 6 floats at CPM-Lab's map, 178 KB).  For
// each agent: the least distance from its centre to the centre line's
// segments and the first segment within 1e-5 of it (the short-term path
// starts there), the least distances of its centre and 4 corners to each
// boundary, and with collisions whether one of its 4 edges strictly
// crosses a boundary segment (and the entry/exit segments).
//   * Layout: a group of G = RoadParams::lanes threads (4, 8, 16 or 32)
//     takes one agent.  Segment j of a polyline belongs to chunk j / G,
//     and lane t takes segment c * G + t of each chunk c it walks, so the
//     group's loads of a chunk are consecutive points of one path.  The
//     lanes' running minima meet by __shfl_xor_sync (fminf over
//     non-negative floats gives the same bits in any order), the crossing
//     flags by a ballot.  The centre line is walked once: each lane keeps
//     its distances in registers, and after the group's minimum is known
//     the least j with d <= min + 1e-5 comes from a ballot per chunk in
//     order.  Lane 0 takes cos/sin of the heading, lanes 0-4 the outputs,
//     lanes 0-2 the short-term points, lanes 0-1 the entry/exit tests.
//   * Exact chunk culling (RoadParams::cull).  Each chunk's bounding box
//     (from the fp32 table points, path_tables) bounds the distance of any
//     of its segments from below.  For each polyline the group first walks
//     the chunk whose box is nearest the agent's centre: its least float
//     segment distance D_v for point v is one the plain version computes
//     too, so the plain minimum is <= D_v.  Every other chunk is skipped
//     when, for every point v, its box distance exceeds D_v + 1e-5 +
//     VMT_CULL_MARGIN and (with collisions) the agent's box and the
//     chunk's, both grown by the margin, are disjoint.  The margin, 1e-4,
//     is about 200 ulps of the map's coordinates (up to 4.4), far above
//     the few-ulp error of the float segment and box distances.  So a
//     skipped segment's float distance exceeds the final minimum + 1e-5:
//     neither the minimum nor the first index within 1e-5 can change.  A
//     skipped crossing test has its segments more than 2e-4 apart: they
//     cannot cross in exact arithmetic, and in fp32 only at collinearity
//     within about 1e-6 (a near touch, which the checks tell apart).  Every
//     kept chunk runs the per-segment code below in the plain version's
//     operation order.  With cull = 0 every chunk is walked (the
//     every-segment kernel, kept to measure and to check culling against).
//   * Table placement (RoadParams::staged): through L1 with the group's
//     coalesced loads (agent_geometry_kernel, the default), or copied once
//     per block into shared memory by a cp.async.bulk copy on an mbarrier,
//     one persistent block an SM walking agents
//     (agent_geometry_staged_kernel).  PERF.md section 6 row 5 has both
//     times at every G.
//   * What bounds it on the H100: arithmetic, and then latency.  Built
//     with -fmad=false, no add or multiply fuses, and a segment distance
//     is about 26 operations (a division and a square root among them);
//     at road_traffic@10k the every-segment algorithm needs 6.8e4
//     operations an agent, and culling leaves the chunk tests and about a
//     chunk of segments a polyline (chip_smoke.py::road_bounds_ms counts
//     both).  What culling leaves is dominated by fixed, dependent passes
//     (per polyline the nearest-chunk and keep passes over the boxes, the
//     lane reductions and ballots), so the kernel is latency-bound: its
//     registers are capped for 32 warps an SM (PERF.md section 6 has its
//     times against both counts).
//
// Pair collisions.  One warp per env: lane i computes agent i's rectangle
// once (cos/sin once) into shared memory with its box; the A(A-1)/2
// unordered pairs are dealt round-robin over the lanes; a pair whose boxes,
// grown by the margin, are disjoint is no crossing (as above); the others
// run the 16 crossing tests in today's order.  crosses(p, q) computes the
// same four products as crosses(q, p) in another order, so one result
// fills agents[b, i, j] and agents[b, j, i]; the env's A*A flags and 5*A
// vertices are staged in shared memory and stored coalesced.  Bound on the
// H100: the bytes written (the [B, A, A] matrix) once the boxes cull most
// pairs.
//
// Neighbour observations.  One warp per env: the env's A x A block of dn
// (contiguous), its poses and velocities are loaded coalesced into shared
// memory (dn's rows at an odd stride); each agent's rectangle and speed
// are made once for the env; lane i runs agent i's k rounds of first-
// minimum selection from shared memory (agents i and i + 32 in turn when
// A > 32); each chunk's outputs (14 k floats an agent, contiguous in each
// of the five outputs) are staged in shared memory and stored coalesced.  About 42 MB read and written at road_traffic@10k: bytes
// bound it (12.7 us at 3.35 TB/s).
//
// Parity with the plain version.  The outputs are partly discrete: a
// closest index that moves by one shifts the short-term path by a whole
// segment, and a crossing sign that flips flips a collision flag, which
// ends an episode.  So, built with -fmad=false and without fast math
// (sqrtf, IEEE division, cosf/sinf), each kernel repeats the plain
// version's operations in their order: the segment distance as
// ((x0 + dx*t) - px) with t = clamp((pvx*dx + pvy*dy) / (dx*dx + dy*dy +
// 1e-8), 0, 1), the square root of each segment's squared distance
// compared as a distance against min + 1e-5 (not squared distances, not a
// reciprocal: those are not bit-equal to the plain version), every corner
// as (bx*cos - by*sin) + px, and every crossing term as sx*(p1y - q1y) -
// sy*(p1x - q1x).  Across lanes only fminf, OR and a least index are
// reduced.  Segments past a polyline's true end are left out where the
// plain version replicates the last real distance or meets only degenerate
// padding segments, which change neither a minimum, nor the first index
// within the tolerance, nor any strict crossing.
//
// Compiled as host C++ (no __CUDACC__), the same bodies run with each
// group's lanes as a loop (LANES below) and the lane reductions over
// arrays, which is how the CPU tests run this source.

#include <cmath>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define DEV __device__ __forceinline__
#define HD __host__ __device__ __forceinline__
#define LDG(p) __ldg(p)
#else
#include <vector>
#define DEV inline
#define HD inline
#define LDG(p) (*(p))
struct float2 {
  float x, y;
};
#endif

#define VMT_NEIGHBOR_WARPS 4     // neighbour kernel: envs (a warp each) a block
#define VMT_GEOM_THREADS 256     // agent geometry through L1: threads a block
// ... and the blocks an SM its registers are set for (64 a thread): the
// kernel is latency-bound, and 32 warps an SM hid more of it than the 24
// that its natural 80 registers leave (PERF.md section 6).
#define VMT_GEOM_MIN_BLOCKS 4
#define VMT_STAGED_THREADS 1024  // agent geometry from shared memory
#define VMT_PAIR_WARPS 4         // pair kernel: envs (a warp each) a block
#define VMT_MAX_P 193            // a row's points: at most 48 chunks of 4
#define VMT_MAX_PAIR_A 64
#define VMT_MAX_SMEM 232448      // dynamic shared memory a block may use
#define VMT_CULL_MARGIN 1e-4f
// A chunk is kept when a box distance is <= D + VMT_CULL_TOL.
#define VMT_CULL_TOL (1e-5f + VMT_CULL_MARGIN)

// The static configuration and the device path tables.  ops/
// road_geometry_cuda.py mirrors this struct field for field (_RoadParams),
// fills it once per scenario and passes its host address.  Tables:
//   center, left, right  [n_paths, P, 2] float
//   meta                 [n_paths, 4] int: n_points, n_left, n_right,
//                        is_loop
//   ends                 [n_paths, 2, 2, 2] float: the entry segment (left
//                        and right boundary's first points), the exit
//                        segment (their last points)
//   boxes                [n_paths, 3, chunks, 4] float: xmin, ymin, xmax,
//                        ymax of the points of each chunk of `lanes`
//                        consecutive real segments of the centre line, the
//                        left and the right boundary
// half_l, half_w: half the agent's length and width (fp32 of the plain
// version's Python halves); K short-term points every SI-th point;
// entry_exit: whether the scenario tests entry and exit segments (map '3'
// or testing mode, with paths that are not loops); lanes: the agent
// kernel's group; cull: whether it culls chunks; staged: whether it reads
// the tables from shared memory.
struct RoadParams {
  const float* center;
  const float* left;
  const float* right;
  const int* meta;
  const float* ends;
  const float* boxes;
  int n_paths, P, A, K, SI, entry_exit;
  int lanes, chunks, cull, staged;
  float half_l, half_w;
};

namespace {

// ---- a group of G lanes, on the card and on the host ---- //
// A per-lane variable is an array x[NL] read as x[L]: on the card one
// element (this thread's), on the host one per lane.  LANES ... LANES_END
// runs its body for this thread's lane on the card, for every lane in
// order on the host.
#ifdef __CUDACC__
#define NL(G) 1
#define LANES(G)                                        \
  {                                                     \
    const int lane = (int)(threadIdx.x & ((G) - 1));    \
    constexpr int L = 0;                                \
    (void)lane;                                         \
    (void)L;
#define LANES_END }

template <int G>
DEV unsigned group_mask() {
  return G == 32 ? 0xffffffffu
                 : ((1u << (G & 31)) - 1u) << (threadIdx.x & 31u & ~(G - 1u));
}

DEV int ctz32(unsigned x) { return __ffs(x) - 1; }
DEV int ctz64(unsigned long long x) { return __ffsll((long long)x) - 1; }
#else
#define NL(G) (G)
#define LANES(G)                      \
  for (int lane = 0; lane < (G); ++lane) { \
    const int L = lane;                \
    (void)L;
#define LANES_END }

inline int ctz32(unsigned x) { return __builtin_ctz(x); }
inline int ctz64(unsigned long long x) { return __builtin_ctzll(x); }
#endif

// The least of the lanes' x.
template <int G>
DEV float group_min(const float* x) {
#ifdef __CUDACC__
  float v = x[0];
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(group_mask<G>(), v, o, G));
  return v;
#else
  float v = x[0];
  for (int l = 1; l < G; ++l) v = fminf(v, x[l]);
  return v;
#endif
}

// Bit l: lane l's x.
template <int G>
DEV unsigned group_ballot(const bool* x) {
#ifdef __CUDACC__
  const unsigned b =
      __ballot_sync(group_mask<G>(), x[0]) >> (threadIdx.x & 31u & ~(G - 1u));
  return G == 32 ? b : b & ((1u << (G & 31)) - 1u);
#else
  unsigned b = 0;
  for (int l = 0; l < G; ++l) b |= (unsigned)x[l] << l;
  return b;
#endif
}

// Lane src's x.
template <int G, class T>
DEV T group_bcast(const T* x, int src) {
#ifdef __CUDACC__
  return __shfl_sync(group_mask<G>(), x[0], src, G);
#else
  return x[src];
#endif
}

// ---- geometry, in the plain version's operations ---- //
struct Box {
  float x0, y0, x1, y1;
};

DEV Box load_box(const float* boxes, int c) {
#ifdef __CUDACC__
  const float4 b = __ldg(reinterpret_cast<const float4*>(boxes) + c);
  return {b.x, b.y, b.z, b.w};
#else
  const float* b = boxes + 4 * c;
  return {b[0], b[1], b[2], b[3]};
#endif
}

// A table point: from shared memory (staged) or through the read-only
// cache.
template <bool STAGED>
DEV float2 load_pt(const float2* p) {
#ifdef __CUDACC__
  if (STAGED) return *p;
  return __ldg(p);
#else
  return *p;
#endif
}

DEV float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// Distance from (px, py) to the segment (x0, y0) -> (x1, y1), in
// get_perpendicular_distances' operations.
DEV float seg_dist(float px, float py, float x0, float y0, float x1,
                   float y1) {
  const float dx = x1 - x0, dy = y1 - y0;
  const float pvx = px - x0, pvy = py - y0;
  const float lsq = dx * dx + dy * dy + 1e-8f;
  const float t = clampf((pvx * dx + pvy * dy) / lsq, 0.0f, 1.0f);
  const float cx = x0 + dx * t - px;
  const float cy = y0 + dy * t - py;
  const float sq = cx * cx + cy * cy;
  return sq > 0.0f ? sqrtf(sq) : 0.0f;
}

// Strict crossing of segment p1 -> p2 with q1 -> q2, in
// segments_intersect's operations.
DEV bool crosses(float p1x, float p1y, float p2x, float p2y, float q1x,
                 float q1y, float q2x, float q2y) {
  const float sx = q2x - q1x, sy = q2y - q1y;
  const float rx = p2x - p1x, ry = p2y - p1y;
  const float d1 = sx * (p1y - q1y) - sy * (p1x - q1x);
  const float d2 = sx * (p2y - q1y) - sy * (p2x - q1x);
  const float d3 = rx * (q1y - p1y) - ry * (q1x - p1x);
  const float d4 = rx * (q2y - p1y) - ry * (q2x - p1x);
  return (d1 * d2 < 0.0f) && (d3 * d4 < 0.0f);
}

// The closed rectangle's 5 vertices (the 5th repeats the 1st), in
// get_rectangle_vertices' operations: corner rotated, then translated.
DEV void rectangle_cs(float px, float py, float c, float s, float half_l,
                      float half_w, float* vx, float* vy) {
  const float bx[5] = {half_l, half_l, -half_l, -half_l, half_l};
  const float by[5] = {half_w, -half_w, -half_w, half_w, half_w};
#pragma unroll
  for (int v = 0; v < 5; ++v) {
    vx[v] = bx[v] * c - by[v] * s + px;
    vy[v] = bx[v] * s + by[v] * c + py;
  }
}

// sinf(x) and cosf(x): on the card one sincosf, the same functions with
// one range reduction (chip_smoke.py's phase 2 finds the kernels'
// results bit-equal to the plain versions, which call PyTorch's cos and
// sin).
DEV void sin_cos(float x, float* s, float* c) {
#ifdef __CUDACC__
  sincosf(x, s, c);
#else
  *s = sinf(x);
  *c = cosf(x);
#endif
}

DEV void rectangle(float px, float py, float th, float half_l, float half_w,
                   float* vx, float* vy) {
  rectangle_cs(px, py, cosf(th), sinf(th), half_l, half_w, vx, vy);
}

// The bounding box of points (x[v], y[v]), v < n.
DEV Box bounds_of(const float* x, const float* y, int n) {
  Box b = {x[0], y[0], x[0], y[0]};
  for (int v = 1; v < n; ++v) {
    b.x0 = fminf(b.x0, x[v]);
    b.y0 = fminf(b.y0, y[v]);
    b.x1 = fmaxf(b.x1, x[v]);
    b.y1 = fmaxf(b.y1, y[v]);
  }
  return b;
}

// Distance from (px, py) to box b (0 inside).
DEV float box_dist(const Box& b, float px, float py) {
  const float dx = fmaxf(fmaxf(b.x0 - px, px - b.x1), 0.0f);
  const float dy = fmaxf(fmaxf(b.y0 - py, py - b.y1), 0.0f);
  return sqrtf(dx * dx + dy * dy);
}

// Distance between boxes a and b (0 where they meet); never more than the
// distance of any point of a to b, in float too (rounding is monotonic).
DEV float box_gap(const Box& a, const Box& b) {
  const float dx = fmaxf(fmaxf(b.x0 - a.x1, a.x0 - b.x1), 0.0f);
  const float dy = fmaxf(fmaxf(b.y0 - a.y1, a.y0 - b.y1), 0.0f);
  return sqrtf(dx * dx + dy * dy);
}

// Whether a and b, each grown by the margin, meet.
DEV bool boxes_meet(const Box& a, const Box& b) {
  const float m = VMT_CULL_MARGIN;
  return a.x0 - m <= b.x1 + m && b.x0 - m <= a.x1 + m &&
         a.y0 - m <= b.y1 + m && b.y0 - m <= a.y1 + m;
}

// ---- agent geometry ---- //
// The chunk of a polyline's nch chunks whose box is nearest (px, py).
template <int G>
DEV int nearest_chunk(const float* boxes, int nch, float px, float py) {
  float best[NL(G)];
  int arg[NL(G)];
  bool is[NL(G)];
  LANES(G) {
    best[L] = INFINITY;
    arg[L] = 0;
    for (int c = lane; c < nch; c += G) {
      const float d = box_dist(load_box(boxes, c), px, py);
      if (d < best[L]) {
        best[L] = d;
        arg[L] = c;
      }
    }
  }
  LANES_END
  const float b = group_min<G>(best);
  LANES(G) { is[L] = best[L] == b; }
  LANES_END
  return group_bcast<G>(arg, ctz32(group_ballot<G>(is)));
}

// Bit c: chunk c < nch passes keep(c); lane l tests chunks l, l + G, ...
template <int G, class F>
DEV unsigned long long chunk_mask(int nch, F keep) {
  unsigned long long mask = 0;
  for (int r = 0; r * G < nch; ++r) {
    bool k[NL(G)];
    LANES(G) {
      const int c = r * G + lane;
      k[L] = c < nch && keep(c);
    }
    LANES_END
    mask |= (unsigned long long)group_ballot<G>(k) << (r * G);
  }
  return mask;
}

DEV unsigned long long all_chunks(int nch) {
  return nch >= 64 ? ~0ull : (1ull << nch) - 1ull;
}

// Agent q = env * A + agent, by a group of G lanes; center/left/right are
// the tables' first rows, in shared memory (STAGED) or device memory.
template <int G, bool CULL, bool STAGED>
DEV void agent_geometry_group(
    long long q, const float2* center, const float2* left,
    const float2* right, const float* __restrict__ pos,
    const float* __restrict__ rot, const int* __restrict__ path_id,
    float* __restrict__ ref, float* __restrict__ left_all,
    float* __restrict__ right_all, float* __restrict__ bounds,
    float* __restrict__ short_term, float* __restrict__ lanelets,
    float* __restrict__ entry, float* __restrict__ exit_,
    const RoadParams& p, int with_collisions) {
  // Chunks of the longest row: the centre line's per-lane distances.
  constexpr int S = (VMT_MAX_P - 1 + G - 1) / G;
  const float px = pos[2 * q], py = pos[2 * q + 1];
  const int pid = path_id[q];
  const int n = LDG(p.meta + 4 * pid), n_l = LDG(p.meta + 4 * pid + 1),
            n_r = LDG(p.meta + 4 * pid + 2);
  const bool is_loop = LDG(p.meta + 4 * pid + 3) != 0;
  const float2* ct = center + (size_t)pid * p.P;
  const float* boxes = p.boxes + (size_t)pid * 3 * p.chunks * 4;

  // The rectangle: cos/sin once, on lane 0; every lane its 5 vertices.
  float cth[NL(G)], sth[NL(G)];
  LANES(G) {
    cth[L] = sth[L] = 0.0f;
    if (lane == 0) {
      cth[L] = cosf(rot[q]);
      sth[L] = sinf(rot[q]);
    }
  }
  LANES_END
  float vx[5], vy[5];
  rectangle_cs(px, py, group_bcast<G>(cth, 0), group_bcast<G>(sth, 0),
               p.half_l, p.half_w, vx, vy);
  // The centre and the 4 corners; the box of all of them.
  const float ptx[5] = {px, vx[0], vx[1], vx[2], vx[3]};
  const float pty[5] = {py, vy[0], vy[1], vy[2], vy[3]};
  const Box rbox = bounds_of(ptx, pty, 5);

  // Reference path: the least distance over the real segments, then the
  // first segment within 1e-5 of it, from the distances kept in dc.
  const int nseg_c = n - 1 > 1 ? n - 1 : 1;
  const int nch_c = (nseg_c + G - 1) / G;
  unsigned long long kept = all_chunks(nch_c);
  if (CULL) {
    const int c0 = nearest_chunk<G>(boxes, nch_c, px, py);
    float d0[NL(G)];
    LANES(G) {
      const int j = c0 * G + lane;
      d0[L] = INFINITY;
      if (j < nseg_c) {
        const float2 a = load_pt<STAGED>(ct + j),
                     b = load_pt<STAGED>(ct + j + 1);
        d0[L] = seg_dist(px, py, a.x, a.y, b.x, b.y);
      }
    }
    LANES_END
    const float lim = group_min<G>(d0) + VMT_CULL_TOL;
    kept = chunk_mask<G>(nch_c, [&](int c) {
      return box_dist(load_box(boxes, c), px, py) <= lim;
    });
  }
  float dc[S][NL(G)], mn[NL(G)];
  LANES(G) { mn[L] = INFINITY; }
  LANES_END
  unsigned long long rest = kept;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (rest == 0) break;
    const int c = ctz64(rest);
    rest &= rest - 1;
    LANES(G) {
      const int j = c * G + lane;
      float d = INFINITY;
      if (j < nseg_c) {
        const float2 a = load_pt<STAGED>(ct + j), b = load_pt<STAGED>(ct + j + 1);
        d = seg_dist(px, py, a.x, a.y, b.x, b.y);
      }
      dc[s][L] = d;
      mn[L] = fminf(mn[L], d);
    }
    LANES_END
  }
  const float dist = group_min<G>(mn);
  const float thr = dist + 1e-5f;
  int first = 0;
  rest = kept;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (rest == 0) break;
    const int c = ctz64(rest);
    rest &= rest - 1;
    bool w[NL(G)];
    LANES(G) { w[L] = dc[s][L] <= thr; }
    LANES_END
    const unsigned hit = group_ballot<G>(w);
    if (hit) {
      first = c * G + ctz32(hit);
      break;
    }
  }

  // Short-term path: every SI-th point from the closest on, wrapping
  // around a loop, clamped to the table; lane k takes point k.
  const int idx = first + 1;
  LANES(G) {
    if (lane == 0) ref[q] = dist;
    for (int k = lane; k < p.K; k += G) {
      int fut = k * p.SI + idx + 1;
      if (is_loop && fut >= n - 1) fut = (fut + 1) % n;
      fut = fut < 0 ? 0 : (fut > p.P - 1 ? p.P - 1 : fut);
      const float2 v = load_pt<STAGED>(ct + fut);
      short_term[(q * p.K + k) * 2] = v.x;
      short_term[(q * p.K + k) * 2 + 1] = v.y;
    }
  }
  LANES_END

  // Each boundary: the centre's and the 4 corners' least distances, and
  // the rectangle's edges against the boundary's segments.
  float best = 0.0f;
  bool hit[NL(G)];
  LANES(G) { hit[L] = false; }
  LANES_END
  for (int side = 0; side < 2; ++side) {
    const float2* bt = (side == 0 ? left : right) + (size_t)pid * p.P;
    const float* bb = boxes + (size_t)(1 + side) * p.chunks * 4;
    const int nb = side == 0 ? n_l : n_r;
    const int nseg = nb - 1 > 1 ? nb - 1 : 1;
    const int nch = (nseg + G - 1) / G;
    float mm[5][NL(G)];
    LANES(G) {
      for (int v = 0; v < 5; ++v) mm[v][L] = INFINITY;
    }
    LANES_END
    auto walk = [&](int c) {
      LANES(G) {
        const int j = c * G + lane;
        if (j < nseg) {
          const float2 a = load_pt<STAGED>(bt + j),
                       b = load_pt<STAGED>(bt + j + 1);
#pragma unroll
          for (int v = 0; v < 5; ++v)
            mm[v][L] =
                fminf(mm[v][L], seg_dist(ptx[v], pty[v], a.x, a.y, b.x, b.y));
          if (with_collisions && !hit[L]) {
#pragma unroll
            for (int s = 0; s < 4; ++s)
              hit[L] = hit[L] || crosses(vx[s], vy[s], vx[s + 1], vy[s + 1],
                                         a.x, a.y, b.x, b.y);
          }
        }
      }
      LANES_END
    };
    unsigned long long todo = all_chunks(nch);
    if (CULL) {
      const int c0 = nearest_chunk<G>(bb, nch, px, py);
      walk(c0);
      float lim[5], lim_max = 0.0f;
      for (int v = 0; v < 5; ++v) {
        lim[v] = group_min<G>(mm[v]) + VMT_CULL_TOL;
        lim_max = fmaxf(lim_max, lim[v]);
      }
      todo = chunk_mask<G>(nch, [&](int c) {
        if (c == c0) return false;
        const Box b = load_box(bb, c);
        if (with_collisions && boxes_meet(rbox, b)) return true;
        if (box_gap(rbox, b) > lim_max) return false;
        for (int v = 0; v < 5; ++v)
          if (box_dist(b, ptx[v], pty[v]) <= lim[v]) return true;
        return false;
      });
    }
    while (todo) {
      const int c = ctz64(todo);
      todo &= todo - 1;
      walk(c);
    }
    float m[5];
    for (int v = 0; v < 5; ++v) m[v] = group_min<G>(mm[v]);
    float* out = (side == 0 ? left_all : right_all) + q * 5;
    LANES(G) {
      for (int v = lane; v < 5; v += G) out[v] = v == 0 ? m[0] - p.half_w : m[v];
    }
    LANES_END
    for (int v = 0; v < 5; ++v) {
      const float x = v == 0 ? m[0] - p.half_w : m[v];
      best = (side == 0 && v == 0) ? x : fminf(best, x);
    }
  }
  const bool lane_hit = group_ballot<G>(hit) != 0;
  LANES(G) {
    if (lane == 0) {
      bounds[q] = best;
      if (with_collisions) lanelets[q] = lane_hit ? 1.0f : 0.0f;
    }
    // Entry and exit segments of a path that is not a loop: lane e takes
    // segment e.
    for (int e = lane; with_collisions && e < 2; e += G) {
      bool h = false;
      if (p.entry_exit && !is_loop) {
        const float* seg = p.ends + ((size_t)pid * 2 + e) * 4;
        const float q1x = LDG(seg), q1y = LDG(seg + 1), q2x = LDG(seg + 2),
                    q2y = LDG(seg + 3);
        for (int s = 0; s < 4; ++s)
          h = h || crosses(vx[s], vy[s], vx[s + 1], vy[s + 1], q1x, q1y, q2x,
                           q2y);
      }
      (e == 0 ? entry : exit_)[q] = h ? 1.0f : 0.0f;
    }
  }
  LANES_END
}

// ---- pair collisions ---- //
// Floats of one env's shared scratch: vertices [A][5][2], boxes [A][4],
// flags [A][A].
HD int pair_floats(int A) { return 14 * A + A * A; }

// Phase 1, lane `lane` of `nl`: agents i = lane, lane + nl, ...: the
// rectangle's vertices and box into the scratch.
DEV void pair_rects(long long b, int lane, int nl,
                    const float* __restrict__ pos,
                    const float* __restrict__ rot, float* scratch,
                    const RoadParams& p) {
  const int A = p.A;
  for (int i = lane; i < A; i += nl) {
    const long long q = b * A + i;
    float vx[5], vy[5];
    rectangle(pos[2 * q], pos[2 * q + 1], rot[q], p.half_l, p.half_w, vx, vy);
    float* v = scratch + 10 * i;
    for (int k = 0; k < 5; ++k) {
      v[2 * k] = vx[k];
      v[2 * k + 1] = vy[k];
    }
    const Box bx = bounds_of(vx, vy, 4);
    float* box = scratch + 10 * A + 4 * i;
    box[0] = bx.x0;
    box[1] = bx.y0;
    box[2] = bx.x1;
    box[3] = bx.y1;
  }
}

// Phase 2: unordered pairs k = lane, lane + nl, ... (row-major over i < j)
// into both flags, and the diagonal.
DEV void pair_tests(int lane, int nl, float* scratch, int A) {
  const float* verts = scratch;
  const float* boxes = scratch + 10 * A;
  float* flags = scratch + 14 * A;
  const int n_pairs = A * (A - 1) / 2;
  for (int k = lane; k < n_pairs; k += nl) {
    int i = 0, r = k;
    while (r >= A - 1 - i) {
      r -= A - 1 - i;
      ++i;
    }
    const int j = i + 1 + r;
    const float* bi = boxes + 4 * i;
    const float* bj = boxes + 4 * j;
    bool hit = false;
    if (boxes_meet({bi[0], bi[1], bi[2], bi[3]}, {bj[0], bj[1], bj[2], bj[3]})) {
      const float* v = verts + 10 * i;
      const float* w = verts + 10 * j;
      for (int s = 0; s < 4 && !hit; ++s)
        for (int t = 0; t < 4 && !hit; ++t)
          hit = crosses(v[2 * s], v[2 * s + 1], v[2 * s + 2], v[2 * s + 3],
                        w[2 * t], w[2 * t + 1], w[2 * t + 2], w[2 * t + 3]);
    }
    flags[i * A + j] = flags[j * A + i] = hit ? 1.0f : 0.0f;
  }
  for (int i = lane; i < A; i += nl) flags[i * A + i] = 0.0f;
}

// Phase 3: env b's vertices and flags, neighbouring lanes on neighbouring
// floats.
DEV void pair_store(long long b, int lane, int nl, const float* scratch,
                    float* __restrict__ vertices, float* __restrict__ agents,
                    int A) {
  for (int e = lane; e < 10 * A; e += nl)
    vertices[b * 10 * A + e] = scratch[e];
  for (int e = lane; e < A * A; e += nl)
    agents[b * A * A + e] = scratch[14 * A + e];
}

// ---- neighbour observations ---- //
// One env's shared scratch, in floats, for A agents and k rounds:
//   dn [A][S]: the env's rows of dn, S = A | 1 (an odd stride: the lanes'
//              rows start in distinct banks);
//   px, py, th, vx, vy, va [A]: the poses, velocities and speeds;
//   wx, wy [A][4]: each agent's rectangle corners, made once;
//   out [min(A, 32) * 14 k]: the outputs of a chunk of up to 32 agents,
//              slab by slab (nd, pe, rr, ve, vt), each as contiguous as
//              in the output tensors.
HD int nb_stride(int A) { return A | 1; }
HD int neighbor_floats(int A, int k) {
  return A * nb_stride(A) + 14 * A + (A < 32 ? A : 32) * 14 * k;
}

struct NeighborScratch {
  float *dn, *px, *py, *th, *vx, *vy, *va, *wx, *wy, *out;
};

DEV NeighborScratch neighbor_scratch(float* sc, int A) {
  NeighborScratch n;
  n.dn = sc;
  float* f = sc + A * nb_stride(A);
  n.px = f;
  n.py = f + A;
  n.th = f + 2 * A;
  n.vx = f + 3 * A;
  n.vy = f + 4 * A;
  n.va = f + 5 * A;
  n.wx = f + 6 * A;
  n.wy = f + 10 * A;
  n.out = f + 14 * A;
  return n;
}

// Phase 1, lane `lane` of `nl`: env b's dn rows, poses and velocities,
// neighbouring lanes on neighbouring floats.
DEV void neighbor_load(long long b, int lane, int nl,
                       const float* __restrict__ pos,
                       const float* __restrict__ rot,
                       const float* __restrict__ vel,
                       const float* __restrict__ dn, const NeighborScratch& s,
                       int A) {
  const int S = nb_stride(A);
  const float* d = dn + b * A * A;
  // Element e = i * A + j, walked in steps of nl without a division.
  const int di = nl / A, dj = nl - di * A;
  int i = lane / A, j = lane - (lane / A) * A;
  for (int e = lane; e < A * A; e += nl) {
    s.dn[i * S + j] = d[e];
    i += di;
    j += dj;
    if (j >= A) {
      j -= A;
      ++i;
    }
  }
  for (int e = lane; e < 2 * A; e += nl) {
    (e & 1 ? s.py : s.px)[e >> 1] = pos[b * 2 * A + e];
    (e & 1 ? s.vy : s.vx)[e >> 1] = vel[b * 2 * A + e];
  }
  for (int e = lane; e < A; e += nl) s.th[e] = rot[b * A + e];
}

// Phase 2: each agent's rectangle corners and speed, once for the env.
DEV void neighbor_prep(int lane, int nl, const NeighborScratch& s, int A,
                       float half_l, float half_w) {
  for (int j = lane; j < A; j += nl) {
    float wx[5], wy[5], sj, cj;
    sin_cos(s.th[j], &sj, &cj);
    rectangle_cs(s.px[j], s.py[j], cj, sj, half_l, half_w, wx, wy);
    for (int v = 0; v < 4; ++v) {
      s.wx[j * 4 + v] = wx[v];
      s.wy[j * 4 + v] = wy[v];
    }
    const float sq = s.vx[j] * s.vx[j] + s.vy[j] * s.vy[j];
    s.va[j] = sq > 0.0f ? sqrtf(sq) : 0.0f;
  }
}

// Phase 3, lane l of the chunk of n agents from i0: agent i = i0 + l's k
// nearest others in its ego frame, into the chunk's slabs.  Round r takes
// the first least entry of row i of dn; the taken entry is then set to
// +inf in the shared row, as the plain version sets it.
DEV void neighbor_select(int l, int i0, int n, const NeighborScratch& s,
                         int A, int k) {
  const int i = i0 + l;
  float* row = s.dn + i * nb_stride(A);
  const float px = s.px[i], py = s.py[i], th = s.th[i];
  float c, sn;
  sin_cos(-th, &sn, &c);
  const int nk = n * k;
  float* nd = s.out;
  float* pe = nd + nk;
  float* rr = pe + 2 * nk;
  float* ve = rr + nk;
  float* vt = ve + 2 * nk;
  for (int r = 0; r < k; ++r) {
    float best = row[0];
    int pick = 0;
    for (int j = 1; j < A; ++j) {
      const float v = row[j];
      if (v < best) {
        best = v;
        pick = j;
      }
    }
    row[pick] = INFINITY;
    const int o = l * k + r;
    nd[o] = best;
    const float relx = s.px[pick] - px, rely = s.py[pick] - py;
    pe[2 * o] = relx * c - rely * sn;
    pe[2 * o + 1] = relx * sn + rely * c;
    const float rot_rel = s.th[pick] - th;
    rr[o] = rot_rel;
    const float va = s.va[pick];
    float sr, cr;
    sin_cos(rot_rel, &sr, &cr);
    ve[2 * o] = va * cr;
    ve[2 * o + 1] = va * sr;
    for (int v = 0; v < 4; ++v) {
      const float ux = s.wx[pick * 4 + v] - px, uy = s.wy[pick * 4 + v] - py;
      vt[(o * 4 + v) * 2] = ux * c - uy * sn;
      vt[(o * 4 + v) * 2 + 1] = ux * sn + uy * c;
    }
  }
}

// Phase 4: the chunk's slabs to the outputs (the chunk's n agents from i0
// of env b are n * 14 k contiguous floats, slab by slab), neighbouring
// lanes on neighbouring floats.
DEV void neighbor_store(long long b, int lane, int nl, int i0, int n,
                        const NeighborScratch& s, float* __restrict__ nd,
                        float* __restrict__ pe, float* __restrict__ rr,
                        float* __restrict__ ve, float* __restrict__ vt, int A,
                        int k) {
  const long long q = (b * A + i0) * k;  // the chunk's first (agent, round)
  const int nk = n * k;
  const float* src = s.out;
  for (int e = lane; e < nk; e += nl) nd[q + e] = src[e];
  src += nk;
  for (int e = lane; e < 2 * nk; e += nl) pe[2 * q + e] = src[e];
  src += 2 * nk;
  for (int e = lane; e < nk; e += nl) rr[q + e] = src[e];
  src += nk;
  for (int e = lane; e < 2 * nk; e += nl) ve[2 * q + e] = src[e];
  src += 2 * nk;
  for (int e = lane; e < 8 * nk; e += nl) vt[8 * q + e] = src[e];
}

#ifdef __CUDACC__
// The agent-geometry kernel's arguments after the tables.
#define VMT_AGENT_ARGS                                                      \
  const float *__restrict__ pos, const float *__restrict__ rot,             \
      const int *__restrict__ path_id, float *ref, float *left_all,         \
      float *right_all, float *bounds, float *short_term, float *lanelets, \
      float *entry, float *exit_, RoadParams p, int B, int with_collisions
#define VMT_AGENT_PASS                                                      \
  pos, rot, path_id, ref, left_all, right_all, bounds, short_term, lanelets, \
      entry, exit_, p, with_collisions

template <int G, bool CULL>
__global__ void __launch_bounds__(VMT_GEOM_THREADS, VMT_GEOM_MIN_BLOCKS)
agent_geometry_kernel(VMT_AGENT_ARGS) {
  const long long q =
      ((long long)blockIdx.x * VMT_GEOM_THREADS + threadIdx.x) / G;
  if (q >= (long long)B * p.A) return;
  agent_geometry_group<G, CULL, false>(
      q, reinterpret_cast<const float2*>(p.center),
      reinterpret_cast<const float2*>(p.left),
      reinterpret_cast<const float2*>(p.right), VMT_AGENT_PASS);
}

DEV unsigned smem_addr(const void* ptr) {
  return (unsigned)__cvta_generic_to_shared(ptr);
}

// The tables copied into shared memory once per block (one bulk copy per
// table on an mbarrier), then agents walked block by block.
template <int G, bool CULL>
__global__ void __launch_bounds__(VMT_STAGED_THREADS, 1)
agent_geometry_staged_kernel(VMT_AGENT_ARGS) {
  extern __shared__ __align__(16) float2 tab[];
  __shared__ __align__(8) unsigned long long bar;
  const int row = p.n_paths * p.P;
  const unsigned bytes = (unsigned)row * 8u;
  const unsigned b_addr = smem_addr(&bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(b_addr),
                 "r"(1));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b_addr),
        "r"(3 * bytes)
        : "memory");
    const float* src[3] = {p.center, p.left, p.right};
    for (int t = 0; t < 3; ++t)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];" ::"r"(smem_addr(tab + (size_t)t * row)),
          "l"(src[t]), "r"(bytes), "r"(b_addr)
          : "memory");
  }
  asm volatile(
      "{\n\t.reg .pred P1;\n\t"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra WAIT;\n\t"
      "DONE:\n\t}" ::"r"(b_addr),
      "r"(0)
      : "memory");
  const long long n = (long long)B * p.A;
  const int per_block = VMT_STAGED_THREADS / G;
  for (long long q = (long long)blockIdx.x * per_block + threadIdx.x / G;
       q < n; q += (long long)gridDim.x * per_block)
    agent_geometry_group<G, CULL, true>(q, tab, tab + row, tab + 2 * row,
                                        VMT_AGENT_PASS);
}

__global__ void __launch_bounds__(32 * VMT_PAIR_WARPS)
pair_collisions_kernel(const float* __restrict__ pos,
                       const float* __restrict__ rot, float* vertices,
                       float* agents, RoadParams p, int B) {
  extern __shared__ float pair_scratch[];
  const int w = (int)(threadIdx.x >> 5), lane = (int)(threadIdx.x & 31);
  const long long b = (long long)blockIdx.x * VMT_PAIR_WARPS + w;
  if (b >= B) return;
  float* scratch = pair_scratch + (size_t)w * pair_floats(p.A);
  pair_rects(b, lane, 32, pos, rot, scratch, p);
  __syncwarp();
  pair_tests(lane, 32, scratch, p.A);
  __syncwarp();
  pair_store(b, lane, 32, scratch, vertices, agents, p.A);
}

__global__ void __launch_bounds__(32 * VMT_NEIGHBOR_WARPS)
neighbor_obs_kernel(const float* __restrict__ pos,
                    const float* __restrict__ rot,
                    const float* __restrict__ vel,
                    const float* __restrict__ dn, float* nd, float* pe,
                    float* rr, float* ve, float* vt, int B, int A, int k,
                    float half_l, float half_w) {
  extern __shared__ float neighbor_scratch_all[];
  const int w = (int)(threadIdx.x >> 5), lane = (int)(threadIdx.x & 31);
  const long long b = (long long)blockIdx.x * (blockDim.x >> 5) + w;
  if (b >= B) return;
  const NeighborScratch s = neighbor_scratch(
      neighbor_scratch_all + (size_t)w * neighbor_floats(A, k), A);
  neighbor_load(b, lane, 32, pos, rot, vel, dn, s, A);
  __syncwarp();
  neighbor_prep(lane, 32, s, A, half_l, half_w);
  __syncwarp();
  for (int i0 = 0; i0 < A; i0 += 32) {
    const int n = A - i0 < 32 ? A - i0 : 32;
    if (lane < n) neighbor_select(lane, i0, n, s, A, k);
    __syncwarp();
    neighbor_store(b, lane, 32, i0, n, s, nd, pe, rr, ve, vt, A, k);
    __syncwarp();
  }
}

int blocks_for(long long n, int per_block) {
  return (int)((n + per_block - 1) / per_block);
}

template <int G, bool CULL>
int launch_agent(const float* pos, const float* rot, const int* path_id,
                 float* ref, float* left_all, float* right_all, float* bounds,
                 float* short_term, float* lanelets, float* entry,
                 float* exit_, const RoadParams& p, int B,
                 int with_collisions, cudaStream_t stream) {
  const long long n = (long long)B * p.A;
  if (!p.staged) {
    agent_geometry_kernel<G, CULL>
        <<<blocks_for(n * G, VMT_GEOM_THREADS), VMT_GEOM_THREADS, 0,
           stream>>>(pos, rot, path_id, ref, left_all, right_all, bounds,
                     short_term, lanelets, entry, exit_, p, B,
                     with_collisions);
    return (int)cudaGetLastError();
  }
  const int smem = 3 * p.n_paths * p.P * 8;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncSetAttribute(agent_geometry_staged_kernel<G, CULL>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const long long groups = blocks_for(n, VMT_STAGED_THREADS / G);
  const int grid = (int)(groups < sms ? groups : sms);
  agent_geometry_staged_kernel<G, CULL>
      <<<grid, VMT_STAGED_THREADS, smem, stream>>>(
          pos, rot, path_id, ref, left_all, right_all, bounds, short_term,
          lanelets, entry, exit_, p, B, with_collisions);
  return (int)cudaGetLastError();
}
#else
template <int G, bool CULL>
int launch_agent(const float* pos, const float* rot, const int* path_id,
                 float* ref, float* left_all, float* right_all, float* bounds,
                 float* short_term, float* lanelets, float* entry,
                 float* exit_, const RoadParams& p, int B,
                 int with_collisions, void*) {
  const long long n = (long long)B * p.A;
  const float2* c = reinterpret_cast<const float2*>(p.center);
  const float2* l = reinterpret_cast<const float2*>(p.left);
  const float2* r = reinterpret_cast<const float2*>(p.right);
  for (long long q = 0; q < n; ++q)
    agent_geometry_group<G, CULL, false>(q, c, l, r, pos, rot, path_id, ref,
                                         left_all, right_all, bounds,
                                         short_term, lanelets, entry, exit_,
                                         p, with_collisions);
  return 0;
}
#endif

bool bad_params(const RoadParams* p, int B) {
  return B <= 0 || p->A <= 0 || p->P < 2 || p->P > VMT_MAX_P || p->K < 0 ||
         p->SI < 0 || p->n_paths <= 0 || p->boxes == nullptr ||
         (p->lanes != 4 && p->lanes != 8 && p->lanes != 16 &&
          p->lanes != 32) ||
         p->chunks < (p->P - 2) / p->lanes + 1;
}

// The staged kernel's tables: whole bulk copies of 16-byte multiples that
// fit a block's shared memory.
bool bad_staging(const RoadParams* p) {
  const long long bytes = 8ll * p->n_paths * p->P;
  return p->staged && (bytes % 16 != 0 || 3 * bytes > VMT_MAX_SMEM - 16);
}

}  // namespace

// Plain C entry points, loaded with ctypes.  Every tensor pointer is a
// device pointer to a contiguous tensor the caller has checked (float32;
// path_id int32 with entries in [0, n_paths)); `p` is a host pointer to
// the scenario's RoadParams.  Each launch goes on `stream` (PyTorch's
// current stream) and returns cudaGetLastError() after it, 0 on success;
// nothing synchronises.  Compiled as host C++, each entry point runs its
// bodies over every (env, agent) or env on host pointers and returns 0
// (1 for invalid sizes).

// Agent geometry: ref [B, A], left_all / right_all [B, A, 5], bounds
// [B, A], short_term [B, A, K, 2]; with_collisions also lanelets, entry and
// exit [B, A] (otherwise those three may be null).
extern "C" int vmt_road_agent_geometry(
    const float* pos, const float* rot, const int* path_id, float* ref,
    float* left_all, float* right_all, float* bounds, float* short_term,
    float* lanelets, float* entry, float* exit_, const RoadParams* p, int B,
    int with_collisions, void* stream) {
#ifdef __CUDACC__
  const int invalid = (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#else
  const int invalid = 1;
  void* s = stream;
#endif
  if (bad_params(p, B) || bad_staging(p) ||
      (with_collisions && !(lanelets && entry && exit_)))
    return invalid;
#define VMT_LAUNCH(G, CULL)                                                  \
  return launch_agent<G, CULL>(pos, rot, path_id, ref, left_all, right_all, \
                               bounds, short_term, lanelets, entry, exit_,  \
                               *p, B, with_collisions, s)
  switch (p->lanes * 2 + (p->cull != 0)) {
    case 8: VMT_LAUNCH(4, false);
    case 9: VMT_LAUNCH(4, true);
    case 16: VMT_LAUNCH(8, false);
    case 17: VMT_LAUNCH(8, true);
    case 32: VMT_LAUNCH(16, false);
    case 33: VMT_LAUNCH(16, true);
    case 64: VMT_LAUNCH(32, false);
    case 65: VMT_LAUNCH(32, true);
  }
#undef VMT_LAUNCH
  return invalid;
}

// Pair collisions: vertices [B, A, 5, 2], agents [B, A, A] (0/1, zero
// diagonal); A <= VMT_MAX_PAIR_A.
extern "C" int vmt_road_pair_collisions(const float* pos, const float* rot,
                                        float* vertices, float* agents,
                                        const RoadParams* p, int B,
                                        void* stream) {
  const bool bad = B <= 0 || p->A <= 0 || p->A > VMT_MAX_PAIR_A;
#ifdef __CUDACC__
  if (bad) return (int)cudaErrorInvalidValue;
  const int smem = VMT_PAIR_WARPS * pair_floats(p->A) * 4;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(pair_collisions_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  pair_collisions_kernel<<<blocks_for(B, VMT_PAIR_WARPS),
                           32 * VMT_PAIR_WARPS, smem,
                           (cudaStream_t)stream>>>(pos, rot, vertices, agents,
                                                   *p, B);
  return (int)cudaGetLastError();
#else
  (void)stream;
  if (bad) return 1;
  std::vector<float> scratch(pair_floats(p->A));
  for (long long b = 0; b < B; ++b) {
    for (int lane = 0; lane < 32; ++lane)
      pair_rects(b, lane, 32, pos, rot, scratch.data(), *p);
    for (int lane = 0; lane < 32; ++lane)
      pair_tests(lane, 32, scratch.data(), p->A);
    for (int lane = 0; lane < 32; ++lane)
      pair_store(b, lane, 32, scratch.data(), vertices, agents, p->A);
  }
  return 0;
#endif
}

// Neighbour observations: nd [B, A, k], pe [B, A, k, 2], rr [B, A, k], ve
// [B, A, k, 2], vt [B, A, k, 4, 2], raw (not normalised).  1 <= k < A <= 64.
// A warp takes an env; a block takes up to VMT_NEIGHBOR_WARPS envs, fewer
// where their scratch would pass VMT_MAX_SMEM.
extern "C" int vmt_road_neighbor_obs(const float* pos, const float* rot,
                                     const float* vel, const float* dn,
                                     float* nd, float* pe, float* rr,
                                     float* ve, float* vt, int B, int A,
                                     int k, float half_l, float half_w,
                                     void* stream) {
  const bool bad = B <= 0 || A > 64 || k < 1 || k >= A;
#ifdef __CUDACC__
  if (bad) return (int)cudaErrorInvalidValue;
  const int per_env = neighbor_floats(A, k) * 4;
  int warps = VMT_MAX_SMEM / per_env;
  warps = warps < VMT_NEIGHBOR_WARPS ? warps : VMT_NEIGHBOR_WARPS;
  const int smem = warps * per_env;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(neighbor_obs_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  neighbor_obs_kernel<<<blocks_for(B, warps), 32 * warps, smem,
                        (cudaStream_t)stream>>>(pos, rot, vel, dn, nd, pe,
                                                rr, ve, vt, B, A, k, half_l,
                                                half_w);
  return (int)cudaGetLastError();
#else
  (void)stream;
  if (bad) return 1;
  std::vector<float> scratch(neighbor_floats(A, k));
  const NeighborScratch s = neighbor_scratch(scratch.data(), A);
  for (long long b = 0; b < B; ++b) {
    for (int lane = 0; lane < 32; ++lane)
      neighbor_load(b, lane, 32, pos, rot, vel, dn, s, A);
    for (int lane = 0; lane < 32; ++lane)
      neighbor_prep(lane, 32, s, A, half_l, half_w);
    for (int i0 = 0; i0 < A; i0 += 32) {
      const int n = A - i0 < 32 ? A - i0 : 32;
      for (int lane = 0; lane < n; ++lane)
        neighbor_select(lane, i0, n, s, A, k);
      for (int lane = 0; lane < 32; ++lane)
        neighbor_store(b, lane, 32, i0, n, s, nd, pe, rr, ve, vt, A, k);
    }
  }
  return 0;
#endif
}
