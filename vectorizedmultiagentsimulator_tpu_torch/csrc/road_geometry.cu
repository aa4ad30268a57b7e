// road_traffic's path geometry as three CUDA kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels of vectorizedmultiagentsimulator_tpu/ops/
// road_geometry_pallas.py:
//   agent_geometry_kernel    <- _make_agent_kernel   (fused_geometry)
//   pair_collisions_kernel   <- _make_pair_kernel    (fused_geometry)
//   neighbor_obs_kernel      <- _make_neighbor_obs_kernel
//                               (fused_neighbor_obs)
// Their plain PyTorch versions are ops/road_geometry.py::geometry_plain and
// ::neighbor_obs_plain; ops/road_geometry_cuda.py holds the wrappers, the
// launch counts, the device path tables and the autograd.Functions whose
// backward re-runs the plain versions.
//
// Layout.  One thread per (env, agent) in the port's native layout: pos
// [B, A, 2], rot [B, A], vel [B, A, 2], path_id [B, A] int32, dn [B, A, A],
// every output [B, A, ...].  Neighbouring threads are neighbouring agents
// of one env.  The static path tables (centre line, left and right
// boundaries [n_paths, P, 2], 40 x 185 x 6 floats at CPM-Lab's map, about
// 178 KB, plus the integer meta rows and the entry/exit segments) stay in
// device memory, are read through the read-only cache and stay in L2.  The
// TPU kernels' one-hot matrix gathers and bf16 3-way table split serve the
// TPU's matrix unit and are left out: a thread reads its path's rows
// directly.
//
// What bounds them on the H100.  At road_traffic@10k (200,000 threads, 20
// agents, P = 185):
//   * agent geometry: per thread two passes over up to 176 centre-line
//     segments (the least distance, then the first segment within 1e-5 of
//     it), one pass over each boundary's segments with 5 points' distances
//     and, with collisions, 4 rectangle edges' crossing tests: about 6e4
//     operations a thread, against about 100 bytes read and written, so
//     the arithmetic bounds it (about 0.2 ms at the fp32 rate);
//   * pair collisions: 20 agents' vertices and 4 x 4 segment tests per
//     other agent, about 7e3 operations a thread (0.02 ms);
//   * neighbour observations: a row of dn and the chosen neighbours' poses
//     read, 28 floats written a thread, about 40 MB: bytes bound it.
// This first version keeps each thread's work in registers, one load of
// each table point per thread and pass; putting the tables in shared
// memory, or a warp per agent's polyline, is later work.
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
// sy*(p1x - q1x).  Segments past a polyline's true end are left out where
// the plain version replicates the last real distance or meets only
// degenerate padding segments, which change neither a minimum, nor the
// first index within the tolerance, nor any strict crossing.
//
// Compiled as host C++ (no __CUDACC__), the same per-thread bodies run as
// loops over the (env, agent) index, which is how the CPU tests run this
// source.

#include <cmath>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define DEV __device__ __forceinline__
#define LDG(p) __ldg(p)
#else
#define DEV inline
#define LDG(p) (*(p))
#endif

#define VMT_THREADS 128

// The static configuration and the device path tables.  ops/
// road_geometry_cuda.py mirrors this struct field for field (_RoadParams),
// fills it once per scenario and passes its host address.  Tables:
//   center, left, right  [n_paths, P, 2] float
//   meta                 [n_paths, 4] int: n_points, n_left, n_right,
//                        is_loop
//   ends                 [n_paths, 2, 2, 2] float: the entry segment (left
//                        and right boundary's first points), the exit
//                        segment (their last points)
// half_l, half_w: half the agent's length and width (fp32 of the plain
// version's Python halves); K short-term points every SI-th point;
// entry_exit: whether the scenario tests entry and exit segments (map '3'
// or testing mode, with paths that are not loops).
struct RoadParams {
  const float* center;
  const float* left;
  const float* right;
  const int* meta;
  const float* ends;
  int n_paths, P, A, K, SI, entry_exit;
  float half_l, half_w;
};

namespace {

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
DEV void rectangle(float px, float py, float th, float half_l, float half_w,
                   float* vx, float* vy) {
  const float c = cosf(th), s = sinf(th);
  const float bx[5] = {half_l, half_l, -half_l, -half_l, half_l};
  const float by[5] = {half_w, -half_w, -half_w, half_w, half_w};
#pragma unroll
  for (int v = 0; v < 5; ++v) {
    vx[v] = bx[v] * c - by[v] * s + px;
    vy[v] = bx[v] * s + by[v] * c + py;
  }
}

// Agent geometry of (env, agent) number q = env * A + agent.
DEV void agent_geometry_one(long long q, const float* __restrict__ pos,
                            const float* __restrict__ rot,
                            const int* __restrict__ path_id,
                            float* __restrict__ ref,
                            float* __restrict__ left_all,
                            float* __restrict__ right_all,
                            float* __restrict__ bounds,
                            float* __restrict__ short_term,
                            float* __restrict__ lanelets,
                            float* __restrict__ entry,
                            float* __restrict__ exit_, const RoadParams& p,
                            int with_collisions) {
  const float px = pos[2 * q], py = pos[2 * q + 1];
  const int pid = path_id[q];
  const int n = LDG(p.meta + 4 * pid), n_l = LDG(p.meta + 4 * pid + 1),
            n_r = LDG(p.meta + 4 * pid + 2);
  const bool is_loop = LDG(p.meta + 4 * pid + 3) != 0;
  const float* c_tab = p.center + (size_t)pid * p.P * 2;

  // Reference path: the least distance over the real segments, then the
  // first segment within 1e-5 of it.
  const int n_seg = n - 1 > 1 ? n - 1 : 1;
  float dist = 0.0f;
  for (int j = 0; j < n_seg; ++j) {
    const float d = seg_dist(px, py, LDG(c_tab + 2 * j),
                             LDG(c_tab + 2 * j + 1), LDG(c_tab + 2 * j + 2),
                             LDG(c_tab + 2 * j + 3));
    dist = j == 0 ? d : fminf(dist, d);
  }
  const float thr = dist + 1e-5f;
  int first = 0;
  for (int j = 0; j < n_seg; ++j) {
    const float d = seg_dist(px, py, LDG(c_tab + 2 * j),
                             LDG(c_tab + 2 * j + 1), LDG(c_tab + 2 * j + 2),
                             LDG(c_tab + 2 * j + 3));
    if (d <= thr) {
      first = j;
      break;
    }
  }
  ref[q] = dist;

  // Short-term path: every SI-th point from the closest on, wrapping
  // around a loop, clamped to the table.
  const int idx = first + 1;
  for (int k = 0; k < p.K; ++k) {
    int fut = k * p.SI + idx + 1;
    if (is_loop && fut >= n - 1) fut = (fut + 1) % n;
    fut = fut < 0 ? 0 : (fut > p.P - 1 ? p.P - 1 : fut);
    short_term[(q * p.K + k) * 2] = LDG(c_tab + 2 * fut);
    short_term[(q * p.K + k) * 2 + 1] = LDG(c_tab + 2 * fut + 1);
  }

  float vx[5], vy[5];
  rectangle(px, py, rot[q], p.half_l, p.half_w, vx, vy);

  // Each boundary: the centre's and the 4 corners' least distances, and
  // the rectangle's edges against the boundary's segments.
  float best = 0.0f;
  bool lane_hit = false;
  for (int side = 0; side < 2; ++side) {
    const float* b_tab = (side == 0 ? p.left : p.right) + (size_t)pid * p.P * 2;
    const int nb = side == 0 ? n_l : n_r;
    const int nb_seg = nb - 1 > 1 ? nb - 1 : 1;
    float m[5];
    for (int j = 0; j < nb_seg; ++j) {
      const float x0 = LDG(b_tab + 2 * j), y0 = LDG(b_tab + 2 * j + 1);
      const float x1 = LDG(b_tab + 2 * j + 2), y1 = LDG(b_tab + 2 * j + 3);
      const float d0 = seg_dist(px, py, x0, y0, x1, y1);
      m[0] = j == 0 ? d0 : fminf(m[0], d0);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float d = seg_dist(vx[v], vy[v], x0, y0, x1, y1);
        m[v + 1] = j == 0 ? d : fminf(m[v + 1], d);
      }
      if (with_collisions && !lane_hit) {
#pragma unroll
        for (int s = 0; s < 4; ++s)
          lane_hit = lane_hit || crosses(vx[s], vy[s], vx[s + 1], vy[s + 1],
                                         x0, y0, x1, y1);
      }
    }
    float* out = (side == 0 ? left_all : right_all) + q * 5;
    out[0] = m[0] - p.half_w;
    for (int v = 1; v < 5; ++v) out[v] = m[v];
    for (int v = 0; v < 5; ++v) {
      const float x = v == 0 ? m[0] - p.half_w : m[v];
      best = (side == 0 && v == 0) ? x : fminf(best, x);
    }
  }
  bounds[q] = best;
  if (!with_collisions) return;
  lanelets[q] = lane_hit ? 1.0f : 0.0f;

  // Entry and exit segments of a path that is not a loop.
  float hit_end[2] = {0.0f, 0.0f};
  if (p.entry_exit && !is_loop) {
    for (int e = 0; e < 2; ++e) {
      const float* seg = p.ends + ((size_t)pid * 2 + e) * 4;
      const float q1x = LDG(seg), q1y = LDG(seg + 1), q2x = LDG(seg + 2),
                  q2y = LDG(seg + 3);
      bool h = false;
      for (int s = 0; s < 4; ++s)
        h = h || crosses(vx[s], vy[s], vx[s + 1], vy[s + 1], q1x, q1y, q2x,
                         q2y);
      hit_end[e] = h ? 1.0f : 0.0f;
    }
  }
  entry[q] = hit_end[0];
  exit_[q] = hit_end[1];
}

// Vertices of (env, agent i) number q and row i of the agent-agent
// crossing matrix: agent i's edges against every other agent's.
DEV void pair_collisions_one(long long q, const float* __restrict__ pos,
                             const float* __restrict__ rot,
                             float* __restrict__ vertices,
                             float* __restrict__ agents, const RoadParams& p) {
  const int A = p.A;
  const long long b = q / A;
  const int i = (int)(q % A);
  float vx[5], vy[5];
  rectangle(pos[2 * q], pos[2 * q + 1], rot[q], p.half_l, p.half_w, vx, vy);
  for (int v = 0; v < 5; ++v) {
    vertices[(q * 5 + v) * 2] = vx[v];
    vertices[(q * 5 + v) * 2 + 1] = vy[v];
  }
  for (int j = 0; j < A; ++j) {
    bool hit = false;
    if (j != i) {
      const long long r = b * A + j;
      float wx[5], wy[5];
      rectangle(pos[2 * r], pos[2 * r + 1], rot[r], p.half_l, p.half_w, wx,
                wy);
      for (int s = 0; s < 4 && !hit; ++s)
        for (int t = 0; t < 4 && !hit; ++t)
          hit = crosses(vx[s], vy[s], vx[s + 1], vy[s + 1], wx[t], wy[t],
                        wx[t + 1], wy[t + 1]);
    }
    agents[q * A + j] = hit ? 1.0f : 0.0f;
  }
}

// The k nearest other agents of (env, agent i) number q in its ego frame.
// Round r takes the first least entry of row i of dn among those not yet
// taken (a taken entry counts as +inf, as the plain version sets it).
DEV void neighbor_obs_one(long long q, const float* __restrict__ pos,
                          const float* __restrict__ rot,
                          const float* __restrict__ vel,
                          const float* __restrict__ dn,
                          float* __restrict__ nd, float* __restrict__ pe,
                          float* __restrict__ rr, float* __restrict__ ve,
                          float* __restrict__ vt, int A, int k, float half_l,
                          float half_w) {
  const long long b = q / A;
  const float* row = dn + q * A;
  const float px = pos[2 * q], py = pos[2 * q + 1], th = rot[q];
  const float c = cosf(-th), s = sinf(-th);
  unsigned long long taken = 0ull;
  for (int r = 0; r < k; ++r) {
    float best = 0.0f;
    int pick = 0;
    for (int j = 0; j < A; ++j) {
      const float v = ((taken >> j) & 1ull) ? INFINITY : row[j];
      if (j == 0 || v < best) {
        best = v;
        pick = j;
      }
    }
    taken |= 1ull << pick;
    const long long o = q * k + r;
    nd[o] = best;

    const long long jj = b * A + pick;
    const float pjx = pos[2 * jj], pjy = pos[2 * jj + 1], thj = rot[jj];
    const float vjx = vel[2 * jj], vjy = vel[2 * jj + 1];
    const float sq = vjx * vjx + vjy * vjy;
    const float va = sq > 0.0f ? sqrtf(sq) : 0.0f;
    const float relx = pjx - px, rely = pjy - py;
    pe[2 * o] = relx * c - rely * s;
    pe[2 * o + 1] = relx * s + rely * c;
    const float rot_rel = thj - th;
    rr[o] = rot_rel;
    ve[2 * o] = va * cosf(rot_rel);
    ve[2 * o + 1] = va * sinf(rot_rel);
    float wx[5], wy[5];
    rectangle(pjx, pjy, thj, half_l, half_w, wx, wy);
    for (int v = 0; v < 4; ++v) {
      const float ux = wx[v] - px, uy = wy[v] - py;
      vt[(o * 4 + v) * 2] = ux * c - uy * s;
      vt[(o * 4 + v) * 2 + 1] = ux * s + uy * c;
    }
  }
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(VMT_THREADS)
agent_geometry_kernel(const float* __restrict__ pos,
                      const float* __restrict__ rot,
                      const int* __restrict__ path_id, float* ref,
                      float* left_all, float* right_all, float* bounds,
                      float* short_term, float* lanelets, float* entry,
                      float* exit_, RoadParams p, int B,
                      int with_collisions) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= (long long)B * p.A) return;
  agent_geometry_one(q, pos, rot, path_id, ref, left_all, right_all, bounds,
                     short_term, lanelets, entry, exit_, p, with_collisions);
}

__global__ void __launch_bounds__(VMT_THREADS)
pair_collisions_kernel(const float* __restrict__ pos,
                       const float* __restrict__ rot, float* vertices,
                       float* agents, RoadParams p, int B) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= (long long)B * p.A) return;
  pair_collisions_one(q, pos, rot, vertices, agents, p);
}

__global__ void __launch_bounds__(VMT_THREADS)
neighbor_obs_kernel(const float* __restrict__ pos,
                    const float* __restrict__ rot,
                    const float* __restrict__ vel,
                    const float* __restrict__ dn, float* nd, float* pe,
                    float* rr, float* ve, float* vt, int B, int A, int k,
                    float half_l, float half_w) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= (long long)B * A) return;
  neighbor_obs_one(q, pos, rot, vel, dn, nd, pe, rr, ve, vt, A, k, half_l,
                   half_w);
}

int blocks_for(long long n) {
  return (int)((n + VMT_THREADS - 1) / VMT_THREADS);
}
#endif

bool bad_params(const RoadParams* p, int B) {
  return B <= 0 || p->A <= 0 || p->P < 2 || p->K < 0 || p->SI < 0 ||
         p->n_paths <= 0;
}

}  // namespace

// Plain C entry points, loaded with ctypes.  Every tensor pointer is a
// device pointer to a contiguous tensor the caller has checked (float32;
// path_id int32 with entries in [0, n_paths)); `p` is a host pointer to
// the scenario's RoadParams.  Each launch goes on `stream` (PyTorch's
// current stream) and returns cudaGetLastError() after it, 0 on success;
// nothing synchronises.  Compiled as host C++, each entry point runs its
// per-thread body over every (env, agent) on host pointers and returns 0
// (1 for invalid sizes).

// Agent geometry: ref [B, A], left_all / right_all [B, A, 5], bounds
// [B, A], short_term [B, A, K, 2]; with_collisions also lanelets, entry and
// exit [B, A] (otherwise those three may be null).
extern "C" int vmt_road_agent_geometry(
    const float* pos, const float* rot, const int* path_id, float* ref,
    float* left_all, float* right_all, float* bounds, float* short_term,
    float* lanelets, float* entry, float* exit_, const RoadParams* p, int B,
    int with_collisions, void* stream) {
  const long long n = (long long)B * p->A;
#ifdef __CUDACC__
  if (bad_params(p, B) ||
      (with_collisions && !(lanelets && entry && exit_)))
    return (int)cudaErrorInvalidValue;
  agent_geometry_kernel<<<blocks_for(n), VMT_THREADS, 0,
                          (cudaStream_t)stream>>>(
      pos, rot, path_id, ref, left_all, right_all, bounds, short_term,
      lanelets, entry, exit_, *p, B, with_collisions);
  return (int)cudaGetLastError();
#else
  (void)stream;
  if (bad_params(p, B) ||
      (with_collisions && !(lanelets && entry && exit_)))
    return 1;
  for (long long q = 0; q < n; ++q)
    agent_geometry_one(q, pos, rot, path_id, ref, left_all, right_all,
                       bounds, short_term, lanelets, entry, exit_, *p,
                       with_collisions);
  return 0;
#endif
}

// Pair collisions: vertices [B, A, 5, 2], agents [B, A, A] (0/1, zero
// diagonal).
extern "C" int vmt_road_pair_collisions(const float* pos, const float* rot,
                                        float* vertices, float* agents,
                                        const RoadParams* p, int B,
                                        void* stream) {
  const long long n = (long long)B * p->A;
#ifdef __CUDACC__
  if (bad_params(p, B)) return (int)cudaErrorInvalidValue;
  pair_collisions_kernel<<<blocks_for(n), VMT_THREADS, 0,
                           (cudaStream_t)stream>>>(pos, rot, vertices,
                                                   agents, *p, B);
  return (int)cudaGetLastError();
#else
  (void)stream;
  if (bad_params(p, B)) return 1;
  for (long long q = 0; q < n; ++q)
    pair_collisions_one(q, pos, rot, vertices, agents, *p);
  return 0;
#endif
}

// Neighbour observations: nd [B, A, k], pe [B, A, k, 2], rr [B, A, k], ve
// [B, A, k, 2], vt [B, A, k, 4, 2], raw (not normalised).  1 <= k < A <= 64.
extern "C" int vmt_road_neighbor_obs(const float* pos, const float* rot,
                                     const float* vel, const float* dn,
                                     float* nd, float* pe, float* rr,
                                     float* ve, float* vt, int B, int A,
                                     int k, float half_l, float half_w,
                                     void* stream) {
  const long long n = (long long)B * A;
#ifdef __CUDACC__
  if (B <= 0 || A > 64 || k < 1 || k >= A) return (int)cudaErrorInvalidValue;
  neighbor_obs_kernel<<<blocks_for(n), VMT_THREADS, 0,
                        (cudaStream_t)stream>>>(pos, rot, vel, dn, nd, pe,
                                                rr, ve, vt, B, A, k, half_l,
                                                half_w);
  return (int)cudaGetLastError();
#else
  (void)stream;
  if (B <= 0 || A > 64 || k < 1 || k >= A) return 1;
  for (long long q = 0; q < n; ++q)
    neighbor_obs_one(q, pos, rot, vel, dn, nd, pe, rr, ve, vt, A, k, half_l,
                     half_w);
  return 0;
#endif
}
