// The LIDAR ray cast of the vectorized world as one CUDA kernel for
// Hopper (sm_90a): for each origin, env and ray, the distance to the first
// hit over the world's cast spheres, boxes and lines (the origin entity
// itself left out), capped at max_range.
//
// Replaces the TPU kernel vectorizedmultiagentsimulator_tpu/ops/
// raycast_pallas.py::_kernel (launched by fused_cast_rays).  Its plain
// PyTorch version is ops/raycast_cuda.py::cast_rays_plain (built on
// ops/raycast.py); ops/raycast_cuda.py also holds the wrapper, the launch
// counter and the autograd.Function whose backward re-runs the plain
// version.
//
// One launch casts every LIDAR of a group.  World groups the LIDARs that
// share a filter, base angles and max_range (navigation's and flocking's
// four agents each); their origins are the group's agents, the cast
// entities the union of the members' tables, and each origin skips itself,
// so an origin's rays meet exactly its own table.  The output is [O, B, R];
// a single cast (World.cast_rays, World.cast_ray) is the same launch with
// O = 1.
//
// Layout.  A block takes a tile of `tile` envs (32 at most) and runs three
// phases, a __syncthreads() apart:
//   1. stage: the poses (x, y, rot) of the entities the tile needs, the
//      cast entities and the origins (CastTable::need), into shared
//      memory, neighbouring threads on neighbouring entities of an env;
//   2. trig and reach: each box's cos/sin of -rot and of rot, and each
//      line's length-scaled direction, once for each env and entity (the
//      same cosf/sinf of the same input as the first design's, which took
//      them once for each ray: the bits do not change); and for each
//      (env, origin) a bit mask of the cast entities its rays can reach
//      (trig_reach below: exact, the others' distances exceed max_range);
//   3. cast: thread k takes (origin o, env, ray) = k in the order of the
//      output, so a warp's stores are consecutive floats, and tests the
//      entities of its mask, each left as soon as it is a miss.
// The table (entity slots, shape sizes, origins) is the kernel's parameter
// struct, read through the constant cache: every thread of a warp reads
// the same entry, which the constant cache broadcasts.
//
// What bounds it on the H100.  At navigation@30k (4 origins, 12 rays, 3
// cast spheres each) the poses read are 1.4 MB and the distances written
// 5.8 MB, 2.2 us at 3.35 TB/s.  The arithmetic bounds it in practice:
// each ray's accurate sincos and the tests of the entities in reach.  The
// reach masks and the exits at a miss exist because, without them, every
// ray tests every entity in full (three square roots a sphere), and one
// launch for the group takes as long as one launch a LIDAR did (PERF.md
// section 6, row 2).
//
// Parity with the plain version.  Built with -fmad=false and without fast
// math (cosf/sinf/sqrtf), it repeats the plain version's formulation and
// operation order: the guarded slab in the box frame, the closest-point
// sphere test, the guarded rxs division for lines.  A flip between hit
// and miss moves one output by up to max_range, so the two must agree ray
// by ray; the Pallas kernel's own formulation (unguarded slabs, a
// perpendicular-distance sphere test) would not.
//
// Compiled as host C++ (no __CUDACC__), the entry point runs the same
// three phases block by block with each phase's threads as a loop, which
// is how the CPU tests run this source.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define DEV __device__ __forceinline__
#define HD __host__ __device__ __forceinline__
#define LDG(p) __ldg(p)
#define GRID_CONSTANT __grid_constant__
#else
#include <cmath>
#include <vector>
#define DEV inline
#define HD inline
#define LDG(p) (*(p))
#endif

#define VMT_THREADS 256   // threads a block
#define VMT_TILE 32       // envs a block, at most
#define VMT_SMEM 49152    // shared memory a block may use without opt-in

// A launch's table, by value in the kernel's parameters.  ops/
// raycast_cuda.py mirrors this struct field for field (_CastTable) and
// fills it once per (cast table, origins).  Entities are indices into the
// world's N; the kernel stages the poses of `need` and refers to them by
// slot.
struct CastTable {
  enum { MAX_CAST = 128, MAX_ORIGINS = 64, MAX_NEED = 192 };
  int n_sphere, n_box, n_line, n_origin, n_need;
  int need[MAX_NEED];       // entity index of each staged pose
  int cast[MAX_CAST];       // need slot of each cast entity: spheres,
                            // then boxes, then lines
  float size0[MAX_CAST];    // sphere radius, box length, line length
  float size1[MAX_CAST];    // box width (0 for the others)
  int origin[MAX_ORIGINS];  // need slot of each origin
};

namespace {

// Words of an (env, origin)'s mask of the cast entities its rays can reach.
HD int mask_words(const CastTable& t) {
  return (t.n_sphere + t.n_box + t.n_line + 31) / 32;
}

// Floats of one env's shared memory: x, y and rot of each staged pose,
// 4 trig values a box, 2 a line, and each origin's reach mask.
inline int env_floats(const CastTable& t) {
  return 3 * t.n_need + 4 * t.n_box + 2 * t.n_line +
         t.n_origin * mask_words(t);
}

// The tile's shared arrays, env-major.
struct Tile {
  float* x;        // [tile][n_need]
  float* y;        // [tile][n_need]
  float* r;        // [tile][n_need]
  float* box;      // [tile][n_box][4]: cos(-rot), sin(-rot), cos(rot), sin(rot)
  float* line;     // [tile][n_line][2]: cos(rot) * length, sin(rot) * length
  unsigned* mask;  // [tile][n_origin][words]: bit e, cast entity e in reach
};

DEV Tile tile_arrays(float* sm, int tile, const CastTable& t) {
  const int m = tile * t.n_need;
  float* box = sm + 3 * m;
  float* line = box + 4 * tile * t.n_box;
  float* mask = line + 2 * tile * t.n_line;
  return {sm, sm + m, sm + 2 * m, box, line,
          reinterpret_cast<unsigned*>(mask)};
}

DEV int lowest_bit(unsigned m) {
#ifdef __CUDACC__
  return __ffs(m) - 1;
#else
  return __builtin_ctz(m);
#endif
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

// TorchUtils.safe_norm of (x, y): 0 at the zero vector.
DEV float safe_norm2(float x, float y) {
  float sq = x * x + y * y;
  return sq > 0.0f ? sqrtf(sq) : 0.0f;
}

// The guarded slab of raycast.cast_rays_to_box: the ray parameter interval
// [lo, hi] inside |p + t d| <= half, with finite sentinels for d == 0.
DEV void slab(float half, float p, float d, float* lo, float* hi) {
  const bool parallel = d == 0.0f;
  const float safe_d = parallel ? 1.0f : d;
  const float t1 = (-half - p) / safe_d;
  const float t2 = (half - p) / safe_d;
  *lo = fminf(t1, t2);
  *hi = fmaxf(t1, t2);
  if (parallel) {
    const bool inside = (p >= -half) && (p <= half);
    *lo = inside ? -1e9f : 1e9f;
    *hi = inside ? 1e9f : -1e9f;
  }
}

// Phase 1, thread `tid` of `nt`: the poses of the tile's n envs from env
// b0 on.
DEV void stage(int tid, int nt, long long b0, int n, const float* pos,
               const float* rot, const Tile& s, const CastTable& t, int N) {
  const int M = t.n_need;
  for (int k = tid; k < n * M; k += nt) {
    const int b = k / M, m = k - b * M;
    const size_t q = (size_t)(b0 + b) * N + t.need[m];
    s.x[k] = LDG(pos + 2 * q);
    s.y[k] = LDG(pos + 2 * q + 1);
    s.r[k] = LDG(rot + q);
  }
}

// Phase 2: each box's and each line's trig, once an env; and for each
// (env, origin) the cast entities its rays can reach.  A ray's hit on a
// sphere of radius r lies on its circle, on a box within half its
// diagonal of its centre, on a line within half its length, so an entity
// whose centre is farther than max_range + that reach from the origin
// gives a distance above max_range, which the running minimum (never
// above max_range) ignores.  The test keeps a margin of 1e-3 of the reach,
// 1e-4 and 1e-5 of the coordinates' size, far above the few ulps by which
// the float distances differ from the exact ones; the origin itself is
// left out.
DEV void trig_reach(int tid, int nt, int n, const Tile& s, const CastTable& t,
                    float max_range) {
  const int M = t.n_need, ns = t.n_sphere, nb = t.n_box, nl = t.n_line;
  const int E = nb + nl, C = ns + E, W = mask_words(t), O = t.n_origin;
  for (int k = tid; k < n * E; k += nt) {
    const int b = k / E, e = k - b * E;
    const int c = ns + e;  // index into cast / size0
    const float rr = s.r[b * M + t.cast[c]];
    if (e < nb) {
      float* o = s.box + (b * nb + e) * 4;
      sin_cos(-rr, o + 1, o);
      sin_cos(rr, o + 3, o + 2);
    } else {
      const float len = t.size0[c];
      float* o = s.line + (b * nl + (e - nb)) * 2;
      float sr, cr;
      sin_cos(rr, &sr, &cr);
      o[0] = cr * len;
      o[1] = sr * len;
    }
  }
  for (int k = tid; k < n * O; k += nt) {
    const int b = k / O, o = k - b * O;
    const int self = t.origin[o];
    const float ox = s.x[b * M + self], oy = s.y[b * M + self];
    unsigned* mk = s.mask + (size_t)k * W;
    for (int w = 0; w < W; ++w) mk[w] = 0u;
    for (int e = 0; e < C; ++e) {
      const int m = t.cast[e];
      if (m == self) continue;
      const float ex = s.x[b * M + m], ey = s.y[b * M + m];
      const float size =
          e < ns ? t.size0[e]
                 : (e < ns + nb ? 0.5f * sqrtf(t.size0[e] * t.size0[e] +
                                               t.size1[e] * t.size1[e])
                                : 0.5f * t.size0[e]);
      const float reach = (max_range + size) * 1.001f + 1e-4f +
                          1e-5f * (fabsf(ox) + fabsf(oy) + fabsf(ex) +
                                   fabsf(ey));
      const float dx = ex - ox, dy = ey - oy;
      if (dx * dx + dy * dy <= reach * reach) mk[e >> 5] |= 1u << (e & 31);
    }
  }
}

// Phase 3: thread k takes output k of the tile, (origin, env, ray) in the
// output's order, and tests the entities in its (env, origin)'s mask.
// angle_stride 0: angles are [R] base angles, to which the origin's rot is
// added; R: [B, R] world-frame angles (one origin).  Each test leaves as
// soon as the plain version's result is a miss (max_range, which the
// minimum ignores), and otherwise makes the plain version's operations.
DEV void cast(int tid, int nt, long long b0, int n, const float* angles,
              float* out, const Tile& s, const CastTable& t, long long B,
              int R, int angle_stride, float max_range) {
  const int M = t.n_need, W = mask_words(t), O = t.n_origin;
  const int ns = t.n_sphere, nb = t.n_box;
  // fp32(max_range / 2): halving is exact, as in the plain version.
  const float half_range = max_range / 2.0f;
  // Item k = (o * n + b) * R + r, walked from tid in steps of nt without
  // a division an item.
  int o = tid / (n * R), b = (tid - o * n * R) / R;
  int r = tid - (o * n + b) * R;
  const int db = nt / R, dr = nt - db * R;
  for (; o < O;) {
    const int self = t.origin[o];
    const float* xs = s.x + b * M;
    const float* ys = s.y + b * M;
    const float ox = xs[self], oy = ys[self];
    float ang = LDG(angles + (size_t)(b0 + b) * angle_stride + r);
    if (angle_stride == 0) ang = ang + s.r[b * M + self];
    float dx, dy;
    sin_cos(ang, &dy, &dx);
    // geometry.closest_point_line on the line through the ray's midpoint
    const float lx = ox + dx * half_range, ly = oy + dy * half_range;
    float dmin = max_range;
    const unsigned* mk = s.mask + ((size_t)b * O + o) * W;
    for (int w = 0; w < W; ++w) {
      for (unsigned bits = mk[w]; bits; bits &= bits - 1) {
        const int e = w * 32 + lowest_bit(bits);
        const int m = t.cast[e];
        if (e < ns) {
          // ---- sphere: closest point of the ray's line to the centre ---- //
          const float sx = xs[m], sy = ys[m];
          if (!(((sx - ox) * dx + (sy - oy) * dy) > 0.0f)) continue;
          const float sr = t.size0[e];
          const float dot = (lx - sx) * dx + (ly - sy) * dy;
          const float sign =
              (dot > 0.0f) ? 1.0f : ((dot < 0.0f) ? -1.0f : 0.0f);
          const float m_c = sign * fabsf(dot);
          const float cx = lx - m_c * dx, cy = ly - m_c * dy;
          const float d_norm = safe_norm2(sx - cx, sy - cy);
          if (!(d_norm < sr)) continue;
          const float a = sr * sr - d_norm * d_norm;
          const float mm = sqrtf(a > 0.0f ? a : 1e-8f);
          dmin = fminf(dmin, safe_norm2(cx - ox, cy - oy) - mm);
        } else if (e < ns + nb) {
          // ---- box: slab method in the box frame ---- //
          const float bx = xs[m], by = ys[m];
          const float* tr = s.box + (b * nb + (e - ns)) * 4;
          const float c = tr[0], sn = tr[1];
          const float pox = ox - bx, poy = oy - by;
          const float pax = pox * c - poy * sn, pay = pox * sn + poy * c;
          const float rdx = dx * c - dy * sn, rdy = dx * sn + dy * c;
          float tx_lo, tx_hi, ty_lo, ty_hi;
          slab(t.size0[e] / 2.0f, pax, rdx, &tx_lo, &tx_hi);
          slab(t.size1[e] / 2.0f, pay, rdy, &ty_lo, &ty_hi);
          const float tmin = fmaxf(tx_lo, ty_lo), tmax = fminf(tx_hi, ty_hi);
          if (!(tmax >= tmin && tmin > 0.0f)) continue;
          const float cb = tr[2], sb = tr[3];
          const float iax = tmin * rdx + pax, iay = tmin * rdy + pay;
          const float iwx = (iax * cb - iay * sb) + bx;
          const float iwy = (iax * sb + iay * cb) + by;
          dmin = fminf(dmin, safe_norm2(ox - iwx, oy - iwy));
        } else {
          // ---- line: segment/ray crossing ---- //
          const float lnx = xs[m], lny = ys[m];
          const float* tr = s.line + (b * (t.n_line) + (e - ns - nb)) * 2;
          const float rx = tr[0], ry = tr[1];
          const float rxs = rx * dy - ry * dx;
          if (rxs == 0.0f) continue;  // parallel: a miss
          const float qx = ox - lnx, qy = oy - lny;
          const float tt = qx * (dy / rxs) - qy * (dx / rxs);
          if (tt > 0.5f || tt < -0.5f) continue;
          const float u = qx * (ry / rxs) - qy * (rx / rxs);
          if (u < 0.0f) continue;
          dmin = fminf(dmin, safe_norm2(u * dx, u * dy));
        }
      }
    }
    out[((size_t)o * B + b0 + b) * R + r] = dmin;
    r += dr;
    b += db;
    if (r >= R) {
      r -= R;
      ++b;
    }
    while (b >= n) {
      b -= n;
      ++o;
    }
  }
}

// Envs a block: 32, or fewer where their poses, trig and masks would pass
// VMT_SMEM.
inline int tile_envs(const CastTable& t) {
  const int fit = VMT_SMEM / (4 * env_floats(t));
  return fit < VMT_TILE ? fit : VMT_TILE;
}

inline bool bad_table(const CastTable* t, int B, int N, int R) {
  if (B <= 0 || N <= 0 || R <= 0 || t->n_origin < 1 ||
      t->n_origin > CastTable::MAX_ORIGINS || t->n_need < 1 ||
      t->n_need > CastTable::MAX_NEED || t->n_sphere < 0 || t->n_box < 0 ||
      t->n_line < 0 ||
      t->n_sphere + t->n_box + t->n_line > CastTable::MAX_CAST ||
      tile_envs(*t) < 1)
    return true;
  for (int m = 0; m < t->n_need; ++m)
    if (t->need[m] < 0 || t->need[m] >= N) return true;
  for (int e = 0; e < t->n_sphere + t->n_box + t->n_line; ++e)
    if (t->cast[e] < 0 || t->cast[e] >= t->n_need) return true;
  for (int o = 0; o < t->n_origin; ++o)
    if (t->origin[o] < 0 || t->origin[o] >= t->n_need) return true;
  return false;
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(VMT_THREADS)
cast_rays_kernel(const float* __restrict__ pos, const float* __restrict__ rot,
                 const float* __restrict__ angles, float* __restrict__ out,
                 const GRID_CONSTANT CastTable t, int B, int N, int R,
                 int tile, int angle_stride, float max_range) {
  extern __shared__ float sm[];
  const long long b0 = (long long)blockIdx.x * tile;
  const int n = (int)((long long)B - b0 < tile ? (long long)B - b0 : tile);
  const Tile s = tile_arrays(sm, tile, t);
  stage(threadIdx.x, blockDim.x, b0, n, pos, rot, s, t, N);
  __syncthreads();
  trig_reach(threadIdx.x, blockDim.x, n, s, t, max_range);
  __syncthreads();
  cast(threadIdx.x, blockDim.x, b0, n, angles, out, s, t, B, R, angle_stride,
       max_range);
}
#endif

}  // namespace

// Plain C entry point, loaded with ctypes.  Every tensor pointer is a
// device pointer to a contiguous tensor the caller has checked: pos
// [B, N, 2], rot [B, N, 1], out [n_origin, B, R]; `t` is a host pointer to
// the launch's CastTable.  `angles` is [R] base angles, to which each
// origin's rot is added (angle_stride 0), or [B, R] world-frame angles
// (angle_stride R, one origin).  The launch goes on `stream` (PyTorch's
// current stream).  Returns cudaGetLastError() after the launch, 0 on
// success; it does not synchronise.  Compiled as host C++, it runs the
// blocks in order on host pointers and returns 0 (1 for an invalid table).
extern "C" int vmt_cast_rays(const float* pos, const float* rot,
                             const float* angles, float* out,
                             const CastTable* t, int B, int N, int R,
                             int angle_stride, float max_range,
                             void* stream) {
#ifdef __CUDACC__
  if (bad_table(t, B, N, R) ||
      (angle_stride != 0 && (angle_stride != R || t->n_origin != 1)))
    return (int)cudaErrorInvalidValue;
  const int tile = tile_envs(*t);
  const int blocks = (int)(((long long)B + tile - 1) / tile);
  const int smem = tile * env_floats(*t) * 4;
  cast_rays_kernel<<<blocks, VMT_THREADS, smem, (cudaStream_t)stream>>>(
      pos, rot, angles, out, *t, B, N, R, tile, angle_stride, max_range);
  return (int)cudaGetLastError();
#else
  (void)stream;
  if (bad_table(t, B, N, R) ||
      (angle_stride != 0 && (angle_stride != R || t->n_origin != 1)))
    return 1;
  const int tile = tile_envs(*t);
  std::vector<float> sm((size_t)tile * env_floats(*t) + 1);
  const Tile s = tile_arrays(sm.data(), tile, *t);
  for (long long b0 = 0; b0 < B; b0 += tile) {
    const int n = (int)(B - b0 < tile ? B - b0 : tile);
    stage(0, 1, b0, n, pos, rot, s, *t, N);
    trig_reach(0, 1, n, s, *t, max_range);
    cast(0, 1, b0, n, angles, out, s, *t, B, R, angle_stride, max_range);
  }
  return 0;
#endif
}
