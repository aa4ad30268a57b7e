// The LIDAR ray cast of the vectorized world as one CUDA kernel for
// Hopper (sm_90a): for each env and ray, the distance to the first hit
// over the world's cast spheres, boxes and lines, capped at max_range.
//
// Replaces the TPU kernel vectorizedmultiagentsimulator_tpu/ops/
// raycast_pallas.py::_kernel (launched by fused_cast_rays).  Its plain
// PyTorch version is ops/raycast_cuda.py::cast_rays_plain (built on
// ops/raycast.py); ops/raycast_cuda.py also holds the wrapper, the launch
// counter and the autograd.Function whose backward re-runs the plain
// version.
//
// Layout.  One thread per (env, ray), looping over the cast entities.  The
// thread reads the world state directly: the origin entity's pos and rot
// and each cast entity's pos and rot in the native [B, N, 2] / [B, N, 1]
// layout, through the world's cached int64 index tables, so no gather of
// the poses precedes the launch.  A LIDAR passes its base angles [R] and
// the kernel forms angle = base[r] + rot[b, origin] itself (one fp32 add,
// as the plain version does); world-frame angles [B, R] are read as they
// are.
//
// What bounds it on the H100.  At navigation@30k (R = 12 rays, E = 3 cast
// spheres) one call reads about 1.1 MB of poses and writes 1.4 MB of
// distances: 0.75 us at 3.35 TB/s, and about a hundred flops a ray.
// Launch overhead bounds it; the design keeps the cast to one launch
// per LIDAR measure (no gather or angle launches before it) and keeps every
// intermediate in registers.
//
// Parity with the plain version.  Built with -fmad=false and without fast
// math (cosf/sinf/sqrtf), it repeats the plain version's formulation and
// operation order: the guarded slab in the box frame, the closest-point
// sphere test, the guarded rxs division for lines.  A flip between hit
// and miss moves one output by up to max_range, so the two must agree ray
// by ray; the Pallas kernel's own formulation (unguarded slabs, a
// perpendicular-distance sphere test) would not.

#include <cuda_runtime.h>

#define VMT_THREADS 128

// The cast entities, device pointers.  ops/raycast_cuda.py mirrors this
// struct field for field (_CastTable), fills it once per cast table and
// passes its host address to vmt_cast_rays.
struct CastTable {
  const long long* sphere_idx;  // [n_sphere] entity indices
  const float* sphere_radius;   // [n_sphere]
  const long long* box_idx;     // [n_box]
  const float* box_length;      // [n_box]
  const float* box_width;       // [n_box]
  const long long* line_idx;    // [n_line]
  const float* line_length;     // [n_line]
  int n_sphere, n_box, n_line;
};

namespace {

// TorchUtils.safe_norm of (x, y): 0 at the zero vector.
__device__ __forceinline__ float safe_norm2(float x, float y) {
  float sq = x * x + y * y;
  return sq > 0.0f ? sqrtf(sq) : 0.0f;
}

// The guarded slab of raycast.cast_rays_to_box: the ray parameter interval
// [lo, hi] inside |p + t d| <= half, with finite sentinels for d == 0.
__device__ __forceinline__ void slab(float half, float p, float d, float* lo,
                                     float* hi) {
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

__global__ void __launch_bounds__(VMT_THREADS)
cast_rays_kernel(const float* __restrict__ pos, const float* __restrict__ rot,
                 const float* __restrict__ angles, float* __restrict__ out,
                 CastTable t, int B, int N, int R, int origin,
                 int angle_stride, float max_range) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (long long)B * R) return;
  const int b = (int)(k / R), r = (int)(k % R);
  const size_t pb = (size_t)b * N;
  const float ox = pos[(pb + origin) * 2], oy = pos[(pb + origin) * 2 + 1];
  float ang = angles[(size_t)b * angle_stride + r];
  if (angle_stride == 0) ang = ang + rot[pb + origin];  // base angles [R]
  const float dx = cosf(ang), dy = sinf(ang);
  // fp32(max_range / 2): halving is exact, as in the plain version.
  const float half_range = max_range / 2.0f;
  float dmin = max_range;

  // ---- spheres: closest point of the ray's line to the centre ---- //
  for (int e = 0; e < t.n_sphere; ++e) {
    const size_t i = pb + (size_t)t.sphere_idx[e];
    const float sx = pos[i * 2], sy = pos[i * 2 + 1];
    const float sr = t.sphere_radius[e];
    // geometry.closest_point_line on the line through the ray's midpoint
    const float lx = ox + dx * half_range, ly = oy + dy * half_range;
    const float dot = (lx - sx) * dx + (ly - sy) * dy;
    const float sign = (dot > 0.0f) ? 1.0f : ((dot < 0.0f) ? -1.0f : 0.0f);
    const float m_c = sign * fabsf(dot);
    const float cx = lx - m_c * dx, cy = ly - m_c * dy;
    const float d_norm = safe_norm2(sx - cx, sy - cy);
    const float a = sr * sr - d_norm * d_norm;
    const float m = sqrtf(a > 0.0f ? a : 1e-8f);
    const bool in_front = ((sx - ox) * dx + (sy - oy) * dy) > 0.0f;
    const float dist = safe_norm2(cx - ox, cy - oy) - m;
    dmin = fminf(dmin, (d_norm < sr && in_front) ? dist : max_range);
  }

  // ---- boxes: slab method in the box frame ---- //
  for (int e = 0; e < t.n_box; ++e) {
    const size_t i = pb + (size_t)t.box_idx[e];
    const float bx = pos[i * 2], by = pos[i * 2 + 1], br = rot[i];
    const float nbr = -br;
    const float c = cosf(nbr), s = sinf(nbr);
    const float pox = ox - bx, poy = oy - by;
    const float pax = pox * c - poy * s, pay = pox * s + poy * c;
    const float rdx = dx * c - dy * s, rdy = dx * s + dy * c;
    float tx_lo, tx_hi, ty_lo, ty_hi;
    slab(t.box_length[e] / 2.0f, pax, rdx, &tx_lo, &tx_hi);
    slab(t.box_width[e] / 2.0f, pay, rdy, &ty_lo, &ty_hi);
    const float tmin = fmaxf(tx_lo, ty_lo), tmax = fminf(tx_hi, ty_hi);
    const float iax = tmin * rdx + pax, iay = tmin * rdy + pay;
    const float cb = cosf(br), sb = sinf(br);
    const float iwx = (iax * cb - iay * sb) + bx;
    const float iwy = (iax * sb + iay * cb) + by;
    const float dist = safe_norm2(ox - iwx, oy - iwy);
    dmin = fminf(dmin, (tmax >= tmin && tmin > 0.0f) ? dist : max_range);
  }

  // ---- lines: segment/ray crossing ---- //
  for (int e = 0; e < t.n_line; ++e) {
    const size_t i = pb + (size_t)t.line_idx[e];
    const float lx = pos[i * 2], ly = pos[i * 2 + 1], lr = rot[i];
    const float len = t.line_length[e];
    const float rx = cosf(lr) * len, ry = sinf(lr) * len;
    const float rxs = rx * dy - ry * dx;
    const bool parallel = rxs == 0.0f;
    const float safe = parallel ? 1.0f : rxs;
    const float qx = ox - lx, qy = oy - ly;
    const float tt = qx * (dy / safe) - qy * (dx / safe);
    const float u = qx * (ry / safe) - qy * (rx / safe);
    const float dist = safe_norm2(u * dx, u * dy);
    const bool miss = parallel || tt > 0.5f || tt < -0.5f || u < 0.0f;
    dmin = fminf(dmin, miss ? max_range : dist);
  }
  out[k] = dmin;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Every tensor pointer is a
// device pointer to a contiguous tensor the caller has checked; `t` is a
// host pointer to the cast table's CastTable.  `angles` is [R] base
// angles, to which the origin entity's rot is added (angle_stride 0), or
// [B, R] world-frame angles (angle_stride R).  The launch goes on `stream`
// (PyTorch's current stream).  Returns cudaGetLastError() after the launch,
// 0 on success; it does not synchronise.
extern "C" int vmt_cast_rays(const float* pos, const float* rot,
                             const float* angles, float* out,
                             const CastTable* t, int B, int N, int R,
                             int origin, int angle_stride, float max_range,
                             void* stream) {
  if (B <= 0 || R <= 0 || origin < 0 || origin >= N)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * R;
  const int blocks = (int)((n + VMT_THREADS - 1) / VMT_THREADS);
  cast_rays_kernel<<<blocks, VMT_THREADS, 0, (cudaStream_t)stream>>>(
      pos, rot, angles, out, *t, B, N, R, origin, angle_stride, max_range);
  return (int)cudaGetLastError();
}
