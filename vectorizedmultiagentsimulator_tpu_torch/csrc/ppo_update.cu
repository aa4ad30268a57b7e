// One PPO minibatch update as a CUDA kernel for sm_90a: actor-critic
// forward, clipped PPO loss and the hand-derived backward over the samples
// of one minibatch, returning the 11 parameter gradients and the three loss
// sums.
//
// Replaces the JAX package's Pallas kernel
// ops/ppo_update_pallas.py::_kernel (its _fwd_math and _bwd_math, the same
// casts and tie rules); ops/ppo_update_cuda.py holds the wrapper and the
// plain PyTorch version.
//
// What bounds it on the card: arithmetic.  A sample costs about
// 2*(4*OD*H + 3*H*H) flops of trunk products (bf16 operands, fp32 sums:
// the W1, Wv and W2 forward products and the dW1, dWv, dW2 and dh1
// backward ones; 32 kFLOP at OD=15, H=64) and a few thousand of fp32 heads
// and elementwise work, against D*4 = 88 bytes read; at the tensor cores'
// bf16 rate the trunk is still most of the bound.  The first design
// ran every product as fp32 FMAs on CUDA cores at about 17 % of the fp32
// rate, kept the weights as fp32 and the block's gradient sums in shared
// memory (which capped the hidden size near 150), loaded each tile
// synchronously and ran one block an SM.
//
// Design.  The TPU kernel walks a sequential grid and adds into revisited
// output blocks; here blocks run in parallel, so each block loops over its
// own tiles of T samples and keeps the gradient sums of its tiles, which a
// second small kernel adds over the blocks in block order.  No float
// atomics: the same inputs give the same bits.
// - The trunk products run on the tensor cores as mma.sync.m16n8k16 (bf16
//   operands, fp32 sums; the TPU kernel's contract).  Samples are the M
//   side of the forward products and hidden the N side; for the dW
//   products the tile's samples are the K side.  Each warp takes 16 x 32
//   (or 16 x 16) output tiles.  mma.sync and not wgmma: the tile's
//   activations are computed in the kernel in fp32 and rounded to bf16 as
//   they are read into registers, every operand is read both ways (samples
//   as M in the forward, as K in the dW products), and at hidden 256 the
//   weights and three fp32 activation tiles leave room for 16 samples a
//   tile, below wgmma's 64-row M; mma.sync takes a 16-row tile, any hidden
//   size padded to 16, and fragments that each thread builds from shared
//   memory in a layout the host build shares.
// - The trunk weights sit in shared memory as bf16, once a block, read by
//   ldmatrix (transposed for the forward products, as stored for dh1); rows
//   padded so that eight rows fall in distinct banks.  A trunk whose bf16
//   weights do not fit (from about hidden 260) is read from device memory
//   and rounded as it is read (PPO_WG=1).  The heads (Wm, Wv2) stay fp32
//   on CUDA cores.
// - Activations are fp32, sample-major ([sample][feature]), in shared
//   memory.  Per-sample fields of the head are feature-major.
// - Gradient sums stay in shared memory when they fit beside the tile
//   (PPO_GG=0); a wider trunk (from about hidden 150) keeps them in the
//   block's own row of the [grid, P] partial buffer in device memory
//   (PPO_GG=1), read, added and written by the one thread that owns each
//   entry.
// - A trunk whose three fp32 activation tiles overflow a block even at 16
//   samples (past about hidden 1,040 at obs_d 15) keeps them, and the
//   hidden-size vectors (Wm, Wv2 and the trunk's biases), in the block's
//   own slice of a scratch in device memory past the partial buffer
//   (PPO_XG=1, with PPO_GG=1 and PPO_WG=1), read and written through L2 as
//   the weights of PPO_WG=1 are.  Only the raw tiles and the head's rows
//   stay in shared memory.
// - Tile loads overlap compute: the next tile's columns are copied with
//   cp.async into the second of two raw buffers while the current tile
//   computes; the minibatch's shuffle is folded into the address (sample q
//   is column perm[q / lb] * lb + q % lb).
// - Two blocks an SM where the shared memory allows (the wrapper sizes the
//   grid).
// The head's shape is static and small, so the file is compiled once per
// (OD, AW, H, NL, T, GG, WG, XG) with -D flags; n, mb, lb and the loss
// coefficients are runtime fields of PPODims.
//
// The body is written as phases over the block's threads with a barrier
// after each, and nothing in a phase depends on another thread of the same
// phase; compiled as host C++ (no __CUDACC__) the same phases run as loops
// over the thread index, with each tensor-core product as a scalar loop
// that rounds its operands to bf16 and sums in fp32, which is how the CPU
// tests run this source.
#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#define DEV __device__ __forceinline__
#define PHASE_BEGIN { const int tid = threadIdx.x;
#define PHASE_END } __syncthreads();
#else
#include <cmath>
#include <vector>
#define DEV inline
#define PHASE_BEGIN for (int tid = 0; tid < NT; ++tid) {
#define PHASE_END }
#endif

#if !defined(PPO_OD) || !defined(PPO_AW) || !defined(PPO_H) || \
    !defined(PPO_NL) || !defined(PPO_T) || !defined(PPO_GG) || \
    !defined(PPO_WG) || !defined(PPO_XG)
#error "compile with -DPPO_OD= -DPPO_AW= -DPPO_H= -DPPO_NL= -DPPO_T= -DPPO_GG= -DPPO_WG= -DPPO_XG= (see ops/ppo_update_cuda.py)"
#endif

// Sizes and coefficients that are fixed for a trainer, filled once by the
// wrapper (ctypes mirror: ops/ppo_update_cuda.py::_PPODims).
struct PPODims {
    int n;            // columns of packed_fm
    int mb;           // samples of this minibatch
    int lb;           // samples per shuffle block
    float inv_norm;   // 1 / spec.norm
    float clip_lo;    // 1 - clip_eps
    float clip_hi;    // 1 + clip_eps
    float vf_scale;   // vf_coef / spec.norm
    float ent_scale;  // ent_coef / spec.norm
};

// The parameters, in the TPU kernel's order: W1 b1 W2 b2 Wm bm log_std Wv
// bv Wv2 bv2; weights [in, out] row-major (mirror: _PPOParams).
struct PPOParams {
    const float* p[11];
};

namespace {

constexpr int OD = PPO_OD;
constexpr int AW = PPO_AW;
constexpr int H = PPO_H;
constexpr int NL = PPO_NL;
constexpr bool DISCRETE = NL > 0;
constexpr int HW = DISCRETE ? AW * NL : AW;  // head (and mask) width
constexpr int D = OD + AW + 3 + HW;          // packed rows
constexpr int T = PPO_T;        // samples per tile
constexpr bool GG = PPO_GG != 0;  // gradient sums in device memory
constexpr bool WG = PPO_WG != 0;  // trunk weights read from device memory
// activation tiles and hidden-size vectors in device memory
constexpr bool XG = PPO_XG != 0;
static_assert(!XG || (GG && WG), "PPO_XG=1 needs PPO_GG=1 and PPO_WG=1");
constexpr int NT = 256;         // threads per block
constexpr int NWARPS = NT / 32;
static_assert(T == 64 || T == 32 || T == 16, "T is 64, 32 or 16");

constexpr int up4(int x) { return (x + 3) / 4 * 4; }
constexpr int up16(int x) { return (x + 15) / 16 * 16; }
constexpr int up32(int x) { return (x + 31) / 32 * 32; }

constexpr int HP = up16(H);      // hidden, padded to the mma's K step
constexpr int ODP = up16(OD);    // observation rows, padded likewise
// Row strides: 8 more than a multiple of 16 elements.  The eight 16-byte
// rows of an ldmatrix of the bf16 weights then fall in distinct banks, and
// so do a half-warp's float2 fragment loads from an fp32 tile (8 or 24
// words mod 32).  Raw tiles are [rows][RS] (feature-major; rows past D up
// to ODP stay 0), activation tiles [T][XS] (sample-major), the head's own
// rows [rows][TS].
constexpr int WS = HP + 8;
constexpr int XS = HP + 8;
constexpr int RS = T + 8;
constexpr int TS = T + 4;
constexpr int RAW_ROWS = D > ODP ? D : ODP;

constexpr float LOG_2PI = 1.8378770664093453f;
constexpr float ENT_C = 1.4189385332046727f;  // 0.5 * log(2 pi) + 0.5

// Offsets of each gradient in the flat output [P], the parameters' order,
// then (pg_sum, vf_sum, ent_sum).
constexpr int G_W1 = 0;
constexpr int G_B1 = G_W1 + OD * H;
constexpr int G_W2 = G_B1 + H;
constexpr int G_B2 = G_W2 + H * H;
constexpr int G_WM = G_B2 + H;
constexpr int G_BM = G_WM + H * HW;
constexpr int G_LS = G_BM + HW;
constexpr int G_WV = G_LS + HW;
constexpr int G_BV = G_WV + OD * H;
constexpr int G_WV2 = G_BV + H;
constexpr int G_BV2 = G_WV2 + H;
constexpr int G_SUMS = G_BV2 + 1;
constexpr int P = G_SUMS + 3;
constexpr int P4 = up4(P);  // P padded to 16 bytes

// Two regions whose size grows with the hidden size, as offsets in floats
// from their own base: the hidden-size vectors V and the activation tiles X.
// They sit in shared memory unless PPO_XG=1, and then in the block's slice
// of the scratch in device memory, in the same order.
constexpr int V_WM = 0;                   // [H][HW]
constexpr int V_WV2 = V_WM + up4(H * HW);  // [HP], 0 past H
constexpr int V_B1 = V_WV2 + HP;
constexpr int V_B2 = V_B1 + HP;
constexpr int V_BV = V_B2 + HP;
constexpr int NV = V_BV + HP;
constexpr int X1 = 0;                     // [T][XS]: h1, then dz1
constexpr int X2 = X1 + T * XS;           // h2, then dz2
constexpr int XV = X2 + T * XS;           // hv, then dzv
constexpr int NX = XV + T * XS;
// A block's slice of the scratch (floats, a multiple of 4); 0 unless XG.
constexpr int SCRATCH = XG ? NV + NX : 0;

// Shared memory.  First the trunk weights as bf16 bits [rows][WS]: W1 and
// Wv (ODP rows), W2 (HP rows); then fp32 regions, in floats, each on 16
// bytes.
constexpr int WB_W1 = 0;
constexpr int WB_WV = WB_W1 + ODP * WS;
constexpr int WB_W2 = WB_WV + ODP * WS;
constexpr int WB_END = WG ? 0 : WB_W2 + HP * WS;  // bf16 elements (a multiple of 8)
constexpr int S_V = WB_END / 2;           // V unless XG
constexpr int S_BM = S_V + (XG ? 0 : NV);
constexpr int S_LS = S_BM + up4(HW);
constexpr int S_BV2 = S_LS + up4(HW);
constexpr int S_G = S_BV2 + 4;            // gradient sums (PPO_GG=0)
constexpr int S_RAW = S_G + (GG ? 0 : P4);  // two raw tiles [RAW_ROWS][RS]
constexpr int RAW = RAW_ROWS * RS;
constexpr int S_X = S_RAW + 2 * RAW;      // X unless XG
constexpr int S_MEAN = S_X + (XG ? 0 : NX);  // [HW][TS] mean or logits, then their gradient
constexpr int S_VAL = S_MEAN + HW * TS;   // value, then its gradient
constexpr int S_PG = S_VAL + TS;
constexpr int S_VF = S_PG + TS;
constexpr int S_ENT = S_VF + TS;
constexpr int S_DLS = S_ENT + TS;         // per-sample log_std gradient terms
constexpr int S_TOTAL = S_DLS + (DISCRETE ? 0 : AW * TS);
constexpr int SMEM_BYTES = S_TOTAL * 4;
static_assert(SMEM_BYTES <= 232448, "tile does not fit a block's shared memory");

// x rounded to bfloat16 (nearest even) and back.
DEV float bf16r(float x) {
#ifdef __CUDA_ARCH__
    return __bfloat162float(__float2bfloat16_rn(x));
#else
    uint32_t u;
    memcpy(&u, &x, 4);
    if ((u & 0x7fffffffu) > 0x7f800000u) return x;
    u += 0x7fffu + ((u >> 16) & 1u);
    u &= 0xffff0000u;
    memcpy(&x, &u, 4);
    return x;
#endif
}

// bf16 bits of x (nearest even), and back.
DEV uint16_t bf16_bits(float x) {
    const float r = bf16r(x);
    uint32_t u;
    memcpy(&u, &r, 4);
    return (uint16_t)(u >> 16);
}

DEV float bf16_value(uint16_t b) {
    const uint32_t u = (uint32_t)b << 16;
    float x;
    memcpy(&x, &u, 4);
    return x;
}

// ---- The trunk products ---- //
//
// OUT(m, n) = epi(sum_k A(m, k) B(k, n)) for m < M, n < N (multiples of 16),
// over K (a multiple of 16), with both operands rounded to bf16 and the sum
// in fp32.  The operands:
//   ARows{X, ld}:  A(m, k) = X[m * ld + k]  (fp32; a forward product's
//                  samples by features)
//   ACols{X, ld}:  A(m, k) = X[k * ld + m]  (fp32; a dW product's features
//                  by samples)
//   BCols{Y, ld}:  B(k, n) = Y[k * ld + n]  (fp32; a dW product's samples
//                  by features)
//   BW{W}:         B(k, n) = W[k * WS + n]  (bf16 weights [in][out])
//   BWT{W}:        B(k, n) = W[n * WS + k]  (bf16 weights, transposed)
struct ARows { const float* x; int ld; };
struct ACols { const float* x; int ld; };
struct BCols { const float* y; int ld; };
struct BW { const uint16_t* w; };
struct BWT { const uint16_t* w; };
// The weights as the caller gave them (fp32 in device memory, [rows][cols]
// row-major), rounded to bf16 as they are read, 0 past their edge: BWG as
// BW, BWGT as BWT (PPO_WG=1, a trunk whose bf16 weights overflow shared
// memory).
struct BWG { const float* w; int rows, cols; };
struct BWGT { const float* w; int rows, cols; };

DEV float at(const ARows& a, int m, int k) { return a.x[m * a.ld + k]; }
DEV float at(const ACols& a, int m, int k) { return a.x[k * a.ld + m]; }
DEV float at(const BCols& b, int k, int n) { return b.y[k * b.ld + n]; }
DEV float at(const BW& b, int k, int n) { return bf16_value(b.w[k * WS + n]); }
DEV float at(const BWT& b, int k, int n) { return bf16_value(b.w[n * WS + k]); }
DEV float at(const BWG& b, int k, int n) {
    return k < b.rows && n < b.cols ? b.w[k * b.cols + n] : 0.f;
}
DEV float at(const BWGT& b, int k, int n) {
    return n < b.rows && k < b.cols ? b.w[n * b.cols + k] : 0.f;
}

#ifdef __CUDA_ARCH__
// Fragments of mma.m16n8k16 (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"): with g = lane / 4 and t = lane % 4, A's registers hold
// (row g, k 2t..2t+1), (row g+8, k 2t..), (row g, k 2t+8..), (row g+8,
// k 2t+8..); B's (k 2t..2t+1, col g), (k 2t+8.., col g); the sums (row g,
// cols 2t, 2t+1), (row g+8, cols 2t, 2t+1).  The lower k sits in the lower
// half of a register.
DEV uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

DEV void frag_a(const ARows& a, int m0, int k0, int lane, uint32_t r[4]) {
    const int g = lane >> 2, t = lane & 3;
    const float* p = a.x + (m0 + g) * a.ld + k0 + 2 * t;
    const float2 v0 = *reinterpret_cast<const float2*>(p);
    const float2 v1 = *reinterpret_cast<const float2*>(p + 8 * a.ld);
    const float2 v2 = *reinterpret_cast<const float2*>(p + 8);
    const float2 v3 = *reinterpret_cast<const float2*>(p + 8 * a.ld + 8);
    r[0] = pack(v0.x, v0.y);
    r[1] = pack(v1.x, v1.y);
    r[2] = pack(v2.x, v2.y);
    r[3] = pack(v3.x, v3.y);
}

DEV void frag_a(const ACols& a, int m0, int k0, int lane, uint32_t r[4]) {
    const int g = lane >> 2, t = lane & 3;
    const float* p = a.x + (k0 + 2 * t) * a.ld + m0 + g;
    r[0] = pack(p[0], p[a.ld]);
    r[1] = pack(p[8], p[a.ld + 8]);
    r[2] = pack(p[8 * a.ld], p[9 * a.ld]);
    r[3] = pack(p[8 * a.ld + 8], p[9 * a.ld + 8]);
}

DEV void ldsm_x4(const uint16_t* p, uint32_t r[4]) {
    const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

DEV void ldsm_x4_trans(const uint16_t* p, uint32_t r[4]) {
    const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// B fragments of the NB n-blocks of 8 from n0.
template <int NB>
DEV void frag_b(const BCols& b, int k0, int n0, int lane, uint32_t r[NB][2]) {
    const int g = lane >> 2, t = lane & 3;
    const float* p = b.y + (k0 + 2 * t) * b.ld + n0 + g;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
        r[j][0] = pack(p[8 * j], p[b.ld + 8 * j]);
        r[j][1] = pack(p[8 * b.ld + 8 * j], p[9 * b.ld + 8 * j]);
    }
}

// W stored [k][n]: each 8 x 8 block transposed on the way in.  Lanes
// 8q..8q+7 address matrix q = (k half q & 1, n half q >> 1).
template <int NB>
DEV void frag_b(const BW& b, int k0, int n0, int lane, uint32_t r[NB][2]) {
    const int row = k0 + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int j = 0; j < NB; j += 2) {
        uint32_t q[4];
        ldsm_x4_trans(b.w + row * WS + n0 + 8 * j + 8 * (lane >> 4), q);
        r[j][0] = q[0]; r[j][1] = q[1]; r[j + 1][0] = q[2]; r[j + 1][1] = q[3];
    }
}

// W stored [n][k]: rows are n, read as they are.  Matrix q = (k half q & 1,
// n half q >> 1).
template <int NB>
DEV void frag_b(const BWT& b, int k0, int n0, int lane, uint32_t r[NB][2]) {
    const int col = k0 + 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int j = 0; j < NB; j += 2) {
        uint32_t q[4];
        ldsm_x4(b.w + (n0 + 8 * j + (lane & 7) + 8 * (lane >> 4)) * WS + col, q);
        r[j][0] = q[0]; r[j][1] = q[1]; r[j + 1][0] = q[2]; r[j + 1][1] = q[3];
    }
}

DEV float ldg_at(const float* w, int r, int c, int rows, int cols) {
    return r < rows && c < cols ? __ldg(w + r * cols + c) : 0.f;
}

template <int NB>
DEV void frag_b(const BWG& b, int k0, int n0, int lane, uint32_t r[NB][2]) {
    const int g = lane >> 2, k = k0 + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
        const int n = n0 + 8 * j + g;
        r[j][0] = pack(ldg_at(b.w, k, n, b.rows, b.cols),
                       ldg_at(b.w, k + 1, n, b.rows, b.cols));
        r[j][1] = pack(ldg_at(b.w, k + 8, n, b.rows, b.cols),
                       ldg_at(b.w, k + 9, n, b.rows, b.cols));
    }
}

template <int NB>
DEV void frag_b(const BWGT& b, int k0, int n0, int lane, uint32_t r[NB][2]) {
    const int g = lane >> 2, k = k0 + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
        const int n = n0 + 8 * j + g;
        r[j][0] = pack(ldg_at(b.w, n, k, b.rows, b.cols),
                       ldg_at(b.w, n, k + 1, b.rows, b.cols));
        r[j][1] = pack(ldg_at(b.w, n, k + 8, b.rows, b.cols),
                       ldg_at(b.w, n, k + 9, b.rows, b.cols));
    }
}

DEV void mma(float c[4], const uint32_t a[4], const uint32_t b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
#endif

// Called by every thread of the block; warp w takes the output tiles w,
// w + NWARPS, ... of 16 rows by WN columns, and each output goes to epi
// once, from the thread that holds it.
template <int M, int N, int K, class A, class B, class Epi>
DEV void tc_product(int tid, const A& a, const B& b, Epi epi) {
    static_assert(M % 16 == 0 && N % 16 == 0 && K % 16 == 0, "pad to 16");
#ifdef __CUDA_ARCH__
    // 16 x 32 tiles, or 16 x 16 where that leaves warps idle.
    constexpr int WN = N % 32 == 0 && (M / 16) * (N / 32) >= NWARPS ? 32 : 16;
    constexpr int NB = WN / 8;
    constexpr int TN = N / WN;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    for (int wt = warp; wt < (M / 16) * TN; wt += NWARPS) {
        const int m0 = (wt / TN) * 16, n0 = (wt % TN) * WN;
        float acc[NB][4];
#pragma unroll
        for (int j = 0; j < NB; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll 2
        for (int k0 = 0; k0 < K; k0 += 16) {
            uint32_t af[4], bf[NB][2];
            frag_a(a, m0, k0, lane, af);
            frag_b<NB>(b, k0, n0, lane, bf);
#pragma unroll
            for (int j = 0; j < NB; ++j) mma(acc[j], af, bf[j]);
        }
#pragma unroll
        for (int j = 0; j < NB; ++j) {
            const int n = n0 + 8 * j + 2 * t;
            epi(m0 + g, n, acc[j][0]);
            epi(m0 + g, n + 1, acc[j][1]);
            epi(m0 + g + 8, n, acc[j][2]);
            epi(m0 + g + 8, n + 1, acc[j][3]);
        }
    }
#else
    for (int o = tid; o < M * N; o += NT) {
        const int m = o / N, n = o % N;
        float acc = 0.f;
        for (int k = 0; k < K; ++k) acc += bf16r(at(a, m, k)) * bf16r(at(b, k, n));
        epi(m, n, acc);
    }
#endif
}

// ---- Tile loads ---- //
// A 4-byte copy from device to shared memory that completes at the next
// wait; an invalid source fills 0.  On the host, a plain copy.
DEV void copy_async(float* dst, const float* src, bool valid) {
#ifdef __CUDA_ARCH__
    const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid ? 4 : 0));
#else
    *dst = valid ? *src : 0.f;
#endif
}

DEV void copy_commit() {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// Wait until every copy but those of the last committed group has landed.
DEV void copy_wait_but_last() {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.wait_group 1;\n" ::);
#endif
}

// Start the copy of tile `tile`'s D x T raw columns into `raw`: sample q
// of the minibatch is column perm[q / lb] * lb + q % lb; past the
// minibatch's end, zeros.
DEV void issue_tile(int tid, int tile, float* raw,
                    const float* __restrict__ packed,
                    const int* __restrict__ perm, const PPODims& dm) {
    for (int i = tid; i < D * T; i += NT) {
        const int row = i / T, s = i - row * T;
        const int q = tile * T + s;
        const bool valid = q < dm.mb;
        long col = 0;
        if (valid) col = (long)perm[q / dm.lb] * dm.lb + q % dm.lb;
        copy_async(raw + row * RS + s,
                   packed + (valid ? (long)row * dm.n + col : 0), valid);
    }
}

// out(j, sum over k < K of term(k, j)) for j < J: one thread a j, k in
// order.  (Four threads a j, added through warp shuffles, measured slower
// on the H100.)
template <class Term, class Out>
DEV void thread_sums(int tid, int J, int K, Term term, Out out) {
    for (int j = tid; j < J; j += NT) {
        float v = 0.f;
        for (int k = 0; k < K; ++k) v += term(k, j);
        out(j, v);
    }
}

// G[r] += sum_s X[r][s] for r < R (feature-major rows).
DEV void row_sums(int tid, int R, const float* X, float* G) {
    thread_sums(tid, R, T, [&](int s, int r) { return X[r * TS + s]; },
               [&](int r, float v) { G[r] += v; });
}

// G[j] += sum_s X[s][j] for j < H (sample-major).
DEV void col_sums(int tid, const float* X, float* G) {
    thread_sums(tid, H, T, [&](int s, int j) { return X[s * XS + j]; },
               [&](int j, float v) { G[j] += v; });
}

// The loss head for sample s of the tile: from mean (or logits), value and
// the packed fields of the raw tile to the per-sample loss terms and the
// gradients of mean and value, written in place.  A sample past the
// minibatch's end contributes zeros.
DEV void head(int s, bool valid, float* sm, const float* raw,
              const float* __restrict__ stats, const PPODims& dm) {
    const float* act = raw + OD * RS;
    const float* mask = raw + (OD + AW + 3) * RS;
    float logp = 0.f, ent = 0.f;
    if constexpr (DISCRETE) {
        for (int k = 0; k < AW; ++k) {
            const int a_idx = (int)act[k * RS + s];
            float lg[NL > 0 ? NL : 1];
            float mx = -3.0e38f;
#pragma unroll
            for (int j = 0; j < NL; ++j) {
                lg[j] = sm[S_MEAN + (k * NL + j) * TS + s]
                        + mask[(k * NL + j) * RS + s];
                mx = fmaxf(mx, lg[j]);
            }
            float z = 0.f;
#pragma unroll
            for (int j = 0; j < NL; ++j) z += expf(lg[j] - mx);
            const float lz = logf(z) + mx;
            float ent_k = 0.f;
#pragma unroll
            for (int j = 0; j < NL; ++j) {
                const float la = lg[j] - lz;
                const float pr = expf(lg[j] - mx) / z;
                logp += j == a_idx ? la : 0.f;
                ent_k += pr * la;
            }
            ent += -ent_k;
        }
    } else {
#pragma unroll
        for (int a = 0; a < AW; ++a) {
            const float ls = sm[S_LS + a];
            const float var = expf(2.0f * ls);
            const float diff = act[a * RS + s] - sm[S_MEAN + a * TS + s];
            const float m = mask[a * RS + s];
            const float contrib = -0.5f * diff * diff / var - ls - 0.5f * LOG_2PI;
            logp += m * contrib;
            ent += m * (ls + ENT_C);
        }
    }
    const float adv =
        valid ? (raw[(OD + AW + 1) * RS + s] - stats[0]) * stats[1] : 0.f;
    const float ratio = expf(logp - raw[(OD + AW) * RS + s]);
    const float rclip = fminf(fmaxf(ratio, dm.clip_lo), dm.clip_hi);
    const float t1 = ratio * adv, t2 = rclip * adv;
    const float verr = sm[S_VAL + s] - raw[(OD + AW + 2) * RS + s];
    // min's subgradient goes to t1 on a tie; the clip passes the closed
    // interval, as jax.grad has it.
    const float sel = t1 <= t2 ? 1.f : 0.f;
    const float inside = (ratio >= dm.clip_lo && ratio <= dm.clip_hi) ? 1.f : 0.f;
    const float dratio = -dm.inv_norm * adv * (sel + (1.f - sel) * inside);
    const float dlogp = valid ? dratio * ratio : 0.f;

    sm[S_PG + s] = valid ? fminf(t1, t2) : 0.f;
    sm[S_VF + s] = valid ? 0.5f * verr * verr : 0.f;
    sm[S_ENT + s] = valid ? ent : 0.f;
    sm[S_VAL + s] = valid ? dm.vf_scale * verr : 0.f;

    if constexpr (DISCRETE) {
        for (int k = 0; k < AW; ++k) {
            const int a_idx = (int)act[k * RS + s];
            float lg[NL > 0 ? NL : 1];
            float mx = -3.0e38f;
#pragma unroll
            for (int j = 0; j < NL; ++j) {
                lg[j] = sm[S_MEAN + (k * NL + j) * TS + s]
                        + mask[(k * NL + j) * RS + s];
                mx = fmaxf(mx, lg[j]);
            }
            float z = 0.f;
#pragma unroll
            for (int j = 0; j < NL; ++j) z += expf(lg[j] - mx);
            const float lz = logf(z) + mx;
            float ent_k = 0.f;
#pragma unroll
            for (int j = 0; j < NL; ++j)
                ent_k += expf(lg[j] - mx) / z * (lg[j] - lz);
            ent_k = -ent_k;
            // d logp / d logits = onehot - p; the entropy term uses this
            // dim's own entropy.
#pragma unroll
            for (int j = 0; j < NL; ++j) {
                const float la = lg[j] - lz;
                const float pr = expf(lg[j] - mx) / z;
                const float g = dlogp * ((j == a_idx ? 1.f : 0.f) - pr)
                                + dm.ent_scale * pr * (la + ent_k);
                sm[S_MEAN + (k * NL + j) * TS + s] = valid ? g : 0.f;
            }
        }
    } else {
#pragma unroll
        for (int a = 0; a < AW; ++a) {
            const float ls = sm[S_LS + a];
            const float var = expf(2.0f * ls);
            const float diff = act[a * RS + s] - sm[S_MEAN + a * TS + s];
            const float m = mask[a * RS + s];
            sm[S_MEAN + a * TS + s] = dlogp * m * diff / var;
            sm[S_DLS + a * TS + s] =
                valid ? dlogp * m * (diff * diff / var - 1.0f) - dm.ent_scale * m
                      : 0.f;
        }
    }
}

// Everything one block does: its tiles block_id, block_id + grid, ...
DEV void block_body(int block_id, int grid, float* sm,
                    const float* __restrict__ packed,
                    const int* __restrict__ perm,
                    const float* __restrict__ stats, const PPOParams& pr,
                    float* __restrict__ partial, const PPODims& dm) {
    uint16_t* wb = reinterpret_cast<uint16_t*>(sm);
    float* G = GG ? partial + (long)block_id * P : sm + S_G;
    // The V and X regions: in shared memory, or (XG) in this block's slice
    // of the scratch, which starts past the partial buffer on 16 bytes.
    float* const vs = XG ? partial + ((long)grid * P + 3) / 4 * 4
                               + (long)block_id * SCRATCH
                         : sm + S_V;
    float* const xs = XG ? vs + NV : sm + S_X;
    // The trunk weights as the products read them.
    const auto w1 = [&] {
        if constexpr (WG) return BWG{pr.p[0], OD, H};
        else return BW{wb + WB_W1};
    }();
    const auto wv = [&] {
        if constexpr (WG) return BWG{pr.p[7], OD, H};
        else return BW{wb + WB_WV};
    }();
    const auto w2 = [&] {
        if constexpr (WG) return BWG{pr.p[2], H, H};
        else return BW{wb + WB_W2};
    }();
    const auto w2t = [&] {
        if constexpr (WG) return BWGT{pr.p[2], H, H};
        else return BWT{wb + WB_W2};
    }();
    const int n_tiles = (dm.mb + T - 1) / T;

    // The weights, once a block: the trunk's as bf16 [in][out] rows padded
    // with zeros to (ODP or HP) x WS, the heads' as fp32; zero sums; the
    // first tile's copy.
    PHASE_BEGIN
        for (int i = tid; i < (WG ? 0 : ODP * WS); i += NT) {
            const int k = i / WS, j = i - k * WS;
            const bool in = k < OD && j < H;
            wb[WB_W1 + i] = bf16_bits(in ? pr.p[0][k * H + j] : 0.f);
            wb[WB_WV + i] = bf16_bits(in ? pr.p[7][k * H + j] : 0.f);
        }
        for (int i = tid; i < (WG ? 0 : HP * WS); i += NT) {
            const int k = i / WS, j = i - k * WS;
            wb[WB_W2 + i] = bf16_bits(k < H && j < H ? pr.p[2][k * H + j] : 0.f);
        }
        for (int i = tid; i < H * HW; i += NT) vs[V_WM + i] = pr.p[4][i];
        for (int i = tid; i < HP; i += NT) {
            const bool in = i < H;
            vs[V_B1 + i] = in ? pr.p[1][i] : 0.f;
            vs[V_B2 + i] = in ? pr.p[3][i] : 0.f;
            vs[V_BV + i] = in ? pr.p[8][i] : 0.f;
            vs[V_WV2 + i] = in ? pr.p[9][i] : 0.f;
        }
        for (int i = tid; i < HW; i += NT) {
            sm[S_BM + i] = pr.p[5][i];
            sm[S_LS + i] = pr.p[6][i];
        }
        if (tid == 0) sm[S_BV2] = pr.p[10][0];
        for (int i = tid; i < P; i += NT) G[i] = 0.f;
        // Raw rows past D (obs_d padded to ODP) are never copied: 0.
        for (int i = tid; i < (RAW_ROWS - D) * RS; i += NT) {
            sm[S_RAW + D * RS + i] = 0.f;
            sm[S_RAW + RAW + D * RS + i] = 0.f;
        }
        if (block_id < n_tiles)
            issue_tile(tid, block_id, sm + S_RAW, packed, perm, dm);
        copy_commit();
    PHASE_END

    int it = 0;
    for (int tile = block_id; tile < n_tiles; tile += grid, ++it) {
        const float* raw = sm + S_RAW + (it & 1) * RAW;
        // The next tile's copy starts; this tile's has landed.
        PHASE_BEGIN
            if (tile + grid < n_tiles)
                issue_tile(tid, tile + grid, sm + S_RAW + ((it + 1) & 1) * RAW,
                           packed, perm, dm);
            copy_commit();
            copy_wait_but_last();
        PHASE_END

        // h1 = tanh(obs_b W1b + b1), hv = tanh(obs_b Wvb + bv)
        PHASE_BEGIN
            tc_product<T, HP, ODP>(
                tid, ACols{raw, RS}, w1,
                [&](int s, int j, float acc) {
                    xs[X1 + s * XS + j] = tanhf(acc + vs[V_B1 + j]);
                });
            tc_product<T, HP, ODP>(
                tid, ACols{raw, RS}, wv,
                [&](int s, int j, float acc) {
                    xs[XV + s * XS + j] = tanhf(acc + vs[V_BV + j]);
                });
        PHASE_END

        // h2 = tanh(h1_b W2b + b2); value = hv Wv2 + bv2
        PHASE_BEGIN
            tc_product<T, HP, HP>(
                tid, ARows{xs + X1, XS}, w2,
                [&](int s, int j, float acc) {
                    xs[X2 + s * XS + j] = tanhf(acc + vs[V_B2 + j]);
                });
        PHASE_END

        // mean (or logits) = h2 Wm + bm; value = hv Wv2 + bv2
        PHASE_BEGIN
            thread_sums(
                tid, HW * T, H,
                [&](int j, int i) {
                    return vs[V_WM + j * HW + i / T] * xs[X2 + (i % T) * XS + j];
                },
                [&](int i, float v) {
                    sm[S_MEAN + (i / T) * TS + i % T] = v + sm[S_BM + i / T];
                });
            thread_sums(
                tid, T, H,
                [&](int j, int s) { return vs[V_WV2 + j] * xs[XV + s * XS + j]; },
                [&](int s, float v) { sm[S_VAL + s] = v + sm[S_BV2]; });
        PHASE_END

        PHASE_BEGIN
            if (tid < T) head(tid, tile * T + tid < dm.mb, sm, raw, stats, dm);
        PHASE_END

        // Sums that need h2 and hv before they are overwritten.
        PHASE_BEGIN
            thread_sums(
                tid, H * HW, T,
                [&](int s, int i) {
                    return xs[X2 + s * XS + i / HW] * sm[S_MEAN + (i % HW) * TS + s];
                },
                [&](int i, float v) { G[G_WM + i] += v; });
            thread_sums(
                tid, H, T,
                [&](int s, int j) { return xs[XV + s * XS + j] * sm[S_VAL + s]; },
                [&](int j, float v) { G[G_WV2 + j] += v; });
            row_sums(tid, HW, sm + S_MEAN, G + G_BM);
            row_sums(tid, 1, sm + S_VAL, G + G_BV2);
            row_sums(tid, 3, sm + S_PG, G + G_SUMS);
            if (!DISCRETE) row_sums(tid, AW, sm + S_DLS, G + G_LS);
        PHASE_END

        // dz2 = (dmean Wm') (1 - h2^2) over h2; dzv = dvalue Wv2' (1 - hv^2)
        // over hv; 0 past H.
        PHASE_BEGIN
            for (int i = tid; i < T * HP; i += NT) {
                const int s = i / HP, j = i - s * HP;
                float dz2 = 0.f, dzv = 0.f;
                if (j < H) {
                    float acc = 0.f;
                    for (int a = 0; a < HW; ++a)
                        acc += vs[V_WM + j * HW + a] * sm[S_MEAN + a * TS + s];
                    const float h = xs[X2 + s * XS + j];
                    dz2 = acc * (1.0f - h * h);
                    const float hv = xs[XV + s * XS + j];
                    dzv = vs[V_WV2 + j] * sm[S_VAL + s] * (1.0f - hv * hv);
                }
                xs[X2 + s * XS + j] = dz2;
                xs[XV + s * XS + j] = dzv;
            }
        PHASE_END

        // db2, dbv; dW2 += h1_b' dz2_b
        PHASE_BEGIN
            col_sums(tid, xs + X2, G + G_B2);
            col_sums(tid, xs + XV, G + G_BV);
            tc_product<HP, HP, T>(
                tid, ACols{xs + X1, XS}, BCols{xs + X2, XS},
                [&](int j, int i, float acc) {
                    if (j < H && i < H) G[G_W2 + j * H + i] += acc;
                });
        PHASE_END

        // dz1 = (dz2_b W2b') (1 - h1^2) over h1
        PHASE_BEGIN
            tc_product<T, HP, HP>(
                tid, ARows{xs + X2, XS}, w2t,
                [&](int s, int j, float acc) {
                    const float h = xs[X1 + s * XS + j];
                    xs[X1 + s * XS + j] = acc * (1.0f - h * h);
                });
        PHASE_END

        // db1; dW1 += obs_b' dz1_b; dWv += obs_b' dzv_b
        PHASE_BEGIN
            col_sums(tid, xs + X1, G + G_B1);
            tc_product<ODP, HP, T>(
                tid, ARows{raw, RS}, BCols{xs + X1, XS},
                [&](int k, int j, float acc) {
                    if (k < OD && j < H) G[G_W1 + k * H + j] += acc;
                });
            tc_product<ODP, HP, T>(
                tid, ARows{raw, RS}, BCols{xs + XV, XS},
                [&](int k, int j, float acc) {
                    if (k < OD && j < H) G[G_WV + k * H + j] += acc;
                });
        PHASE_END
    }

    if (!GG) {
        PHASE_BEGIN
            for (int i = tid; i < P; i += NT)
                partial[(long)block_id * P + i] = sm[S_G + i];
        PHASE_END
    }
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(NT, 2)
ppo_update_kernel(const float* __restrict__ packed, const int* __restrict__ perm,
                  const float* __restrict__ stats, const PPOParams pr,
                  float* __restrict__ partial, const PPODims dm) {
    extern __shared__ float4 smem4[];
    block_body(blockIdx.x, gridDim.x, reinterpret_cast<float*>(smem4), packed,
               perm, stats, pr, partial, dm);
}

// out[p] = sum over blocks in a fixed order: 8 threads each add one run
// of the rows in block order, then the 8 runs are added in order.  A block
// of 256 threads takes 32 entries.
constexpr int RED_RUNS = 8;
__global__ void ppo_reduce_kernel(const float* __restrict__ partial, int grid,
                                  float* __restrict__ out) {
    __shared__ float runs[RED_RUNS][32];
    const int c = threadIdx.x / 32, p = blockIdx.x * 32 + threadIdx.x % 32;
    const int per = (grid + RED_RUNS - 1) / RED_RUNS;
    float sum = 0.f;
    if (p < P)
        for (int g = c * per; g < grid && g < (c + 1) * per; ++g)
            sum += partial[(long)g * P + p];
    runs[c][threadIdx.x % 32] = sum;
    __syncthreads();
    if (c == 0 && p < P) {
        float total = runs[0][threadIdx.x];
        for (int r = 1; r < RED_RUNS; ++r) total += runs[r][threadIdx.x];
        out[p] = total;
    }
}
#endif

}  // namespace

// The length of the flat gradient vector, and the shared memory of a block,
// for the wrapper to hold against its own arithmetic.
extern "C" int vmt_ppo_p() { return P; }
extern "C" int vmt_ppo_smem_bytes() { return SMEM_BYTES; }
extern "C" int vmt_ppo_scratch_floats() { return SCRATCH; }

#ifdef __CUDACC__
// One minibatch: `grid` blocks write their sums to partial [grid, P], then
// out [P] gets their sum.  With PPO_XG=1 the buffer holds, from float
// up4(grid * P) on, grid slices of vmt_ppo_scratch_floats() more.
// Returns the CUDA error of the launches (0: none).
extern "C" int vmt_ppo_update(const float* packed, const int* perm,
                              const float* stats, const PPOParams* params,
                              float* partial, float* out, const PPODims* dims,
                              int grid, void* stream) {
    static bool configured = false;
    if (!configured) {
        cudaError_t err = cudaFuncSetAttribute(
            ppo_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            SMEM_BYTES);
        if (err != cudaSuccess) return (int)err;
        configured = true;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    ppo_update_kernel<<<grid, NT, SMEM_BYTES, s>>>(packed, perm, stats, *params,
                                                   partial, *dims);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ppo_reduce_kernel<<<(P + 31) / 32, 32 * RED_RUNS, 0, s>>>(partial, grid,
                                                              out);
    return (int)cudaGetLastError();
}
#else
// The same phases on the host, one block after the other.
extern "C" int vmt_ppo_update(const float* packed, const int* perm,
                              const float* stats, const PPOParams* params,
                              float* partial, float* out, const PPODims* dims,
                              int grid, void*) {
    std::vector<float> sm(S_TOTAL);
    for (int b = 0; b < grid; ++b)
        block_body(b, grid, sm.data(), packed, perm, stats, *params, partial,
                   *dims);
    for (int p = 0; p < P; ++p) {
        float sum = 0.f;
        for (int g = 0; g < grid; ++g) sum += partial[(long)g * P + p];
        out[p] = sum;
    }
    return 0;
}
#endif
