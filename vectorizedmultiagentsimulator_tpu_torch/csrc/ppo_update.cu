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
//   as M in the forward, as K in the dW products), and in the one-block
//   layouts the weights and three fp32 activation tiles leave room for 16
//   to 64 samples a tile; mma.sync takes a 16-row tile, any hidden size
//   padded to 16, and fragments that each thread builds from shared
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
//   (PPO_GG=0, up to about hidden 150).
// - From there to hidden 256 (PPO_CL=4) a cluster of 4 blocks shares each
//   tile, block r owning hidden units [r HS, (r+1) HS): its columns of W1,
//   Wv and W2, its rows of W2 (for dh1) and its slices of every activation
//   and gradient sum.  Every block computes its slice of h1 and hands it,
//   as the bf16 the next product rounds it to, to the other blocks' shared
//   memory (DSMEM); likewise dz2.  The mean and value are sums over the
//   slices, exchanged and added in rank order, and every block runs the
//   loss head on the same numbers; rank 0 keeps the head's own sums.  A
//   block's dW2 columns and its threads' running sums of dWm, dWv2 and the
//   trunk's biases stay in registers for the whole launch, dW1 and dWv in
//   its shared memory; each block writes its share of the cluster's row
//   of the partial buffer once, at the end.  Three cluster barriers a
//   tile, two split into arrive and wait around local work.
// - Past hidden 256 the block's gradient sums live in its own row of the
//   [grid, P] partial buffer in device memory (PPO_GG=1, with PPO_WG=1),
//   read, added and written by the one thread that owns each entry.
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
//   grid); a cluster's blocks take one SM each, and the grid is as many
//   clusters as the card holds at once.
// The head's shape is static and small, so the file is compiled once per
// (OD, AW, H, NL, T, GG, WG, XG, CL) with -D flags; n, mb, lb and the loss
// coefficients are runtime fields of PPODims.
//
// The body is written as phases over the block's threads with a barrier
// after each, and nothing in a phase depends on another thread of the same
// phase; compiled as host C++ (no __CUDACC__) the same phases run as loops
// over the thread index (and, in the cluster layout, over the cluster's
// blocks, whose shared memory the DSMEM stores then write), with each
// tensor-core product as a scalar loop that rounds its operands to bf16 and
// sums in fp32, which is how the CPU tests run this source.
#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#define DEV __device__ __forceinline__
#define PHASE_BEGIN { const int tid = threadIdx.x;
#define PHASE_END } __syncthreads();
#else
#include <algorithm>
#include <cmath>
#include <vector>
#define DEV inline
#define PHASE_BEGIN for (int tid = 0; tid < NT; ++tid) {
#define PHASE_END }
#endif

#if !defined(PPO_OD) || !defined(PPO_AW) || !defined(PPO_H) || \
    !defined(PPO_NL) || !defined(PPO_T) || !defined(PPO_GG) || \
    !defined(PPO_WG) || !defined(PPO_XG) || !defined(PPO_CL)
#error "compile with -DPPO_OD= -DPPO_AW= -DPPO_H= -DPPO_NL= -DPPO_T= -DPPO_GG= -DPPO_WG= -DPPO_XG= -DPPO_CL= (see ops/ppo_update_cuda.py)"
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
constexpr int CL = PPO_CL;      // blocks of a cluster that share a tile
static_assert(CL == 1 || (CL == 4 && !GG && !WG && !XG),
              "PPO_CL=4 keeps the sums and weights on chip");
constexpr int NT = CL > 1 ? 512 : 256;  // threads per block
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

#if PPO_CL == 1
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
#else
// The cluster layout (PPO_CL=4).  Block r owns hidden units [r HS, r HS +
// HS); the full hidden is padded to HC = CL HS (units past H are 0).
constexpr int HS = up16((H + CL - 1) / CL);
constexpr int HC = CL * HS;
static_assert(HS <= 64, "the cluster layout holds at most 64 units a block");
constexpr int WSS = HS + 8;  // bf16 row stride of a slice ([*][HS])
constexpr int HCS = HC + 8;  // bf16 row stride of a full row ([*][HC])
constexpr int XSS = HS + 8;  // fp32 slice tiles [T][XSS]
// bf16 regions, in elements: the block's columns of W1, Wv ([ODP][WSS]) and
// W2 ([HC][WSS]), its rows of W2 ([HS][HCS], W2[r HS + j][i]), then h1 and
// dz2 of the whole cluster ([T][HCS]; each block writes its columns into
// every block's copy).
constexpr int CB_W1 = 0;
constexpr int CB_WV = CB_W1 + ODP * WSS;
constexpr int CB_W2C = CB_WV + ODP * WSS;
constexpr int CB_W2R = CB_W2C + HC * WSS;
constexpr int CB_H1 = CB_W2R + HS * HCS;
constexpr int CB_DZ2 = CB_H1 + T * HCS;
constexpr int CB_END = CB_DZ2 + T * HCS;  // a multiple of 8
// fp32 regions, in floats: the block's slices of Wm ([HW][HS]), Wv2, b1,
// b2, bv; the head's bm, log_std, bv2; the block's gradient sums but dW2
// (offsets L_*); two raw tiles; h1 (then dz1), h2 (then dz2) and hv (then
// dzv) over the block's units; the rank-ordered partial sums of mean and
// value ([CL][HW + 1][T], written by every block of the cluster); the
// head's rows as in the one-block layout.
constexpr int C_WM = CB_END / 2;
constexpr int C_WV2 = C_WM + up4(HS * HW);
constexpr int C_B1 = C_WV2 + HS;
constexpr int C_B2 = C_B1 + HS;
constexpr int C_BV = C_B2 + HS;
constexpr int S_BM = C_BV + HS;
constexpr int S_LS = S_BM + up4(HW);
constexpr int S_BV2 = S_LS + up4(HW);
constexpr int L_W1 = 0;                   // [OD][HS]
constexpr int L_WV = L_W1 + OD * HS;      // [OD][HS]
constexpr int L_B1 = L_WV + OD * HS;
constexpr int L_B2 = L_B1 + HS;
constexpr int L_BV = L_B2 + HS;
constexpr int L_WM = L_BV + HS;           // [HS][HW]
constexpr int L_WV2 = L_WM + HS * HW;
constexpr int L_BM = L_WV2 + HS;          // rank 0: the head's own sums
constexpr int L_LS = L_BM + HW;
constexpr int L_BV2 = L_LS + HW;
constexpr int L_SUMS = L_BV2 + 1;
constexpr int LG = L_SUMS + 3;
constexpr int C_G = S_BV2 + 4;
constexpr int S_RAW = C_G + up4(LG);
constexpr int RAW = RAW_ROWS * RS;
constexpr int C_X1 = S_RAW + 2 * RAW;
constexpr int C_X2 = C_X1 + T * XSS;
constexpr int C_XV = C_X2 + T * XSS;
constexpr int C_HP = C_XV + T * XSS;
constexpr int S_MEAN = C_HP + CL * (HW + 1) * T;
#endif
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

// bf16 operands of the cluster layout in shared memory (h1 and dz2 as the
// products round them, the weight slices), row stride ld (a multiple of 8),
// read by ldmatrix:
//   AH{X, ld}:   A(m, k) = X[m * ld + k]
//   AHT{X, ld}:  A(m, k) = X[k * ld + m]
//   BH{Y, ld}:   B(k, n) = Y[k * ld + n]
//   BHT{Y, ld}:  B(k, n) = Y[n * ld + k]
struct AH { const uint16_t* x; int ld; };
struct AHT { const uint16_t* x; int ld; };
struct BH { const uint16_t* x; int ld; };
struct BHT { const uint16_t* x; int ld; };

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
DEV float at(const AH& a, int m, int k) { return bf16_value(a.x[m * a.ld + k]); }
DEV float at(const AHT& a, int m, int k) { return bf16_value(a.x[k * a.ld + m]); }
DEV float at(const BH& b, int k, int n) { return bf16_value(b.x[k * b.ld + n]); }
DEV float at(const BHT& b, int k, int n) { return bf16_value(b.x[n * b.ld + k]); }

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

// Matrix q of an x4 ldmatrix (lanes 8q..8q+7 give its rows) is the A
// fragment's register q: (m half q & 1, k half q >> 1).
DEV void frag_a(const AH& a, int m0, int k0, int lane, uint32_t r[4]) {
    const int q = lane >> 3;
    ldsm_x4(a.x + (m0 + (lane & 7) + 8 * (q & 1)) * a.ld + k0 + 8 * (q >> 1), r);
}

// Stored [k][m]: each 8 x 8 block transposed on the way in.
DEV void frag_a(const AHT& a, int m0, int k0, int lane, uint32_t r[4]) {
    const int q = lane >> 3;
    ldsm_x4_trans(a.x + (k0 + (lane & 7) + 8 * (q >> 1)) * a.ld + m0 + 8 * (q & 1),
                  r);
}

// As BW and BWT, at the operand's own row stride.
template <int NB>
DEV void frag_b(const BH& b, int k0, int n0, int lane, uint32_t r[NB][2]) {
    const int row = k0 + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int j = 0; j < NB; j += 2) {
        uint32_t q[4];
        ldsm_x4_trans(b.x + row * b.ld + n0 + 8 * j + 8 * (lane >> 4), q);
        r[j][0] = q[0]; r[j][1] = q[1]; r[j + 1][0] = q[2]; r[j + 1][1] = q[3];
    }
}

template <int NB>
DEV void frag_b(const BHT& b, int k0, int n0, int lane, uint32_t r[NB][2]) {
    const int col = k0 + 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int j = 0; j < NB; j += 2) {
        uint32_t q[4];
        ldsm_x4(b.x + (n0 + 8 * j + (lane & 7) + 8 * (lane >> 4)) * b.ld + col, q);
        r[j][0] = q[0]; r[j][1] = q[1]; r[j + 1][0] = q[2]; r[j + 1][1] = q[3];
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

// Wait until every copy has landed.
DEV void copy_wait_all() {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.wait_group 0;\n" ::);
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

#if PPO_CL == 1
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

#else
// ---- The cluster layout (PPO_CL=4) ---- //

// One block of a cluster as its phases see it: its shared memory, its rank,
// and every block's shared memory as it addresses it (DSMEM on the card).
// On the host the sums that the card keeps in each thread's registers live
// beside it: dw2 [HC][HS] and run [NT][NRUN].
struct Cta {
    float* sm;
    float* peer[CL];
    int rank;
    float* dw2;
    float* run;
};

DEV uint16_t* bf16_of(float* p) { return reinterpret_cast<uint16_t*>(p); }

// A phase runs on every thread of every block of the cluster: on the card
// one block's threads, then a barrier of the block (CPHASE_END) or of the
// cluster (CPHASE_CLUSTER; CPHASE_ARRIVE and CPHASE_WAIT split it around
// the next phase, whose writes the wait does not order); on the host a
// loop over the blocks and their threads.  Each phase sees its block as c,
// its shared memory as sm (wb as bf16), its gradient sums as G, the first
// hidden unit it owns as j0, and the thread's running sums as RUN(k).
#ifdef __CUDACC__
DEV void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
DEV void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
using CtaSet = Cta;  // this block
#define CPHASE_BEGIN { const int tid = threadIdx.x; const Cta& c = cs; \
    CPHASE_NAMES
#define CPHASE_END } __syncthreads();
#define CPHASE_ARRIVE } cluster_arrive();
#define CPHASE_WAIT } cluster_wait();
#define CPHASE_CLUSTER } cluster_arrive(); cluster_wait();
#define RUN(k) run[k]
#else
using CtaSet = Cta*;  // every block of the cluster
#define CPHASE_BEGIN for (int rank_ = 0; rank_ < CL; ++rank_) { \
    const Cta& c = cs[rank_]; for (int tid = 0; tid < NT; ++tid) { CPHASE_NAMES
#define CPHASE_END } }
#define CPHASE_ARRIVE } }
#define CPHASE_WAIT } }
#define CPHASE_CLUSTER } }
#define RUN(k) c.run[tid * NRUN + (k)]
#endif
#define CPHASE_NAMES float* const sm = c.sm; uint16_t* const wb = bf16_of(sm); \
    float* const G = sm + C_G; const int j0 = c.rank * HS; \
    (void)wb; (void)G; (void)j0;

// dW2: warp w holds rows 16 (w + NWARPS mi) .. + 15 of the block's HC x HS
// columns in registers, as mma.m16n8k16 sums (DW_MT row tiles of 16).
constexpr int DW_MT = HC / 16;
constexpr int DW_MPW = (DW_MT + NWARPS - 1) / NWARPS;
constexpr int DW_NB = HS / 8;
using DW2Regs = float[DW_MPW][DW_NB][4];

// The element-wise passes over the block's [T][HS] slices: thread (warp w,
// lane l) takes unit 32 (w % EJ) + l and the samples s = w / EJ + EG k, and
// keeps its running sums of those samples over every tile (RUN: dWm, dWv2,
// db2, dbv, db1), added over the EG sample groups once, at the end.
constexpr int EJ = 2;
constexpr int EG = NWARPS / EJ;
constexpr int ES = T / EG;
static_assert(HS > 32 * (EJ - 1) && HS <= 32 * EJ && T % EG == 0,
              "two warps of lanes span a block's units");
constexpr int R_WM = 0;  // [HW]
constexpr int R_WV2 = HW;
constexpr int R_B2 = HW + 1;
constexpr int R_BV = HW + 2;
constexpr int R_B1 = HW + 3;
constexpr int NRUN = HW + 4;
// The running sums of every thread, [EG][HS][NRUN], at the end where the
// weights, h1 and dz2 were.
static_assert(EG * HS * NRUN <= (CB_END - CB_W2C) / 2,
              "the running sums fit the trunk's regions");
static_assert(CL == 4, "warp_sums hands each sum to 4 blocks");

// out(j, sum over k < K of term(k, j), q) for j < J, once for each q < 4:
// a warp a j (warp w takes j = 4 w + b, 4 (w + NWARPS) + b, ...), its lane
// l the k = l, l + 32, ... in order, the lanes' sums added by a butterfly
// (xor 16, 8, 4, 2, 1), on the host in the same order.  Every lane then
// holds every sum, and lane 4 b + q hands on sum b for q (a store to block
// q, in the exchange).  For sums whose k runs along a row of shared
// memory.
template <class Term, class Out>
DEV void warp_sums(int tid, int J, int K, Term term, Out out) {
#ifdef __CUDA_ARCH__
    const int warp = tid >> 5, lane = tid & 31;
    for (int jb = 4 * warp; jb < J; jb += 4 * NWARPS) {
        float v[4];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
            v[b] = 0.f;
            if (jb + b < J)
                for (int k = lane; k < K; k += 32) v[b] += term(k, jb + b);
        }
#pragma unroll
        for (int w = 16; w >= 1; w >>= 1)
#pragma unroll
            for (int b = 0; b < 4; ++b) v[b] += __shfl_xor_sync(0xffffffffu, v[b], w);
        if (lane < 16) {
            const int b = lane >> 2;
            const float vb = b == 0 ? v[0] : b == 1 ? v[1] : b == 2 ? v[2] : v[3];
            if (jb + b < J) out(jb + b, vb, lane & 3);
        }
    }
#else
    for (int j = tid; j < J; j += NT) {
        float v[32], u[32];
        for (int l = 0; l < 32; ++l) {
            v[l] = 0.f;
            for (int k = l; k < K; k += 32) v[l] += term(k, j);
        }
        for (int w = 16; w >= 1; w >>= 1) {
            for (int l = 0; l < 32; ++l) u[l] = v[l] + v[l ^ w];
            for (int l = 0; l < 32; ++l) v[l] = u[l];
        }
        for (int q = 0; q < 4; ++q) out(j, v[0], q);
    }
#endif
}

// This block's columns [j0, j0 + HS) of a [T][HCS] bf16 tile, from its own
// copy into every other block's, 16 bytes a store.
DEV void push_slice(int tid, const Cta& c, int region) {
    constexpr int CHUNKS = HS / 8;  // 8 bf16 a chunk
    const uint16_t* own = bf16_of(c.sm) + region + c.rank * HS;
    for (int i = tid; i < T * CHUNKS; i += NT) {
        const int off = (i / CHUNKS) * HCS + 8 * (i % CHUNKS);
        for (int q = 0; q < CL; ++q) {
            if (q == c.rank) continue;
            uint16_t* dst = bf16_of(c.peer[q]) + region + c.rank * HS + off;
#ifdef __CUDA_ARCH__
            *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(own + off);
#else
            memcpy(dst, own + off, 16);
#endif
        }
    }
}

// The column in the packed rollout of the sample this thread copies in
// tile `tile` (sample tid % T), or -1 past the minibatch's end.
DEV long tile_col(int tid, int tile, const int* __restrict__ perm,
                  const PPODims& dm) {
    const int q = tile * T + tid % T;
    return q < dm.mb ? (long)perm[q / dm.lb] * dm.lb + q % dm.lb : -1;
}

// Start the copy of a tile's raw columns: this thread's sample (column
// col, zeros if -1), rows tid / T, tid / T + NT / T, ...
DEV void issue_col(int tid, long col, float* raw,
                   const float* __restrict__ packed, const PPODims& dm) {
    static_assert(NT % T == 0, "threads a multiple of the tile");
    const int s = tid % T;
    for (int row = tid / T; row < D; row += NT / T)
        copy_async(raw + row * RS + s,
                   packed + (col >= 0 ? (long)row * dm.n + col : 0), col >= 0);
}

// dW2[j][j0 + i] += sum over the tile's samples s of h1[s][j] dz2[s][j0 + i],
// both as bf16 (the cluster's h1 and the block's own columns of dz2).
DEV void dw2_add(int tid, const Cta& c, DW2Regs& acc) {
    const uint16_t* h1 = bf16_of(c.sm) + CB_H1;
    const uint16_t* dz2 = bf16_of(c.sm) + CB_DZ2 + c.rank * HS;
#ifdef __CUDA_ARCH__
    const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
    for (int mi = 0; mi < DW_MPW; ++mi) {
        const int mt = warp + NWARPS * mi;
        if (mt >= DW_MT) break;
#pragma unroll
        for (int k0 = 0; k0 < T; k0 += 16) {
            uint32_t af[4], bf[DW_NB][2];
            frag_a(AHT{h1, HCS}, 16 * mt, k0, lane, af);
            frag_b<DW_NB>(BH{dz2, HCS}, k0, 0, lane, bf);
#pragma unroll
            for (int j = 0; j < DW_NB; ++j) mma(acc[mi][j], af, bf[j]);
        }
    }
#else
    (void)acc;
    for (int o = tid; o < HC * HS; o += NT) {
        const int j = o / HS, i = o % HS;
        float v = 0.f;
        for (int s = 0; s < T; ++s)
            v += bf16_value(h1[s * HCS + j]) * bf16_value(dz2[s * HCS + i]);
        c.dw2[o] += v;
    }
#endif
}

// The block's columns of dW2 into the cluster's row of partial.
DEV void dw2_write(int tid, const Cta& c, const DW2Regs& acc, float* out) {
#ifdef __CUDA_ARCH__
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mi = 0; mi < DW_MPW; ++mi) {
        const int mt = warp + NWARPS * mi;
        if (mt >= DW_MT) break;
#pragma unroll
        for (int jb = 0; jb < DW_NB; ++jb)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int j = 16 * mt + g + 8 * (e >> 1);
                const int i = c.rank * HS + 8 * jb + 2 * t + (e & 1);
                if (j < H && i < H) out[G_W2 + j * H + i] = acc[mi][jb][e];
            }
    }
#else
    (void)acc;
    for (int o = tid; o < HC * HS; o += NT) {
        const int j = o / HS, i = c.rank * HS + o % HS;
        if (j < H && i < H) out[G_W2 + j * H + i] = c.dw2[o];
    }
#endif
}

// Everything one cluster does: its tiles row, row + rows, ...; its blocks'
// sums into row `row` of partial.
DEV void cluster_body(int row, int rows, CtaSet cs,
                      const float* __restrict__ packed,
                      const int* __restrict__ perm,
                      const float* __restrict__ stats, const PPOParams& pr,
                      float* __restrict__ partial, const PPODims& dm) {
    const int n_tiles = (dm.mb + T - 1) / T;
    // On the card each thread loads its sample's column of the tile after
    // next a tile ahead, so that no copy waits on its block index.
    long col_next = -1;
    (void)col_next;
    DW2Regs acc;
    for (int mi = 0; mi < DW_MPW; ++mi)
        for (int jb = 0; jb < DW_NB; ++jb)
            for (int e = 0; e < 4; ++e) acc[mi][jb][e] = 0.f;
    float run[NRUN];
    for (int k = 0; k < NRUN; ++k) run[k] = 0.f;
    (void)run;

    // The block's weights: the trunk's as bf16, rows padded with zeros to
    // the strides, units past H 0, Wm as [HW][HS]; zero sums; the first
    // tile's copy.  The cluster barrier after it: every block runs before
    // another writes into it.
    CPHASE_BEGIN
        for (int i = tid; i < ODP * WSS; i += NT) {
            const int k = i / WSS, jl = i - k * WSS, j = j0 + jl;
            const bool in = k < OD && jl < HS && j < H;
            wb[CB_W1 + i] = bf16_bits(in ? pr.p[0][k * H + j] : 0.f);
            wb[CB_WV + i] = bf16_bits(in ? pr.p[7][k * H + j] : 0.f);
        }
        for (int i = tid; i < HC * WSS; i += NT) {
            const int k = i / WSS, jl = i - k * WSS, j = j0 + jl;
            wb[CB_W2C + i] = bf16_bits(k < H && jl < HS && j < H
                                           ? pr.p[2][k * H + j] : 0.f);
        }
        for (int i = tid; i < HS * HCS; i += NT) {
            const int jl = i / HCS, k = i - jl * HCS, j = j0 + jl;
            wb[CB_W2R + i] = bf16_bits(j < H && k < H ? pr.p[2][j * H + k] : 0.f);
        }
        for (int i = tid; i < HW * HS; i += NT) {
            const int a = i / HS, j = j0 + i % HS;
            sm[C_WM + i] = j < H ? pr.p[4][j * HW + a] : 0.f;
        }
        for (int jl = tid; jl < HS; jl += NT) {
            const int j = j0 + jl;
            const bool in = j < H;
            sm[C_WV2 + jl] = in ? pr.p[9][j] : 0.f;
            sm[C_B1 + jl] = in ? pr.p[1][j] : 0.f;
            sm[C_B2 + jl] = in ? pr.p[3][j] : 0.f;
            sm[C_BV + jl] = in ? pr.p[8][j] : 0.f;
        }
        for (int i = tid; i < HW; i += NT) {
            sm[S_BM + i] = pr.p[5][i];
            sm[S_LS + i] = pr.p[6][i];
        }
        if (tid == 0) sm[S_BV2] = pr.p[10][0];
        for (int i = tid; i < LG; i += NT) G[i] = 0.f;
        for (int i = tid; i < (RAW_ROWS - D) * RS; i += NT) {
            sm[S_RAW + D * RS + i] = 0.f;
            sm[S_RAW + RAW + D * RS + i] = 0.f;
        }
        if (row < n_tiles)
            issue_col(tid, tile_col(tid, row, perm, dm), sm + S_RAW, packed, dm);
        copy_commit();
        copy_wait_all();
#ifdef __CUDA_ARCH__
        if (row + rows < n_tiles) col_next = tile_col(tid, row + rows, perm, dm);
#endif
    CPHASE_CLUSTER

    int it = 0;
    for (int tile = row; tile < n_tiles; tile += rows, ++it) {
        const int rb = S_RAW + (it & 1) * RAW;  // this tile's raw columns
        // This tile's copy has landed (the last phase of the one before
        // waited for it); the next tile's starts, into the raw buffer that
        // the tile before last used.  h1 = tanh(obs_b W1b + b1) over the
        // block's units: fp32 into its own slice, bf16 into its columns of
        // its h1, then into every other block's.
        CPHASE_BEGIN
            if (tile + rows < n_tiles) {
#ifdef __CUDA_ARCH__
                const long col = col_next;
#else
                const long col = tile_col(tid, tile + rows, perm, dm);
#endif
                issue_col(tid, col, sm + S_RAW + ((it + 1) & 1) * RAW, packed, dm);
            }
            copy_commit();
#ifdef __CUDA_ARCH__
            if (tile + 2 * rows < n_tiles)
                col_next = tile_col(tid, tile + 2 * rows, perm, dm);
#endif
            tc_product<T, HS, ODP>(
                tid, ACols{sm + rb, RS}, BH{wb + CB_W1, WSS},
                [&](int s, int jl, float v) {
                    const float h = tanhf(v + sm[C_B1 + jl]);
                    sm[C_X1 + s * XSS + jl] = h;
                    wb[CB_H1 + s * HCS + j0 + jl] = bf16_bits(h);
                });
        CPHASE_END
        CPHASE_BEGIN
            push_slice(tid, c, CB_H1);
        CPHASE_ARRIVE

        // hv = tanh(obs_b Wvb + bv) over the block's units, while the other
        // blocks' h1 arrives.
        CPHASE_BEGIN
            tc_product<T, HS, ODP>(
                tid, ACols{sm + rb, RS}, BH{wb + CB_WV, WSS},
                [&](int s, int jl, float v) {
                    sm[C_XV + s * XSS + jl] = tanhf(v + sm[C_BV + jl]);
                });
        CPHASE_WAIT

        // h2 = tanh(h1_b W2b + b2) over the block's units.
        CPHASE_BEGIN
            tc_product<T, HS, HC>(
                tid, AH{wb + CB_H1, HCS}, BH{wb + CB_W2C, WSS},
                [&](int s, int jl, float v) {
                    sm[C_X2 + s * XSS + jl] = tanhf(v + sm[C_B2 + jl]);
                });
        CPHASE_END

        // The block's terms of mean (or logits) = h2 Wm and value = hv Wv2,
        // into every block's row c.rank of the partial sums.
        CPHASE_BEGIN
            warp_sums(
                tid, (HW + 1) * T, HS,
                [&](int jl, int i) {
                    const int a = i / T, s = i % T;
                    return a < HW ? sm[C_WM + a * HS + jl] * sm[C_X2 + s * XSS + jl]
                                  : sm[C_WV2 + jl] * sm[C_XV + s * XSS + jl];
                },
                [&](int i, float v, int q) {
                    (q == c.rank ? sm : c.peer[q])[C_HP + c.rank * (HW + 1) * T + i] = v;
                });
        CPHASE_CLUSTER

        // The head of sample tid: mean + bm and value + bv2 from the blocks'
        // terms added in rank order (the same numbers in every block), then
        // the loss terms and the gradients of mean and value.
        CPHASE_BEGIN
            if (tid < T) {
                for (int a = 0; a <= HW; ++a) {
                    const int i = a * T + tid;
                    float v = sm[C_HP + i];
                    for (int q = 1; q < CL; ++q) v += sm[C_HP + q * (HW + 1) * T + i];
                    if (a < HW) sm[S_MEAN + a * TS + tid] = v + sm[S_BM + a];
                    else sm[S_VAL + tid] = v + sm[S_BV2];
                }
                head(tid, tile * T + tid < dm.mb, sm, sm + rb, stats, dm);
            }
        CPHASE_END

        // dz2 = (dmean Wm') (1 - h2^2) and dzv = dvalue Wv2' (1 - hv^2) over
        // the block's units (0 past H: Wm and Wv2 are 0 there), dz2 also as
        // bf16 into its columns of its dz2; the thread's running dWm, dWv2,
        // db2 and dbv.  Rank 0 adds the head's own rows (S_MEAN (HW),
        // S_VAL, S_PG, S_VF, S_ENT and, Gaussian, S_DLS (AW), one after the
        // other at the stride TS) into its sums.
        CPHASE_BEGIN
            const int jl = 32 * ((tid >> 5) % EJ) + (tid & 31);
            if (jl < HS)
                for (int k = 0; k < ES; ++k) {
                    const int s = (tid >> 5) / EJ + EG * k;
                    const float h = sm[C_X2 + s * XSS + jl];
                    float v = 0.f;
                    for (int a = 0; a < HW; ++a) {
                        const float dmean = sm[S_MEAN + a * TS + s];
                        v += sm[C_WM + a * HS + jl] * dmean;
                        RUN(R_WM + a) += h * dmean;
                    }
                    const float dz2 = v * (1.0f - h * h);
                    const float dvalue = sm[S_VAL + s];
                    const float hv = sm[C_XV + s * XSS + jl];
                    const float dzv = sm[C_WV2 + jl] * dvalue * (1.0f - hv * hv);
                    RUN(R_WV2) += hv * dvalue;
                    RUN(R_B2) += dz2;
                    RUN(R_BV) += dzv;
                    sm[C_X2 + s * XSS + jl] = dz2;
                    sm[C_XV + s * XSS + jl] = dzv;
                    wb[CB_DZ2 + s * HCS + j0 + jl] = bf16_bits(dz2);
                }
            if (c.rank == 0)
                warp_sums(
                    tid, HW + 4 + (DISCRETE ? 0 : AW), T,
                    [&](int s, int r) { return sm[S_MEAN + r * TS + s]; },
                    [&](int r, float v, int q) {
                        if (q != 0) return;
                        const int to = r < HW ? L_BM + r
                                     : r == HW ? L_BV2
                                     : r < HW + 4 ? L_SUMS + r - HW - 1
                                     : L_LS + r - HW - 4;
                        G[to] += v;
                    });
        CPHASE_END

        // dz2 into every other block's; dW2 += h1_b' dz2_b over the block's
        // columns.  It reads the cluster's h1, so it ends before this
        // block arrives.
        CPHASE_BEGIN
            push_slice(tid, c, CB_DZ2);
            dw2_add(tid, c, acc);
        CPHASE_ARRIVE

        // dWv += obs_b' dzv_b, while the other blocks' dz2 arrives.
        CPHASE_BEGIN
            tc_product<ODP, HS, T>(
                tid, ARows{sm + rb, RS}, BCols{sm + C_XV, XSS},
                [&](int k, int j, float v) {
                    if (k < OD) G[L_WV + k * HS + j] += v;
                });
        CPHASE_WAIT

        // dz1 = (dz2_b W2b') (1 - h1^2) over the block's units.
        CPHASE_BEGIN
            tc_product<T, HS, HC>(
                tid, AH{wb + CB_DZ2, HCS}, BHT{wb + CB_W2R, HCS},
                [&](int s, int jl, float v) {
                    const float h = sm[C_X1 + s * XSS + jl];
                    sm[C_X1 + s * XSS + jl] = v * (1.0f - h * h);
                });
        CPHASE_END

        // The running db1; dW1 += obs_b' dz1_b; the next tile's copy lands.
        CPHASE_BEGIN
            const int jl = 32 * ((tid >> 5) % EJ) + (tid & 31);
            if (jl < HS)
                for (int k = 0; k < ES; ++k)
                    RUN(R_B1) += sm[C_X1 + ((tid >> 5) / EJ + EG * k) * XSS + jl];
            tc_product<ODP, HS, T>(
                tid, ARows{sm + rb, RS}, BCols{sm + C_X1, XSS},
                [&](int k, int j, float v) {
                    if (k < OD) G[L_W1 + k * HS + j] += v;
                });
            copy_wait_all();
        CPHASE_END
    }

    // The running sums of the EG sample groups, added in group order, where
    // the trunk's weights, h1 and dz2 were (no block writes there any more).
    CPHASE_BEGIN
        float* const runs = reinterpret_cast<float*>(wb + CB_W2C);
        const int jl = 32 * ((tid >> 5) % EJ) + (tid & 31);
        if (jl < HS)
            for (int k = 0; k < NRUN; ++k)
                runs[((tid >> 5) / EJ * HS + jl) * NRUN + k] = RUN(k);
    CPHASE_END
    CPHASE_BEGIN
        const float* const runs = reinterpret_cast<const float*>(wb + CB_W2C);
        for (int i = tid; i < HS * NRUN; i += NT) {
            const int jl = i / NRUN, k = i % NRUN;
            float v = runs[i];
            for (int g = 1; g < EG; ++g) v += runs[g * HS * NRUN + i];
            const int to = k < HW ? L_WM + jl * HW + k
                         : k == R_WV2 ? L_WV2 + jl
                         : k == R_B2 ? L_B2 + jl
                         : k == R_BV ? L_BV + jl
                         : L_B1 + jl;
            G[to] = v;
        }
    CPHASE_END

    // Each block's share of the cluster's row, once; rank 0 writes the
    // head's sums.  The barrier after it: no block leaves while another
    // may still write into it.
    CPHASE_BEGIN
        float* const out = partial + (long)row * P;
        for (int i = tid; i < OD * HS; i += NT) {
            const int k = i / HS, j = j0 + i % HS;
            if (j < H) {
                out[G_W1 + k * H + j] = G[L_W1 + i];
                out[G_WV + k * H + j] = G[L_WV + i];
            }
        }
        for (int jl = tid; jl < HS; jl += NT) {
            const int j = j0 + jl;
            if (j < H) {
                out[G_B1 + j] = G[L_B1 + jl];
                out[G_B2 + j] = G[L_B2 + jl];
                out[G_BV + j] = G[L_BV + jl];
                out[G_WV2 + j] = G[L_WV2 + jl];
            }
        }
        for (int i = tid; i < HS * HW; i += NT) {
            const int j = j0 + i / HW;
            if (j < H) out[G_WM + j * HW + i % HW] = G[L_WM + i];
        }
        if (c.rank == 0) {
            for (int i = tid; i < HW; i += NT) {
                out[G_BM + i] = G[L_BM + i];
                out[G_LS + i] = G[L_LS + i];
            }
            if (tid == 0) {
                out[G_BV2] = G[L_BV2];
                for (int k = 0; k < 3; ++k) out[G_SUMS + k] = G[L_SUMS + k];
            }
        }
        dw2_write(tid, c, acc, out);
    CPHASE_CLUSTER
}
#endif

#ifdef __CUDACC__
#if PPO_CL == 1
__global__ void __launch_bounds__(NT, 2)
ppo_update_kernel(const float* __restrict__ packed, const int* __restrict__ perm,
                  const float* __restrict__ stats, const PPOParams pr,
                  float* __restrict__ partial, const PPODims dm) {
    extern __shared__ float4 smem4[];
    block_body(blockIdx.x, gridDim.x, reinterpret_cast<float*>(smem4), packed,
               perm, stats, pr, partial, dm);
}
#else
// Cluster blockIdx.x / CL takes row blockIdx.x / CL of partial.
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(NT, 1)
ppo_update_kernel(const float* __restrict__ packed, const int* __restrict__ perm,
                  const float* __restrict__ stats, const PPOParams pr,
                  float* __restrict__ partial, const PPODims dm) {
    extern __shared__ float4 smem4[];
    const cooperative_groups::cluster_group cluster =
        cooperative_groups::this_cluster();
    Cta c;
    c.sm = reinterpret_cast<float*>(smem4);
    c.rank = (int)cluster.block_rank();
    for (int q = 0; q < CL; ++q) c.peer[q] = cluster.map_shared_rank(c.sm, q);
    c.dw2 = c.run = nullptr;
    cluster_body(blockIdx.x / CL, gridDim.x / CL, c, packed, perm, stats, pr,
                 partial, dm);
}
#endif

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
// The kernel's shared memory, set once; the CUDA error (0: none).
static int configure() {
    static bool configured = false;
    if (!configured) {
        cudaError_t err = cudaFuncSetAttribute(
            ppo_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            SMEM_BYTES);
        if (err != cudaSuccess) return (int)err;
        configured = true;
    }
    return 0;
}

// Clusters of the update kernel the current device runs at once (the
// cluster layout's most rows of partial); 0 on an error or with PPO_CL=1.
extern "C" int vmt_ppo_max_clusters() {
#if PPO_CL == 1
    return 0;
#else
    if (configure() != 0) return 0;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CL, 1, 1);
    cfg.blockDim = dim3(NT, 1, 1);
    cfg.dynamicSmemBytes = SMEM_BYTES;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, ppo_update_kernel, &cfg) != cudaSuccess)
        return 0;
    return n;
#endif
}

// One minibatch: `grid` blocks (clusters of CL blocks, in the cluster
// layout) write their sums to partial [grid, P], then out [P] gets their
// sum.  With PPO_XG=1 the buffer holds, from float up4(grid * P) on, grid
// slices of vmt_ppo_scratch_floats() more.  Returns the CUDA error of the
// launches (0: none).
extern "C" int vmt_ppo_update(const float* packed, const int* perm,
                              const float* stats, const PPOParams* params,
                              float* partial, float* out, const PPODims* dims,
                              int grid, void* stream) {
    const int err0 = configure();
    if (err0 != 0) return err0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    ppo_update_kernel<<<grid * CL, NT, SMEM_BYTES, s>>>(packed, perm, stats,
                                                        *params, partial, *dims);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ppo_reduce_kernel<<<(P + 31) / 32, 32 * RED_RUNS, 0, s>>>(partial, grid,
                                                              out);
    return (int)cudaGetLastError();
}
#else
extern "C" int vmt_ppo_max_clusters() { return 0; }

// The same phases on the host, one block (or cluster) after the other.
extern "C" int vmt_ppo_update(const float* packed, const int* perm,
                              const float* stats, const PPOParams* params,
                              float* partial, float* out, const PPODims* dims,
                              int grid, void*) {
#if PPO_CL == 1
    std::vector<float> sm(S_TOTAL);
    for (int b = 0; b < grid; ++b)
        block_body(b, grid, sm.data(), packed, perm, stats, *params, partial,
                   *dims);
#else
    std::vector<float> sm(CL * (long)S_TOTAL), dw2(CL * (long)HC * HS),
        run(CL * (long)NT * NRUN);
    for (int b = 0; b < grid; ++b) {
        Cta cs[CL];
        for (int r = 0; r < CL; ++r) {
            cs[r].sm = sm.data() + r * (long)S_TOTAL;
            cs[r].rank = r;
            cs[r].dw2 = dw2.data() + r * (long)HC * HS;
            cs[r].run = run.data() + r * (long)NT * NRUN;
            for (int q = 0; q < CL; ++q) cs[r].peer[q] = sm.data() + q * (long)S_TOTAL;
        }
        std::fill(dw2.begin(), dw2.end(), 0.f);
        std::fill(run.begin(), run.end(), 0.f);
        cluster_body(b, grid, cs, packed, perm, stats, *params, partial, *dims);
    }
#endif
    for (int p = 0; p < P; ++p) {
        float sum = 0.f;
        for (int g = 0; g < grid; ++g) sum += partial[(long)g * P + p];
        out[p] = sum;
    }
    return 0;
}
#endif
