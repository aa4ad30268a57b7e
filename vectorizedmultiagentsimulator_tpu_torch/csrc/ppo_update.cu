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
// 2*(2*OD*H + H*H + H*HW + H) multiply-adds forward and about twice that
// backward (33 kFLOP at OD=15, H=64) against D*4 = 88 bytes read, so the
// fp32 rate outside the tensor cores is the limit, not memory.
//
// Design.  The TPU kernel walks a sequential grid and adds into revisited
// output blocks; here blocks run in parallel, so each block loops over its
// own tiles of T samples, keeps the gradient sums of its tiles in shared
// memory, and writes them once to a [grid, P] buffer that a second small
// kernel sums in block order.  No float atomics: the same inputs give the
// same bits.  The minibatch's shuffle is folded into the tile load (sample q
// of the minibatch lies in column perm[q / lb] * lb + q % lb), as the TPU
// kernel folds it into its index map.  Weights (the trunk's rounded to bf16
// once) and a tile's activations stay in shared memory as fp32 [rows][T];
// every product is a small shared-memory matrix product with a register
// micro-tile per thread: rows of the weight are warp-uniform broadcasts and
// activations are read as float4 along the samples.  Trunk products round
// both operands to bf16 and accumulate in fp32, heads are fp32, and the
// backward rounds the cotangents dz2, dz1, dzv and the activations in the
// dW and dh1 products, as the TPU kernel does.  The head's shape is static
// and small, so the file is compiled once per (OD, AW, H, NL, T) with -D
// flags; sizes that change between launches of one trainer (n, mb, lb, the
// loss coefficients) are runtime fields of PPODims.  The wrapper picks T,
// the largest of 128, 64, 32 and 16 samples whose tile fits a block's shared
// memory beside the weights and the gradient sums: 128 up to hidden 64, less
// for a wider trunk.  Hidden sizes whose weights and sums alone exceed the
// shared memory (from about 150) are refused by the wrapper.
//
// The body is written as phases over the block's threads with a barrier
// after each, and nothing in a phase depends on another thread of the same
// phase; compiled as host C++ (no __CUDACC__) the same phases run as loops
// over the thread index, which is how the CPU tests run this source.
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
struct float4 { float x, y, z, w; };
#define DEV inline
#define PHASE_BEGIN for (int tid = 0; tid < NT; ++tid) {
#define PHASE_END }
#endif

#if !defined(PPO_OD) || !defined(PPO_AW) || !defined(PPO_H) || \
    !defined(PPO_NL) || !defined(PPO_T)
#error "compile with -DPPO_OD= -DPPO_AW= -DPPO_H= -DPPO_NL= -DPPO_T= (see ops/ppo_update_cuda.py)"
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
constexpr int T = PPO_T;   // samples per tile
constexpr int TS = T + 4;  // row stride of a tile in shared memory (floats)
constexpr int NT = 256;    // threads per block
static_assert(T == 128 || T == 64 || T == 32 || T == 16, "T is 128, 64, 32 or 16");

constexpr float LOG_2PI = 1.8378770664093453f;
constexpr float ENT_C = 1.4189385332046727f;  // 0.5 * log(2 pi) + 0.5

constexpr int up4(int x) { return (x + 3) / 4 * 4; }

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

// Shared memory, in floats; every region starts on 16 bytes.
constexpr int S_W1 = 0;
constexpr int S_W2 = S_W1 + up4(OD * H);
constexpr int S_WM = S_W2 + up4(H * H);
constexpr int S_WV = S_WM + up4(H * HW);
constexpr int S_WV2 = S_WV + up4(OD * H);
constexpr int S_B1 = S_WV2 + up4(H);
constexpr int S_B2 = S_B1 + up4(H);
constexpr int S_BM = S_B2 + up4(H);
constexpr int S_BV = S_BM + up4(HW);
constexpr int S_BV2 = S_BV + up4(H);
constexpr int S_LS = S_BV2 + 4;
constexpr int S_G = S_LS + up4(HW);
constexpr int S_OBS = S_G + P4;
constexpr int S_X1 = S_OBS + OD * TS;   // h1, then dz1
constexpr int S_X2 = S_X1 + H * TS;     // h2, then dz2
constexpr int S_XV = S_X2 + H * TS;     // hv, then dzv
constexpr int S_MEAN = S_XV + H * TS;   // mean or logits, then their gradient
constexpr int S_ACT = S_MEAN + HW * TS;
constexpr int S_LOGP = S_ACT + AW * TS;
constexpr int S_ADV = S_LOGP + TS;      // normalised advantage
constexpr int S_RET = S_ADV + TS;
constexpr int S_MASK = S_RET + TS;
constexpr int S_VAL = S_MASK + HW * TS;  // value, then its gradient
constexpr int S_PG = S_VAL + TS;
constexpr int S_VF = S_PG + TS;
constexpr int S_ENT = S_VF + TS;
constexpr int S_DLS = S_ENT + TS;        // per-sample log_std gradient terms
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

DEV float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

DEV float4 round4(float4 v) {
    v.x = bf16r(v.x); v.y = bf16r(v.y); v.z = bf16r(v.z); v.w = bf16r(v.w);
    return v;
}

enum WeightLayout { W_KM, W_MK };

// OUT[m][s] = epi(sum_k W(k, m) * IN[k][s]) for m < M and the tile's T
// samples.  W(k, m) is W[k * M + m] (W_KM, a forward product with the
// weight as stored) or W[m * K + k] (W_MK, the product with its transpose).
// With SG = T / 4 sample groups and MG = NT / SG row groups, thread (mi, si)
// = (tid / SG, tid % SG) owns the MB = ceil(M / MG) rows from mi * MB and
// samples 4 si .. 4 si + 3; at T = 128 a warp shares its weight rows.
template <int M, int K, int WL, bool ROUND_IN, class Epi>
DEV void gemm_tile(int tid, const float* W, const float* IN, Epi epi) {
    constexpr int SG = T / 4, MG = NT / SG;
    constexpr int MB = (M + MG - 1) / MG;
    const int mi = tid / SG, si = tid % SG;
    const int m0 = mi * MB;
    if (m0 >= M) return;
    float acc[MB][4];
#pragma unroll
    for (int j = 0; j < MB; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    const float* in = IN + 4 * si;
    if constexpr (WL == W_KM && M % MG == 0 && MB % 4 == 0) {
        for (int k = 0; k < K; ++k) {
            float4 x = ld4(in + k * TS);
            if (ROUND_IN) x = round4(x);
#pragma unroll
            for (int j4 = 0; j4 < MB / 4; ++j4) {
                const float4 w = ld4(W + k * M + m0 + 4 * j4);
                const float ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    acc[4 * j4 + i][0] += ws[i] * x.x;
                    acc[4 * j4 + i][1] += ws[i] * x.y;
                    acc[4 * j4 + i][2] += ws[i] * x.z;
                    acc[4 * j4 + i][3] += ws[i] * x.w;
                }
            }
        }
    } else if constexpr (WL == W_MK && K % 4 == 0 && M % MG == 0) {
        for (int k = 0; k < K; k += 4) {
            float4 x[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                x[i] = ld4(in + (k + i) * TS);
                if (ROUND_IN) x[i] = round4(x[i]);
            }
#pragma unroll
            for (int j = 0; j < MB; ++j) {
                const float4 w = ld4(W + (m0 + j) * K + k);
                const float ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    acc[j][0] += ws[i] * x[i].x;
                    acc[j][1] += ws[i] * x[i].y;
                    acc[j][2] += ws[i] * x[i].z;
                    acc[j][3] += ws[i] * x[i].w;
                }
            }
        }
    } else {
        for (int k = 0; k < K; ++k) {
            float4 x = ld4(in + k * TS);
            if (ROUND_IN) x = round4(x);
#pragma unroll
            for (int j = 0; j < MB; ++j) {
                const int m = m0 + j;
                const float w =
                    m < M ? (WL == W_KM ? W[k * M + m] : W[m * K + k]) : 0.f;
                acc[j][0] += w * x.x;
                acc[j][1] += w * x.y;
                acc[j][2] += w * x.z;
                acc[j][3] += w * x.w;
            }
        }
    }
#pragma unroll
    for (int j = 0; j < MB; ++j)
        if (m0 + j < M) epi(m0 + j, 4 * si, acc[j]);
}

// G(a, b) += sum_s A[a][s] * B[b][s] over the tile, for a < KA, b < NB;
// G(a, b) is G[a * NB + b], or G[b * KA + a] when TR.  Thread (ai, bi) =
// (tid / 16, tid % 16) owns rows 4 ai .. 4 ai + 3 of A (and the same rows of
// every further 64 where KA > 64) and rows bi + 16 j of B, always the same
// entries, so the sums need no atomics.
template <int KA, int NB, bool RA, bool RB, bool TR>
DEV void grad_acc(int tid, const float* A, const float* B, float* G) {
    constexpr int NBJ = (NB + 15) / 16;
    constexpr int PASS = 4 * (NT / 16);  // rows of A covered at once
    const int ai = tid >> 4, bi = tid & 15;
    if (bi >= NB) return;
    const float4 zero = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int p0 = 0; p0 < KA; p0 += PASS) {
        const int a0 = p0 + ai * 4;
        if (a0 >= KA) return;
        float acc[4][NBJ];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < NBJ; ++j) acc[i][j] = 0.f;
        for (int s = 0; s < T; s += 4) {
            float4 a[4], b[NBJ];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                a[i] = a0 + i < KA ? ld4(A + (a0 + i) * TS + s) : zero;
                if (RA) a[i] = round4(a[i]);
            }
#pragma unroll
            for (int j = 0; j < NBJ; ++j) {
                b[j] = bi + 16 * j < NB ? ld4(B + (bi + 16 * j) * TS + s) : zero;
                if (RB) b[j] = round4(b[j]);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < NBJ; ++j) {
                    acc[i][j] += a[i].x * b[j].x;
                    acc[i][j] += a[i].y * b[j].y;
                    acc[i][j] += a[i].z * b[j].z;
                    acc[i][j] += a[i].w * b[j].w;
                }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < NBJ; ++j) {
                const int a_ = a0 + i, b_ = bi + 16 * j;
                if (a_ < KA && b_ < NB)
                    G[TR ? b_ * KA + a_ : a_ * NB + b_] += acc[i][j];
            }
    }
}

// G[r] += sum_s X[r][s] for r < R: one thread a row, samples in order.
DEV void row_sums(int tid, int R, const float* X, float* G) {
    for (int r = tid; r < R; r += NT) {
        float sum = 0.f;
        for (int s = 0; s < T; s += 4) {
            const float4 v = ld4(X + r * TS + s);
            sum += v.x; sum += v.y; sum += v.z; sum += v.w;
        }
        G[r] += sum;
    }
}

// The loss head for sample s of the tile: from mean (or logits), value and
// the packed fields to the per-sample loss terms and the gradients of mean
// and value, written in place.  A sample past the minibatch's end
// contributes zeros.
DEV void head(int s, bool valid, float* sm, const PPODims& dm) {
    float logp = 0.f, ent = 0.f;
    if constexpr (DISCRETE) {
        for (int k = 0; k < AW; ++k) {
            const int a_idx = (int)sm[S_ACT + k * TS + s];
            float lg[NL > 0 ? NL : 1];
            float mx = -3.0e38f;
#pragma unroll
            for (int j = 0; j < NL; ++j) {
                lg[j] = sm[S_MEAN + (k * NL + j) * TS + s]
                        + sm[S_MASK + (k * NL + j) * TS + s];
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
            const float diff = sm[S_ACT + a * TS + s] - sm[S_MEAN + a * TS + s];
            const float m = sm[S_MASK + a * TS + s];
            const float contrib = -0.5f * diff * diff / var - ls - 0.5f * LOG_2PI;
            logp += m * contrib;
            ent += m * (ls + ENT_C);
        }
    }
    const float adv = sm[S_ADV + s];
    const float ratio = expf(logp - sm[S_LOGP + s]);
    const float rclip = fminf(fmaxf(ratio, dm.clip_lo), dm.clip_hi);
    const float t1 = ratio * adv, t2 = rclip * adv;
    const float verr = sm[S_VAL + s] - sm[S_RET + s];
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
            const int a_idx = (int)sm[S_ACT + k * TS + s];
            float lg[NL > 0 ? NL : 1];
            float mx = -3.0e38f;
#pragma unroll
            for (int j = 0; j < NL; ++j) {
                lg[j] = sm[S_MEAN + (k * NL + j) * TS + s]
                        + sm[S_MASK + (k * NL + j) * TS + s];
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
            const float diff = sm[S_ACT + a * TS + s] - sm[S_MEAN + a * TS + s];
            const float m = sm[S_MASK + a * TS + s];
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
    PHASE_BEGIN
        for (int i = tid; i < OD * H; i += NT) {
            sm[S_W1 + i] = bf16r(pr.p[0][i]);
            sm[S_WV + i] = bf16r(pr.p[7][i]);
        }
        for (int i = tid; i < H * H; i += NT) sm[S_W2 + i] = bf16r(pr.p[2][i]);
        for (int i = tid; i < H * HW; i += NT) sm[S_WM + i] = pr.p[4][i];
        for (int i = tid; i < H; i += NT) {
            sm[S_B1 + i] = pr.p[1][i];
            sm[S_B2 + i] = pr.p[3][i];
            sm[S_BV + i] = pr.p[8][i];
            sm[S_WV2 + i] = pr.p[9][i];
        }
        for (int i = tid; i < HW; i += NT) {
            sm[S_BM + i] = pr.p[5][i];
            sm[S_LS + i] = pr.p[6][i];
        }
        if (tid == 0) sm[S_BV2] = pr.p[10][0];
        for (int i = tid; i < P4; i += NT) sm[S_G + i] = 0.f;
    PHASE_END

    const int n_tiles = (dm.mb + T - 1) / T;
    for (int tile = block_id; tile < n_tiles; tile += grid) {
        const int q0 = tile * T;

        // Load the tile: sample q of the minibatch is column
        // perm[q / lb] * lb + q % lb.  The trunk only ever sees obs
        // rounded to bf16, so it is stored rounded.
        PHASE_BEGIN
            const int s = tid & (T - 1);
            const int q = q0 + s;
            const bool valid = q < dm.mb;
            long col = 0;
            if (valid) col = (long)perm[q / dm.lb] * dm.lb + q % dm.lb;
            const float mean_adv = stats[0], inv_std = stats[1];
            for (int row = tid / T; row < D; row += NT / T) {
                const float v = valid ? packed[(long)row * dm.n + col] : 0.f;
                if (row < OD) sm[S_OBS + row * TS + s] = bf16r(v);
                else if (row < OD + AW) sm[S_ACT + (row - OD) * TS + s] = v;
                else if (row == OD + AW) sm[S_LOGP + s] = v;
                else if (row == OD + AW + 1)
                    sm[S_ADV + s] = valid ? (v - mean_adv) * inv_std : 0.f;
                else if (row == OD + AW + 2) sm[S_RET + s] = v;
                else sm[S_MASK + (row - OD - AW - 3) * TS + s] = v;
            }
        PHASE_END

        // h1 = tanh(W1b' obs_b + b1), hv = tanh(Wvb' obs_b + bv)
        PHASE_BEGIN
            gemm_tile<H, OD, W_KM, false>(
                tid, sm + S_W1, sm + S_OBS, [&](int m, int s, const float* acc) {
                    for (int i = 0; i < 4; ++i)
                        sm[S_X1 + m * TS + s + i] = tanhf(acc[i] + sm[S_B1 + m]);
                });
            gemm_tile<H, OD, W_KM, false>(
                tid, sm + S_WV, sm + S_OBS, [&](int m, int s, const float* acc) {
                    for (int i = 0; i < 4; ++i)
                        sm[S_XV + m * TS + s + i] = tanhf(acc[i] + sm[S_BV + m]);
                });
        PHASE_END

        // h2 = tanh(W2b' h1_b + b2), value = Wv2' hv + bv2
        PHASE_BEGIN
            gemm_tile<H, H, W_KM, true>(
                tid, sm + S_W2, sm + S_X1, [&](int m, int s, const float* acc) {
                    for (int i = 0; i < 4; ++i)
                        sm[S_X2 + m * TS + s + i] = tanhf(acc[i] + sm[S_B2 + m]);
                });
            gemm_tile<1, H, W_KM, false>(
                tid, sm + S_WV2, sm + S_XV, [&](int, int s, const float* acc) {
                    for (int i = 0; i < 4; ++i)
                        sm[S_VAL + s + i] = acc[i] + sm[S_BV2];
                });
        PHASE_END

        // mean (or logits) = Wm' h2 + bm
        PHASE_BEGIN
            gemm_tile<HW, H, W_KM, false>(
                tid, sm + S_WM, sm + S_X2, [&](int m, int s, const float* acc) {
                    for (int i = 0; i < 4; ++i)
                        sm[S_MEAN + m * TS + s + i] = acc[i] + sm[S_BM + m];
                });
        PHASE_END

        PHASE_BEGIN
            if (tid < T) head(tid, q0 + tid < dm.mb, sm, dm);
        PHASE_END

        // Sums that need h2 and hv before they are overwritten.
        PHASE_BEGIN
            grad_acc<H, HW, false, false, false>(
                tid, sm + S_X2, sm + S_MEAN, sm + S_G + G_WM);
            grad_acc<H, 1, false, false, false>(
                tid, sm + S_XV, sm + S_VAL, sm + S_G + G_WV2);
            row_sums(tid, HW, sm + S_MEAN, sm + S_G + G_BM);
            row_sums(tid, 1, sm + S_VAL, sm + S_G + G_BV2);
            row_sums(tid, 3, sm + S_PG, sm + S_G + G_SUMS);
            if (!DISCRETE) row_sums(tid, AW, sm + S_DLS, sm + S_G + G_LS);
        PHASE_END

        // dz2 = (Wm dmean) (1 - h2^2) over h2; dzv = Wv2 dvalue (1 - hv^2)
        // over hv.
        PHASE_BEGIN
            gemm_tile<H, HW, W_MK, false>(
                tid, sm + S_WM, sm + S_MEAN, [&](int m, int s, const float* acc) {
                    for (int i = 0; i < 4; ++i) {
                        const float h = sm[S_X2 + m * TS + s + i];
                        sm[S_X2 + m * TS + s + i] = acc[i] * (1.0f - h * h);
                    }
                });
            for (int i = tid; i < H * T; i += NT) {
                const int m = i / T, s = i % T;
                const float h = sm[S_XV + m * TS + s];
                sm[S_XV + m * TS + s] =
                    sm[S_WV2 + m] * sm[S_VAL + s] * (1.0f - h * h);
            }
        PHASE_END

        PHASE_BEGIN
            row_sums(tid, H, sm + S_X2, sm + S_G + G_B2);
            row_sums(tid, H, sm + S_XV, sm + S_G + G_BV);
            grad_acc<H, H, true, true, false>(
                tid, sm + S_X1, sm + S_X2, sm + S_G + G_W2);
            grad_acc<H, OD, true, false, true>(
                tid, sm + S_XV, sm + S_OBS, sm + S_G + G_WV);
        PHASE_END

        // dz1 = (W2b dz2_b) (1 - h1^2) over h1
        PHASE_BEGIN
            gemm_tile<H, H, W_MK, true>(
                tid, sm + S_W2, sm + S_X2, [&](int m, int s, const float* acc) {
                    for (int i = 0; i < 4; ++i) {
                        const float h = sm[S_X1 + m * TS + s + i];
                        sm[S_X1 + m * TS + s + i] = acc[i] * (1.0f - h * h);
                    }
                });
        PHASE_END

        PHASE_BEGIN
            row_sums(tid, H, sm + S_X1, sm + S_G + G_B1);
            grad_acc<H, OD, true, false, true>(
                tid, sm + S_X1, sm + S_OBS, sm + S_G + G_W1);
        PHASE_END
    }

    PHASE_BEGIN
        for (int i = tid; i < P; i += NT)
            partial[(long)block_id * P + i] = sm[S_G + i];
    PHASE_END
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(NT, 1)
ppo_update_kernel(const float* __restrict__ packed, const int* __restrict__ perm,
                  const float* __restrict__ stats, const PPOParams pr,
                  float* __restrict__ partial, const PPODims dm) {
    extern __shared__ float4 smem4[];
    block_body(blockIdx.x, gridDim.x, reinterpret_cast<float*>(smem4), packed,
               perm, stats, pr, partial, dm);
}

// out[p] = sum over blocks, in block order.
__global__ void ppo_reduce_kernel(const float* __restrict__ partial, int grid,
                                  float* __restrict__ out) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= P) return;
    float sum = 0.f;
    for (int g = 0; g < grid; ++g) sum += partial[(long)g * P + p];
    out[p] = sum;
}
#endif

}  // namespace

// The length of the flat gradient vector, and the shared memory of a block,
// for the wrapper to hold against its own arithmetic.
extern "C" int vmt_ppo_p() { return P; }
extern "C" int vmt_ppo_smem_bytes() { return SMEM_BYTES; }

#ifdef __CUDACC__
// One minibatch: `grid` blocks write their sums to partial [grid, P], then
// out [P] gets their sum.  Returns the CUDA error of the launches (0: none).
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
    ppo_reduce_kernel<<<(P + 255) / 256, 256, 0, s>>>(partial, grid, out);
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
