// Flash attention for Hopper (sm_90a), bfloat16 operands (amp training):
// K1 forward (Tq > 1), K2 (fused backward), K3 (dq) and K4 (dk, dv).
//
// Replaces, in paddle_tpu/ops/pallas_attention.py, the kernels as the
// reference runs them under bf16 amp (its Pallas kernels are dtype
// generic):
//   K1  _kernel (:212, launched by _flash_forward :388)
//   K2  _bwd_fused_kernel (:513, launched by _flash_backward :677)
//   K3  _bwd_dq_kernel (:400, launched by _flash_backward :705)
//   K4  _bwd_dkv_kernel (:450, launched by _flash_backward :722)
// Same functions and the same roundings: every product takes bf16
// operands and accumulates in f32 (preferred_element_type); the forward
// rounds P to bf16 before P.V (:260) and O once at the end; K3 rounds
// dS = P * (dP - delta) to bf16 before dS.K (:440); K4 rounds P before
// P^T.dO (:498) and dS before dS^T.Q (:502); K2 rounds dS once (:570) for
// dS.K, dS^T.Q and P for P^T.dO (:575), and writes its per-kv-tile dq
// partials in f32 (:690), summed and cast once by the caller (:698). The
// softmax statistics, LSE and delta (computed by the caller from the
// bf16 dO and O) are f32. The masks are those of flash_attn_fwd.cu /
// flash_attn_bwd.cu: key column `col` of query row `row` is live when
// col < kv_len[b] and (not causal or col <= q_start[b] + row), q_start =
// 0 in the backward; a fully masked row gives O = 0 and LSE = -1e30, and
// a row whose LSE is that sentinel has P = 0 in the backward.
//
// What bounds them on an H100: at the training shape [8, 12, 1024, 64]
// causal, K1 does 2 products (12.9 GFLOP), K3 3 and K4 4 of 2 * D flops
// per live (row, key) pair: 13-26 us at the 989 TFLOP/s of dense bf16
// tensor cores, against 12-20 us of HBM bytes. K2 at [32, 12, 256, 64]
// does 5 (8.1 GFLOP, 8 us) against 27 us of bytes: bound by bytes.
//
// Design of K2 (mma.sync m16n8k16, bf16_mma.cuh). The TPU grid walks
// its reduction axis sequentially and keeps the accumulators in VMEM; on
// the card a block owns one 64-key output tile of one (batch, head) with
// 4 warps of 16 keys, and loops over the q rows itself in 64-row tiles,
// double-buffered in shared memory by cp.async (16 bytes a thread,
// zero-filled past the live range, so unwritten memory never enters a
// product): Q/dO tiles and their LSE / delta rows stream; K and V
// fragments live in registers; S^T = K.Q^T and dP^T = V.dO^T (keys x
// rows), then dV += P^T.dO and dK += dS^T.Q with P^T and dS^T as A
// fragments from registers and dO, Q read by ldmatrix.trans; dS^T,
// rounded, goes to shared memory, from which each warp reads 16 q rows of
// dS (ldmatrix.trans) for its rows' dq partial dS.K over the tile's 64
// keys.
//
// Design of K1, K3 and K4 (wgmma + TMA, hopper.cuh): see the sections
// below. A block is consumer warpgroups of 64 rows (K1: four, K3: two)
// or 64 keys (K4: two) and one producer warp; every product is a wgmma
// m64n64k16 with f32 accumulators, the first ones (S, and dP; or S^T and
// dP^T) from shared memory, the last ones with the rounded P / dS as
// register A fragments and the shared tile read MN-major (the
// descriptor's transpose bit), so no tile is copied or transposed: K1's
// O += P.V reads V as K3's dQ += dS.K reads K. The fixed operand (K1,
// K3: the block's Q rows) is loaded once and the streamed tiles by TMA
// through a ring of mbarrier stages. K1 and K3 start the blocks of the
// longest causal rows first; tiles wholly past the causal diagonal or
// kv_len are not loaded, and masks run only in the tiles that hold
// masked pairs. Head dims below 64 are zero-padded to 64 by the wrapper
// (ops/flash_attention.py).
//
// Interface: plain C, bound with ctypes; the arguments of the f32
// entries (flash_attn_fwd.cu, flash_attn_bwd.cu) with bf16 tensors (K2's
// dq partials f32). q/k/v/dO/O and the gradients are [B, n, T, D] bf16
// with arbitrary element strides for B, n and T (D contiguous, strides a
// multiple of 8, pointers 16-byte aligned: what cp.async and TMA need);
// lse and delta are contiguous f32 [B, n, Tq]. Returns cudaGetLastError()
// after the launch, -1 for a head dim other than 64 or Tq = 1 (the decode
// step has no bf16 kernel), -2 for an unknown kernel, -3 when
// cuTensorMapEncodeTiled refuses a tensor map.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "bf16_mma.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;     // keys of a K2 block's output tile
constexpr int kCols = 64;     // keys (or rows) of a streamed tile
constexpr int kThreads = 128;
constexpr float kNegSentinel = -1e30f;
constexpr float kDeadLse = -5e29f;  // half the forward's sentinel

// two bf16 at p (4-byte aligned) as one register
__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragments of a warp's 16 rows (r0 = 16 * warp + g, r1 = r0 + 8) of a
// [T, HD] operand read from global memory; rows >= valid are zero
template <int HD>
__device__ __forceinline__ void load_rows_a(uint32_t a[HD / 16][4],
                                            const bf16* base, long long st,
                                            int r0, int valid, int t) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = 16 * kk + 2 * t;
    const bool v0 = r0 < valid, v1 = r0 + 8 < valid;
    a[kk][0] = v0 ? ld_pair(base + r0 * st + c) : 0u;
    a[kk][1] = v1 ? ld_pair(base + (r0 + 8) * st + c) : 0u;
    a[kk][2] = v0 ? ld_pair(base + r0 * st + c + 8) : 0u;
    a[kk][3] = v1 ? ld_pair(base + (r0 + 8) * st + c + 8) : 0u;
  }
}

// stage rows c0 .. c0 + 63 of a [T, HD] operand into a [64][HD + 8]
// tile by cp.async; rows at or past `limit` are zero-filled
template <int HD>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* base,
                                           long long st, int c0,
                                           int limit) {
  constexpr int S = HD + 8, C8 = HD / 8;
  for (int i = threadIdx.x; i < kCols * C8; i += kThreads) {
    const int r = i / C8, c = 8 * (i % C8);
    const bool live = c0 + r < limit;
    const long long src = live ? c0 + r : 0;
    bf::cp_async16(dst + r * S + c, base + src * st + c, live);
  }
}

// S = A.B^T for a warp's 16 rows x the tile's 64 columns, where the
// tile is stored [col][HD] (K, V, Q or dO rows): s[nt] is columns 8nt..
template <int HD>
__device__ __forceinline__ void rows_x_tile(float s[8][4],
                                            const uint32_t a[HD / 16][4],
                                            const bf16* tile, int lane) {
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      bf::load_b_nk(b, tile, HD + 8, 16 * np, 16 * kk, lane);
      bf::mma(s[2 * np], a[kk], b);
      bf::mma(s[2 * np + 1], a[kk], b + 2);
    }
  }
}

// acc[dt] += P.T over the tile's 64 columns, where P is a warp's 16 x 64
// C fragments (rounded to bf16 here) and the tile is stored [col][HD]
template <int HD>
__device__ __forceinline__ void frag_x_tile(float acc[HD / 8][4],
                                            const float p[8][4],
                                            const bf16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {bf::pack(p[2 * kk][0], p[2 * kk][1]),
                           bf::pack(p[2 * kk][2], p[2 * kk][3]),
                           bf::pack(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           bf::pack(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      uint32_t b[4];
      bf::load_b_kn(b, tile, HD + 8, 16 * kk, 16 * dp, lane);
      bf::mma(acc[2 * dp], a, b);
      bf::mma(acc[2 * dp + 1], a, b + 2);
    }
  }
}

// write a warp's 16 x HD f32 fragments, times `mul`, as bf16 rows r0 and
// r0 + 8 (rows >= valid are skipped)
template <int HD>
__device__ __forceinline__ void store_rows(bf16* base, long long st,
                                           const float acc[HD / 8][4],
                                           float mul0, float mul1, int r0,
                                           int valid, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= valid) continue;
    const float mul = half ? mul1 : mul0;
    bf16* out = base + r * st + 2 * t;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
      *reinterpret_cast<uint32_t*>(out + 8 * dt) =
          bf::pack(acc[dt][2 * half] * mul, acc[dt][2 * half + 1] * mul);
  }
}

// -- K2, K3, K4: the backward ------------------------------------------------

constexpr int kD = 64;  // the backward's head dim
constexpr int kS = kD + 8;
constexpr int kTile = kCols * kS;

struct BwdArgs {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *delta;
  const int* kv_len;
  bf16 *dq, *dk, *dv;
  float* dq_part;            // K2: the f32 dq partials of the kv tiles
  int n, Tq, Tk;
  // element strides (batch, head, row) of q, k, v, dO, dq (K2: of one
  // kv tile's partial), dk, dv
  long long sq[3], sk[3], sv[3], sdo[3], sdq[3], sdk[3], sdv[3];
  long long dq_tile_stride;  // K2: elements between kv tiles' partials
  int causal;
  float scale;
};

// K2: dk, dv and the f32 dq partial of one 64-key kv tile of one
// (batch, head): K4's sweep over the q tiles, plus dQ_j = scale * dS.K
// of every q tile, written to the tile's partial. dS^T (bf16, the
// reference's rounding) goes through shared memory: each warp holds 16
// keys of it, and dS.K sums over all 64, so each warp then reads 16 q
// rows x 64 keys of it back as A fragments (ldmatrix.trans, no copy).
__global__ void __launch_bounds__(kThreads)
bwd_fused_bf16_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [2][row][kS]
  bf16* os = qs + 2 * kTile;                       // [2][row][kS]
  bf16* ks = os + 2 * kTile;                       // [key][kS]
  bf16* dss = ks + kTile;                          // dS^T [key][kS]
  float* lse_s = reinterpret_cast<float*>(dss + kTile);  // [2][64]
  float* delta_s = lse_s + 2 * kCols;                     // [2][64]

  const int bh = blockIdx.y, b = bh / a.n, h = bh % a.n;
  const int key0 = blockIdx.x * kRows;
  const int keys = min(kRows, a.Tk - key0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int klen = max(min(a.kv_len[b], a.Tk), 0);
  const int k0 = 16 * warp + g, k1 = k0 + 8;   // this lane's block keys
  const int key_a = key0 + k0, key_b = key0 + k1;

  float dk[kD / 8][4], dv[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  const int i0 = a.causal ? key0 / kCols : 0;
  const int nq = (a.Tq + kCols - 1) / kCols;
  const int n_tiles = key0 < klen ? max(nq - i0, 0) : 0;

  // q rows before the first live q tile get a zero partial (the
  // reference's dead blocks), every other row is written below
  float* part = a.dq_part + blockIdx.x * a.dq_tile_stride + b * a.sdq[0] +
                h * a.sdq[1];
  const int dead_rows = n_tiles > 0 ? min(i0 * kCols, a.Tq) : a.Tq;
  for (int i = threadIdx.x; i < dead_rows * (kD / 4); i += kThreads)
    reinterpret_cast<float4*>(part + (i / (kD / 4)) * a.sdq[2])[i % (kD / 4)] =
        make_float4(0.f, 0.f, 0.f, 0.f);

  const bf16* qb = a.q + b * a.sq[0] + h * a.sq[1];
  const bf16* ob = a.dout + b * a.sdo[0] + h * a.sdo[1];
  const float* lrow = a.lse + (long long)bh * a.Tq;
  const float* drow = a.delta + (long long)bh * a.Tq;
  auto load_tile = [&](int i, int stage) {
    const int row0 = i * kCols;
    stage_rows<kD>(qs + stage * kTile, qb, a.sq[2], row0, a.Tq);
    stage_rows<kD>(os + stage * kTile, ob, a.sdo[2], row0, a.Tq);
    if (threadIdx.x < kCols) {
      const int row = row0 + threadIdx.x;
      const bool in = row < a.Tq;
      bf::cp_async4(lse_s + stage * kCols + threadIdx.x,
                    lrow + (in ? row : 0), in);
      bf::cp_async4(delta_s + stage * kCols + threadIdx.x,
                    drow + (in ? row : 0), in);
    }
    bf::cp_async_commit();
  };
  if (n_tiles > 0) {
    // K for dS.K, zero past kv_len (a dead key's dS is 0, and 0 times
    // what lies there must not be NaN); in the first tile's group
    stage_rows<kD>(ks, a.k + b * a.sk[0] + h * a.sk[1], a.sk[2], key0,
                   klen);
    load_tile(i0, 0);
  }

  uint32_t ka[kD / 16][4], va[kD / 16][4];
  load_rows_a<kD>(ka, a.k + b * a.sk[0] + h * a.sk[1] + key0 * a.sk[2],
                  a.sk[2], k0, keys, t);
  load_rows_a<kD>(va, a.v + b * a.sv[0] + h * a.sv[1] + key0 * a.sv[2],
                  a.sv[2], k0, keys, t);
  const bool kl0 = key_a < klen, kl1 = key_b < klen;

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1, row0 = (i0 + it) * kCols;
    bf::cp_async_wait<0>();
    // tile it is visible; every warp is done with tile it - 1's stage
    // and with its dS^T
    __syncthreads();
    if (it + 1 < n_tiles) load_tile(i0 + it + 1, stage ^ 1);
    const bf16* qt = qs + stage * kTile;
    const bf16* ot = os + stage * kTile;
    const float* ls = lse_s + stage * kCols;
    const float* dls = delta_s + stage * kCols;

    // S^T = K.Q^T and dP^T = V.dO^T: this warp's 16 keys x 64 rows
    float st[8][4], dpt[8][4];
    rows_x_tile<kD>(st, ka, qt, lane);
    rows_x_tile<kD>(dpt, va, ot, lane);
    // P^T in st, dS^T in dpt
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int rl = 8 * nt + 2 * t + e, row = row0 + rl;
        const float l = ls[rl], dl = dls[rl];
        const bool ok = row < a.Tq && l > kDeadLse;
        const bool ok0 = ok && kl0 && (!a.causal || key_a <= row);
        const bool ok1 = ok && kl1 && (!a.causal || key_b <= row);
        const float p0 = ok0 ? expf(a.scale * st[nt][e] - l) : 0.f;
        const float p1 = ok1 ? expf(a.scale * st[nt][2 + e] - l) : 0.f;
        st[nt][e] = p0;
        st[nt][2 + e] = p1;
        dpt[nt][e] = p0 * (dpt[nt][e] - dl);
        dpt[nt][2 + e] = p1 * (dpt[nt][2 + e] - dl);
      }
    }
    // dV += P^T.dO and dK += dS^T.Q, P^T and dS^T rounded to bf16
    frag_x_tile<kD>(dv, st, ot, lane);
    frag_x_tile<kD>(dk, dpt, qt, lane);
    // dS^T, rounded to bf16, to shared memory: keys k0 / k1, rows 8nt + 2t
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      *reinterpret_cast<uint32_t*>(dss + k0 * kS + 8 * nt + 2 * t) =
          bf::pack(dpt[nt][0], dpt[nt][1]);
      *reinterpret_cast<uint32_t*>(dss + k1 * kS + 8 * nt + 2 * t) =
          bf::pack(dpt[nt][2], dpt[nt][3]);
    }
    __syncthreads();
    // dQ_j of this warp's 16 q rows = dS.K over the tile's 64 keys: dS's
    // A fragments from dS^T [key][row] by ldmatrix.trans, K's B
    // fragments from K [key][d] by ldmatrix.trans
    float dq[kD / 8][4];
#pragma unroll
    for (int i = 0; i < kD / 8; ++i)
      dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;
    const int blk = lane >> 3, rr = lane & 7;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t af[4];
      bf::ldsm_x4_t(af, dss + (16 * kk + rr + 8 * (blk >> 1)) * kS +
                            16 * warp + 8 * (blk & 1));
#pragma unroll
      for (int dp = 0; dp < kD / 16; ++dp) {
        uint32_t bfr[4];
        bf::load_b_kn(bfr, ks, kS, 16 * kk, 16 * dp, lane);
        bf::mma(dq[2 * dp], af, bfr);
        bf::mma(dq[2 * dp + 1], af, bfr + 2);
      }
    }
    // the f32 partial (the reference writes dq_part in f32)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + 16 * warp + g + 8 * half;
      if (row >= a.Tq) continue;
      float* out = part + row * a.sdq[2] + 2 * t;
#pragma unroll
      for (int dt = 0; dt < kD / 8; ++dt)
        *reinterpret_cast<float2*>(out + 8 * dt) =
            make_float2(dq[dt][2 * half] * a.scale,
                        dq[dt][2 * half + 1] * a.scale);
    }
  }
  store_rows<kD>(a.dk + b * a.sdk[0] + h * a.sdk[1] + key0 * a.sdk[2],
                 a.sdk[2], dk, a.scale, a.scale, k0, keys, t);
  store_rows<kD>(a.dv + b * a.sdv[0] + h * a.sdv[1] + key0 * a.sdv[2],
                 a.sdv[2], dv, 1.f, 1.f, k0, keys, t);
}

// -- K3 and K4 on wgmma + TMA ------------------------------------------------
//
// Warp-specialised blocks of three warpgroups: two consumers (64 q rows
// or 64 keys each, 128 a block) and a producer whose first warp issues
// every load. The block's fixed operand (K3: Q and dO of its 128 rows;
// K4: K and V of its 128 keys) is loaded once by TMA; the streamed one
// (K3: K / V tiles of 64 keys; K4: Q / dO tiles of 64 rows and their
// LSE / delta) runs through a ring of stages with full / empty
// mbarriers. Tiles are 64 x 64 bf16 boxes of 4-D tensor maps over
// (D, T, n, B) with the operands' own strides, 128-byte swizzled
// (hopper.cuh); rows past the tensor's end are zero-filled by TMA. A
// dead row (LSE sentinel, or past Tq) carries LSE +inf, so its P is
// exp2(-inf) = 0 without a test; keys past kv_len and the causal mask
// are masked on the fragments only in the tiles that have such pairs.
// Each consumer runs S (or S^T) and dP (dP^T) as two wgmma groups, the
// softmax on the first while the second runs, and leaves the products
// into dQ (dK, dV) in flight while it waits for the next tile: the stage
// they read is released once the next tile's first group has completed
// (groups complete in order).

constexpr int kWg = 128;                      // threads of a warpgroup
constexpr int kConsumers = 2;                 // consumer warpgroups
constexpr int kBlock = kConsumers * 64;       // rows or keys of a block
constexpr int kWsThreads = (kConsumers + 1) * kWg;
constexpr int kDqStages = 4;                  // K3: K / V tiles in flight
constexpr int kDkvStages = 3;                 // K4: Q / dO tiles in flight
constexpr int kBox = 64 * 64;                 // elements of one TMA box
constexpr uint32_t kBoxBytes = kBox * sizeof(bf16);
constexpr float kLog2e = 1.4426950408889634f;

struct alignas(1024) DqSmem {
  bf16 q[kConsumers * kBox];      // the block's rows, one box per consumer
  bf16 dout[kConsumers * kBox];
  bf16 k[kDqStages][kBox];        // streamed key tiles
  bf16 v[kDqStages][kBox];
  uint64_t qo_full, full[kDqStages], empty[kDqStages];
};

struct alignas(1024) DkvSmem {
  bf16 k[kConsumers * kBox];      // the block's keys, one box per consumer
  bf16 v[kConsumers * kBox];
  bf16 q[kDkvStages][kBox];       // streamed q-row tiles
  bf16 dout[kDkvStages][kBox];
  float lse2[kDkvStages][kCols];  // the rows' LSE * log2(e), +inf if dead
  float delta[kDkvStages][kCols];
  uint64_t kv_full, full[kDkvStages], empty[kDkvStages];
};

// a row's LSE in base 2 for p = exp2(s * scale * log2(e) - lse2); a dead
// row's is +inf (p = 0)
__device__ __forceinline__ float lse_base2(float lse) {
  return lse > kDeadLse ? lse * kLog2e : INFINITY;
}

// descriptor steps (the start address, in 16-byte units) between the
// four 16-wide slices of a tile's reduction: 32 bytes along a K-major
// row, 16 rows (2048 bytes) down an MN-major tile
constexpr uint64_t kKStep = 32 >> 4, kMnStep = (16 * kD * 2) >> 4;

// a 64 x 64 product over D: d = A.B^T, A and B tiles of 64 rows x D
__device__ __forceinline__ void tile_product(float (&d)[32], const bf16* a,
                                             const bf16* b) {
  const uint64_t da = hp::desc_sw128(a), db = hp::desc_sw128(b);
  hp::wgmma_ss<false>(d, da, db);
#pragma unroll
  for (int kk = 1; kk < kD / 16; ++kk)
    hp::wgmma_ss<true>(d, da + kk * kKStep, db + kk * kKStep);
}

// the register A fragments of a 64 x 64 accumulator, rounded to bf16,
// for the next product's four 16-wide slices of its columns
__device__ __forceinline__ void pack_a(uint32_t (&pa)[4][4],
                                       const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = bf::pack(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// d += A.B over 64: A from registers, B a 64 x D tile read MN-major
__device__ __forceinline__ void tile_product_rs(float (&d)[32],
                                                const uint32_t (&pa)[4][4],
                                                const bf16* b) {
  const uint64_t db = hp::desc_sw128(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) hp::wgmma_rs_t(d, pa[kk], db + kk * kMnStep);
}

// a warpgroup's 64 x D accumulator as bf16 rows r0 + (16w + g) (times
// mul_lo) and + 8 (times mul_hi) of `base` (rows >= valid skipped)
__device__ __forceinline__ void store_acc(bf16* base, long long st,
                                          const float (&d)[32], float mul_lo,
                                          float mul_hi, int r0, int valid) {
  const int w = (threadIdx.x & (kWg - 1)) >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 16 * w + g + 8 * half;
    if (r >= valid) continue;
    const float mul = half ? mul_hi : mul_lo;
    bf16* out = base + r * st + 2 * t;
#pragma unroll
    for (int nt = 0; nt < kD / 8; ++nt)
      *reinterpret_cast<uint32_t*>(out + 8 * nt) =
          bf::pack(d[4 * nt + 2 * half] * mul,
                   d[4 * nt + 2 * half + 1] * mul);
  }
}

// The consumers' release of ring stages: a stage is free once the last
// wgmma group reading it has completed. `held` is the stage whose
// second-product group is still in flight (-1: none).
struct StageRelease {
  int held = -1;
  // after a wait that completed the held group
  __device__ __forceinline__ void release(uint64_t* empty) {
    if (held >= 0) hp::mbar_arrive(&empty[held]);
    held = -1;
  }
  // a tile with nothing to compute: finish the held group, free both
  __device__ __forceinline__ void skip(uint64_t* empty, int s) {
    if (held >= 0) {
      hp::wgmma_wait<0>();
      release(empty);
    }
    hp::mbar_arrive(&empty[s]);
  }
};

// K1: O and LSE of one 256-row q block of one (batch, head): four
// consumer warpgroups of 64 rows (setmaxnreg 112: the 96 registers a
// thread of 640 gets at launch, plus what the producer's 24 free) and
// the producer warp, so each scheduler holds four consumer warps whose
// softmax latencies interleave (two and three, 128 and 192 rows a block,
// ran 8 % and 4 % slower at the training shape on an H100:
// tools/flash_ab.py). Each consumer warpgroup holds its 64 rows' O
// accumulator and running max / sum. Per K / V tile j it issues S_j =
// Q.K_j^T (SS wgmma) and then O += P_{j-1}.V_{j-1} (RS wgmma: P rounded
// to bf16 as the register A fragments, V read MN-major; the reference's
// p.astype(v.dtype), f32 accumulation), waits for S_j only and runs the
// online softmax of S_j on its registers while P_{j-1}.V_{j-1} is still
// in flight; then it waits for that product, frees its stage, scales O
// by the correction and packs P_j. So a warpgroup's softmax overlaps its
// own P.V as well as the other warpgroups' products (FlashAttention-3's
// intra-warpgroup overlap), and no register a product in flight reads
// is written.
struct FwdArgs {
  const int* kv_len;
  const int* q_start;
  bf16* o;
  float* lse;
  int n, Tq, Tk;
  long long so[3];             // O's element strides (batch, head, row)
  int causal;
  float scale;
};

constexpr int kFwdStages = 3;                 // K / V tiles in flight
constexpr int kFwdConsumers = 4;              // consumer warpgroups
constexpr int kFwdBlock = kFwdConsumers * 64; // q rows of a block
constexpr int kFwdThreads = (kFwdConsumers + 1) * kWg;

struct alignas(1024) FwdSmem {
  bf16 q[kFwdConsumers * kBox];   // the block's rows, one box per consumer
  bf16 k[kFwdStages][kBox];       // streamed key tiles
  bf16 v[kFwdStages][kBox];
  uint64_t q_full, full[kFwdStages], empty[kFwdStages];
};

__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const FwdArgs a) {
  FwdSmem& sm = hp::aligned_smem<FwdSmem>();
  const int bh = blockIdx.y, b = bh / a.n, h = bh % a.n;
  // the causal rows reach the most keys at the end: start those first
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kFwdBlock;
  const int rows = min(kFwdBlock, a.Tq - row0);
  const int klen = hp::warp_uniform(max(min(a.kv_len[b], a.Tk), 0));
  const int qoff = hp::warp_uniform(a.q_start[b]);
  // exclusive bound on the keys any row of the block attends to
  const int tile_limit =
      a.causal ? max(min(klen, qoff + row0 + rows), 0) : klen;
  const int n_tiles = (tile_limit + kCols - 1) / kCols;
  const int wg = hp::warp_uniform(threadIdx.x / kWg);

  if (threadIdx.x == 0) {
    hp::mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kFwdStages; ++s) {
      hp::mbar_init(&sm.full[s], 1);
      hp::mbar_init(&sm.empty[s], kFwdConsumers * kWg);
    }
    hp::mbar_init_fence();
  }
  __syncthreads();

  if (wg == kFwdConsumers) {                  // the producer
    hp::regs_dealloc<24>();
    if (threadIdx.x != kFwdConsumers * kWg || n_tiles == 0) return;
    hp::mbar_arrive_tx(&sm.q_full, kFwdConsumers * kBoxBytes);
    for (int c = 0; c < kFwdConsumers; ++c)
      hp::tma_load_4d(sm.q + c * kBox, &tq, &sm.q_full, 0, row0 + 64 * c, h,
                      b);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kFwdStages;
      if (j >= kFwdStages)
        hp::mbar_wait(&sm.empty[s], (j / kFwdStages - 1) & 1);
      hp::mbar_arrive_tx(&sm.full[s], 2 * kBoxBytes);
      hp::tma_load_4d(sm.k[s], &tk, &sm.full[s], 0, j * kCols, h, b);
      hp::tma_load_4d(sm.v[s], &tv, &sm.full[s], 0, j * kCols, h, b);
    }
    return;
  }

  hp::regs_alloc<112>();                      // a consumer: 64 q rows
  const int w = (threadIdx.x & (kWg - 1)) >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rbase = row0 + 64 * wg;
  const int ra = rbase + 16 * w + g, rb = ra + 8;   // this thread's rows
  // exclusive bounds on the live keys of rows ra, rb, and of the
  // warpgroup's rows (tiles at or past it are dead for all of them)
  const int lim_a = a.causal ? max(min(klen, qoff + ra + 1), 0) : klen;
  const int lim_b = a.causal ? max(min(klen, qoff + rb + 1), 0) : klen;
  const int wg_limit =
      rbase >= a.Tq ? 0
                    : (a.causal ? max(min(klen, qoff + rbase + 64), 0) : klen);
  const int n_live = min(n_tiles, (wg_limit + kCols - 1) / kCols);
  const float sl2 = a.scale * kLog2e;

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY;     // running raw max (quad-shared)
  float l_a = 0.f, l_b = 0.f;                 // this thread's share of sums
  const bf16* qt = sm.q + wg * kBox;
  float sc[32];
  uint32_t pa[4][4];
  float corr_a = 0.f, corr_b = 0.f;

  // the online softmax of tile j's scores in sc (in base 2: exp2 of
  // s * scale * log2(e) minus the running max's), masked only in tiles
  // with masked pairs; leaves P (f32) in sc and O's corrections for rows
  // a and b in corr_a, corr_b
  auto softmax = [&](int j) {
    const int c0 = j * kCols;
    if ((a.causal && c0 + 63 > qoff + rbase) || c0 + 64 > klen) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = c0 + 8 * (i >> 2) + 2 * t + (i & 1);
        if (col >= (((i >> 1) & 1) ? lim_b : lim_a)) sc[i] = -INFINITY;
      }
    }
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if ((i >> 1) & 1)
        mx_b = fmaxf(mx_b, sc[i]);
      else
        mx_a = fmaxf(mx_a, sc[i]);
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, x));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, x));
    }
    // a row with no live key yet keeps max -inf: exponents against 0
    const float base_a = mx_a == -INFINITY ? 0.f : mx_a * sl2;
    const float base_b = mx_b == -INFINITY ? 0.f : mx_b * sl2;
    corr_a = hp::exp2_approx(m_a * sl2 - base_a);
    corr_b = hp::exp2_approx(m_b * sl2 - base_b);
    m_a = mx_a;
    m_b = mx_b;
    l_a *= corr_a;
    l_b *= corr_b;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool hi = (i >> 1) & 1;
      sc[i] = hp::exp2_approx(fmaf(sc[i], sl2, -(hi ? base_b : base_a)));
      if (hi)
        l_b += sc[i];                         // the f32 P sums, as K1's l
      else
        l_a += sc[i];
    }
  };
  // O *= the last softmax's corrections (O holds the products of the
  // tiles before its tile)
  auto rescale_o = [&]() {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= ((i >> 1) & 1) ? corr_b : corr_a;
  };

  if (n_live > 0) {
    hp::mbar_wait(&sm.q_full, 0);
    hp::mbar_wait(&sm.full[0], 0);
    hp::wgmma_fence();
    tile_product(sc, qt, sm.k[0]);            // S_0 = Q.K_0^T
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_acc(sc);
    softmax(0);
    pack_a(pa, sc);                           // P rounded to bf16
    // tile j: S_j, then P_{j-1}.V_{j-1}; the softmax of S_j runs while
    // that product does; O is rescaled and P_j packed once it is done
    for (int j = 1; j < n_live; ++j) {
      const int s = j % kFwdStages, sp = (j - 1) % kFwdStages;
      hp::mbar_wait(&sm.full[s], (j / kFwdStages) & 1);
      hp::wgmma_fence();
      tile_product(sc, qt, sm.k[s]);          // S_j = Q.K_j^T
      hp::wgmma_commit();
      tile_product_rs(o, pa, sm.v[sp]);       // O += P_{j-1}.V_{j-1}
      hp::wgmma_commit();
      hp::wgmma_wait<1>();                    // S_j
      hp::fence_acc(sc);
      softmax(j);
      hp::wgmma_wait<0>();                    // P_{j-1}.V_{j-1}
      hp::mbar_arrive(&sm.empty[sp]);
      hp::fence_acc(o);
      rescale_o();
      pack_a(pa, sc);
    }
    const int sl = (n_live - 1) % kFwdStages;
    hp::wgmma_fence();
    tile_product_rs(o, pa, sm.v[sl]);         // the last P.V
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::mbar_arrive(&sm.empty[sl]);
    hp::fence_acc(o);
  }
  // tiles past this warpgroup's rows: free their stages
  for (int j = max(n_live, 0); j < n_tiles; ++j) {
    const int s = j % kFwdStages;
    hp::mbar_wait(&sm.full[s], (j / kFwdStages) & 1);
    hp::mbar_arrive(&sm.empty[s]);
  }
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, x);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, x);
  }
  // a fully masked row keeps max -inf: O = 0 and the LSE sentinel
  const bool dead_a = m_a == -INFINITY, dead_b = m_b == -INFINITY;
  store_acc(a.o + b * a.so[0] + h * a.so[1], a.so[2], o,
            dead_a ? 0.f : 1.f / l_a, dead_b ? 0.f : 1.f / l_b, rbase, a.Tq);
  if (t == 0) {
    float* lrow = a.lse + (long long)bh * a.Tq;
    if (ra < a.Tq) lrow[ra] = dead_a ? kNegSentinel : m_a * a.scale + logf(l_a);
    if (rb < a.Tq) lrow[rb] = dead_b ? kNegSentinel : m_b * a.scale + logf(l_b);
  }
}

// K3: dq of one 128-row q block of one (batch, head)
__global__ void __launch_bounds__(kWsThreads, 1)
bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const BwdArgs a) {
  DqSmem& sm = hp::aligned_smem<DqSmem>();
  const int bh = blockIdx.y, b = bh / a.n, h = bh % a.n;
  // the causal rows reach the most keys at the end: start those first
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kBlock;
  const int rows = min(kBlock, a.Tq - row0);
  const int klen = hp::warp_uniform(max(min(a.kv_len[b], a.Tk), 0));
  const int tile_limit = a.causal ? min(klen, row0 + rows) : klen;
  const int n_tiles = (tile_limit + kCols - 1) / kCols;
  const int wg = hp::warp_uniform(threadIdx.x / kWg);

  if (threadIdx.x == 0) {
    hp::mbar_init(&sm.qo_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
      hp::mbar_init(&sm.full[s], 1);
      hp::mbar_init(&sm.empty[s], kConsumers * kWg);
    }
    hp::mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {                     // the producer
    hp::regs_dealloc<24>();
    if (threadIdx.x != kConsumers * kWg || n_tiles == 0) return;
    hp::mbar_arrive_tx(&sm.qo_full, 2 * kConsumers * kBoxBytes);
    for (int c = 0; c < kConsumers; ++c) {
      hp::tma_load_4d(sm.q + c * kBox, &tq, &sm.qo_full, 0, row0 + 64 * c,
                      h, b);
      hp::tma_load_4d(sm.dout + c * kBox, &tdo, &sm.qo_full, 0,
                      row0 + 64 * c, h, b);
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kDqStages;
      if (j >= kDqStages)
        hp::mbar_wait(&sm.empty[s], (j / kDqStages - 1) & 1);
      hp::mbar_arrive_tx(&sm.full[s], 2 * kBoxBytes);
      hp::tma_load_4d(sm.k[s], &tk, &sm.full[s], 0, j * kCols, h, b);
      hp::tma_load_4d(sm.v[s], &tv, &sm.full[s], 0, j * kCols, h, b);
    }
    return;
  }

  hp::regs_alloc<240>();                      // a consumer: 64 q rows
  const int w = (threadIdx.x & (kWg - 1)) >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rbase = row0 + 64 * wg;
  const int ra = rbase + 16 * w + g, rb = ra + 8;   // this thread's rows
  // keys past this warpgroup's limit are dead for all of its rows
  const int wg_limit =
      rbase >= a.Tq ? 0 : (a.causal ? min(klen, rbase + 64) : klen);
  const float* lrow = a.lse + (long long)bh * a.Tq;
  const float* drow = a.delta + (long long)bh * a.Tq;
  const float la = ra < a.Tq ? lse_base2(lrow[ra]) : INFINITY;
  const float lb = rb < a.Tq ? lse_base2(lrow[rb]) : INFINITY;
  const float dla = ra < a.Tq ? drow[ra] : 0.f;
  const float dlb = rb < a.Tq ? drow[rb] : 0.f;
  const float sl2 = a.scale * kLog2e;

  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  if (n_tiles > 0) hp::mbar_wait(&sm.qo_full, 0);
  const bf16* qt = sm.q + wg * kBox;
  const bf16* ot = sm.dout + wg * kBox;
  StageRelease rel;
  uint32_t da[4][4];

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kDqStages, c0 = j * kCols;
    hp::mbar_wait(&sm.full[s], (j / kDqStages) & 1);
    if (c0 >= wg_limit) {                     // warpgroup-uniform
      rel.skip(sm.empty, s);
      continue;
    }
    float sc[32], dp[32];
    hp::wgmma_fence();
    tile_product(sc, qt, sm.k[s]);            // S = Q.K^T
    hp::wgmma_commit();
    tile_product(dp, ot, sm.v[s]);            // dP = dO.V^T
    hp::wgmma_commit();
    hp::wgmma_wait<1>();                      // the last dQ group and S
    rel.release(sm.empty);
    hp::fence_acc(sc);
    // P on S's fragments while dP finishes; masks only where a pair of
    // the tile is past kv_len or the causal diagonal
    if ((a.causal && c0 + 63 > rbase) || c0 + 64 > klen) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = c0 + 8 * (i >> 2) + 2 * t + (i & 1);
        const bool lo = ((i >> 1) & 1) == 0;
        const bool ok = col < klen && (!a.causal || col <= (lo ? ra : rb));
        sc[i] = ok ? hp::exp2_approx(fmaf(sc[i], sl2, -(lo ? la : lb))) : 0.f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        sc[i] = hp::exp2_approx(fmaf(sc[i], sl2, -(((i >> 1) & 1) ? lb : la)));
    }
    hp::wgmma_wait<0>();
    hp::fence_acc(dp);
    // dS = P * (dP - delta), rounded to bf16 (the reference's
    // ds.astype(k.dtype)) as the A fragments of dQ += dS.K
#pragma unroll
    for (int i = 0; i < 32; ++i)
      dp[i] = sc[i] * (dp[i] - (((i >> 1) & 1) ? dlb : dla));
    pack_a(da, dp);
    hp::wgmma_fence();
    tile_product_rs(dq, da, sm.k[s]);         // K read MN-major
    hp::wgmma_commit();
    rel.held = s;
  }
  hp::wgmma_wait<0>();
  rel.release(sm.empty);
  hp::fence_acc(dq);
  store_acc(a.dq + b * a.sdq[0] + h * a.sdq[1], a.sdq[2], dq, a.scale,
            a.scale, rbase, a.Tq);
}

// K4: dk, dv of one 128-key kv block of one (batch, head)
__global__ void __launch_bounds__(kWsThreads, 1)
bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const BwdArgs a) {
  DkvSmem& sm = hp::aligned_smem<DkvSmem>();
  const int bh = blockIdx.y, b = bh / a.n, h = bh % a.n;
  const int key0 = blockIdx.x * kBlock;
  const int klen = hp::warp_uniform(max(min(a.kv_len[b], a.Tk), 0));
  // causal: q tiles before the one holding key0 never attend to the block
  const int i0 = a.causal ? key0 / kCols : 0;
  const int nq = (a.Tq + kCols - 1) / kCols;
  // a block wholly past kv_len gets zero gradients
  const int n_tiles = key0 < klen ? max(nq - i0, 0) : 0;
  const int wg = hp::warp_uniform(threadIdx.x / kWg);

  if (threadIdx.x == 0) {
    hp::mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < kDkvStages; ++s) {
      hp::mbar_init(&sm.full[s], 32);         // the producer warp's lanes
      hp::mbar_init(&sm.empty[s], kConsumers * kWg);
    }
    hp::mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {                     // the producer
    hp::regs_dealloc<24>();
    const int lane = threadIdx.x & 31;
    if (threadIdx.x / 32 != kConsumers * 4 || n_tiles == 0) return;
    if (lane == 0) {
      hp::mbar_arrive_tx(&sm.kv_full, 2 * kConsumers * kBoxBytes);
      for (int c = 0; c < kConsumers; ++c) {
        hp::tma_load_4d(sm.k + c * kBox, &tk, &sm.kv_full, 0, key0 + 64 * c,
                        h, b);
        hp::tma_load_4d(sm.v + c * kBox, &tv, &sm.kv_full, 0, key0 + 64 * c,
                        h, b);
      }
    }
    const float* lrow = a.lse + (long long)bh * a.Tq;
    const float* drow = a.delta + (long long)bh * a.Tq;
    // each lane carries rows lane and lane + 32 of the next tile's
    // statistics, read before the wait for a free stage
    float l2[2], dl[2];
    auto fetch = [&](int it) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int row = (i0 + it) * kCols + lane + 32 * k;
        l2[k] = row < a.Tq ? lse_base2(lrow[row]) : INFINITY;
        dl[k] = row < a.Tq ? drow[row] : 0.f;
      }
    };
    fetch(0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kDkvStages, row0 = (i0 + it) * kCols;
      if (it >= kDkvStages)
        hp::mbar_wait(&sm.empty[s], (it / kDkvStages - 1) & 1);
      if (lane == 0) {
        hp::mbar_expect_tx(&sm.full[s], 2 * kBoxBytes);
        hp::tma_load_4d(sm.q[s], &tq, &sm.full[s], 0, row0, h, b);
        hp::tma_load_4d(sm.dout[s], &tdo, &sm.full[s], 0, row0, h, b);
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        sm.lse2[s][lane + 32 * k] = l2[k];
        sm.delta[s][lane + 32 * k] = dl[k];
      }
      hp::mbar_arrive(&sm.full[s]);
      if (it + 1 < n_tiles) fetch(it + 1);
    }
    return;
  }

  hp::regs_alloc<240>();                      // a consumer: 64 keys
  const int w = (threadIdx.x & (kWg - 1)) >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kbase = key0 + 64 * wg;
  const int ka = kbase + 16 * w + g, kb = ka + 8;   // this thread's keys
  const bool wg_live = kbase < klen;
  const float sl2 = a.scale * kLog2e;

  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  if (n_tiles > 0) hp::mbar_wait(&sm.kv_full, 0);
  const bf16* kt = sm.k + wg * kBox;
  const bf16* vt = sm.v + wg * kBox;
  StageRelease rel;
  uint32_t pa[4][4], da[4][4];

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kDkvStages, row0 = (i0 + it) * kCols;
    hp::mbar_wait(&sm.full[s], (it / kDkvStages) & 1);
    // causal: a tile wholly before this warpgroup's first key is dead
    if (!wg_live || (a.causal && row0 + kCols <= kbase)) {
      rel.skip(sm.empty, s);
      continue;
    }
    float st[32], dpt[32];
    hp::wgmma_fence();
    tile_product(st, kt, sm.q[s]);            // S^T = K.Q^T
    hp::wgmma_commit();
    tile_product(dpt, vt, sm.dout[s]);        // dP^T = V.dO^T
    hp::wgmma_commit();
    // the last tile's dV and dK groups, and S^T
    hp::wgmma_wait<1>();
    rel.release(sm.empty);
    hp::fence_acc(st);
    const float2* ls = reinterpret_cast<const float2*>(sm.lse2[s]);
    const float2* dls = reinterpret_cast<const float2*>(sm.delta[s]);
    // P^T on S^T's fragments (keys x rows) while dP^T finishes; masks
    // only where a pair of the tile is past kv_len or the diagonal
    if ((a.causal && row0 < kbase + 63) || kbase + 64 > klen) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float2 l = ls[4 * nt + t];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = 4 * nt + c, row = row0 + 8 * nt + 2 * t + (c & 1);
          const int key = c < 2 ? ka : kb;
          const bool ok = key < klen && (!a.causal || key <= row);
          st[i] = ok ? hp::exp2_approx(fmaf(st[i], sl2, -((c & 1) ? l.y : l.x))) : 0.f;
        }
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float2 l = ls[4 * nt + t];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          st[4 * nt + c] =
              hp::exp2_approx(fmaf(st[4 * nt + c], sl2, -((c & 1) ? l.y : l.x)));
      }
    }
    // dV += P^T.dO with P^T rounded to bf16 as register A fragments and
    // dO read MN-major, in flight while dS is formed
    pack_a(pa, st);
    hp::wgmma_fence();
    tile_product_rs(dv, pa, sm.dout[s]);
    hp::wgmma_commit();
    hp::wgmma_wait<1>();                      // dP^T
    hp::fence_acc(dpt);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 d = dls[4 * nt + t];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        dpt[4 * nt + c] =
            st[4 * nt + c] * (dpt[4 * nt + c] - ((c & 1) ? d.y : d.x));
    }
    // dK += dS^T.Q, dS^T rounded to bf16, Q read MN-major
    pack_a(da, dpt);
    hp::wgmma_fence();
    tile_product_rs(dk, da, sm.q[s]);
    hp::wgmma_commit();
    rel.held = s;
  }
  hp::wgmma_wait<0>();
  rel.release(sm.empty);
  hp::fence_acc(dv);
  hp::fence_acc(dk);
  store_acc(a.dk + b * a.sdk[0] + h * a.sdk[1], a.sdk[2], dk, a.scale,
            a.scale, kbase, a.Tk);
  store_acc(a.dv + b * a.sdv[0] + h * a.sdv[1], a.sdv[2], dv, 1.f, 1.f,
            kbase, a.Tk);
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, int smem, cudaStream_t stream,
                   Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// the 4-D map over (D, T, n, B) of a [B, n, T, 64] bf16 operand with
// element strides st = (batch, head, row), boxes of 64 rows x 64,
// 128-byte swizzle, zero fill past T; false if the encoder refuses it
bool make_map(CUtensorMap* map, const void* base, int B, int n, int T,
              const long long* st) {
  hp::EncodeTiled encode = hp::encode_tiled();
  if (encode == nullptr) return false;
  if (B == 0 || n == 0 || T == 0) {   // nothing is ever loaded from it
    *map = CUtensorMap{};
    return true;
  }
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kD),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(B)};
  // a dimension of extent 1 is never stepped: any legal stride will do
  const long long per[3] = {st[2], n > 1 ? st[1] : 8, B > 1 ? st[0] : 8};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)
    strides[i] = static_cast<cuuint64_t>(per[i]) * sizeof(bf16);
  const cuuint32_t box[4] = {kD, 64, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Smem, typename Kernel>
cudaError_t launch_ws(Kernel kernel, dim3 grid, cudaStream_t stream,
                      const CUtensorMap (&maps)[4], const BwdArgs& a) {
  const int smem = static_cast<int>(sizeof(Smem)) + 1024;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kWsThreads, smem, stream>>>(maps[0], maps[1], maps[2],
                                             maps[3], a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pt_flash_attn_fwd_bf16(
    const void* q, const void* k, const void* v, const void* kv_len,
    const void* q_start, void* o, void* lse, int B, int n, int Tq, int Tk,
    int D, long long sqb, long long sqh, long long sqt, long long skb,
    long long skh, long long skt, long long svb, long long svh,
    long long svt, long long sob, long long soh, long long sot, int causal,
    float scale, void* stream) {
  if (Tq < 2 || D != kD) return -1;
  const long long sq[3] = {sqb, sqh, sqt}, sk[3] = {skb, skh, skt},
                  sv[3] = {svb, svh, svt};
  FwdArgs a;
  a.kv_len = static_cast<const int*>(kv_len);
  a.q_start = static_cast<const int*>(q_start);
  a.o = static_cast<bf16*>(o);
  a.lse = static_cast<float*>(lse);
  a.n = n;
  a.Tq = Tq;
  a.Tk = Tk;
  a.so[0] = sob;
  a.so[1] = soh;
  a.so[2] = sot;
  a.causal = causal;
  a.scale = scale;
  CUtensorMap maps[3];
  if (!make_map(&maps[0], q, B, n, Tq, sq) ||
      !make_map(&maps[1], k, B, n, Tk, sk) ||
      !make_map(&maps[2], v, B, n, Tk, sv))
    return -3;
  const int smem = static_cast<int>(sizeof(FwdSmem)) + 1024;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_bf16_kernel<<<dim3((Tq + kFwdBlock - 1) / kFwdBlock, B * n),
                          kFwdThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], a);
  return static_cast<int>(cudaGetLastError());
}

// which: 0 = K2 (fused; dq is the f32 [nk, ...] partials buffer),
// 1 = K3 (dq), 2 = K4 (dk, dv). strides: 22 long longs — (batch, head,
// row) element strides of q, k, v, dO, dq, dk, dv, then K2's element
// stride between kv tiles' partials.
extern "C" int pt_flash_attn_bwd_bf16(
    int which, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* delta,
    const void* kv_len, void* dq, void* dk, void* dv, int B, int n, int Tq,
    int Tk, int D, const long long* strides, int causal, float scale,
    void* stream) {
  if (D != kD) return -1;
  BwdArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.kv_len = static_cast<const int*>(kv_len);
  a.dq = which == 0 ? nullptr : static_cast<bf16*>(dq);
  a.dq_part = which == 0 ? static_cast<float*>(dq) : nullptr;
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.n = n;
  a.Tq = Tq;
  a.Tk = Tk;
  long long* dsts[7] = {a.sq, a.sk, a.sv, a.sdo, a.sdq, a.sdk, a.sdv};
  for (int t = 0; t < 7; ++t)
    for (int i = 0; i < 3; ++i) dsts[t][i] = strides[3 * t + i];
  a.dq_tile_stride = strides[21];
  a.causal = causal;
  a.scale = scale;
  auto s = static_cast<cudaStream_t>(stream);
  if (which == 0) {
    const int nk = (Tk + kRows - 1) / kRows;
    const int smem = (6 * kTile) * static_cast<int>(sizeof(bf16)) +
                     4 * kCols * static_cast<int>(sizeof(float));
    return static_cast<int>(
        launch(bwd_fused_bf16_kernel, dim3(nk, B * n), smem, s, a));
  }
  if (which != 1 && which != 2) return -2;
  CUtensorMap maps[4];
  if (!make_map(&maps[0], q, B, n, Tq, a.sq) ||
      !make_map(&maps[1], k, B, n, Tk, a.sk) ||
      !make_map(&maps[2], v, B, n, Tk, a.sv) ||
      !make_map(&maps[3], dout, B, n, Tq, a.sdo))
    return -3;
  if (which == 1)
    return static_cast<int>(launch_ws<DqSmem>(
        bwd_dq_bf16_kernel, dim3((Tq + kBlock - 1) / kBlock, B * n), s, maps,
        a));
  return static_cast<int>(launch_ws<DkvSmem>(
      bwd_dkv_bf16_kernel, dim3((Tk + kBlock - 1) / kBlock, B * n), s, maps,
      a));
}
