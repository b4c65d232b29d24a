// Flash attention for Hopper (sm_90a), bfloat16 operands (amp training):
// K1 forward (Tq > 1), K3 (dq) and K4 (dk, dv).
//
// Replaces, in paddle_tpu/ops/pallas_attention.py, the kernels as the
// reference runs them under bf16 amp (its Pallas kernels are dtype
// generic):
//   K1  _kernel (:212, launched by _flash_forward :388)
//   K3  _bwd_dq_kernel (:400, launched by _flash_backward :705)
//   K4  _bwd_dkv_kernel (:450, launched by _flash_backward :722)
// Same functions and the same roundings: every product takes bf16
// operands and accumulates in f32 (preferred_element_type); the forward
// rounds P to bf16 before P.V (:260) and O once at the end; K3 rounds
// dS = P * (dP - delta) to bf16 before dS.K (:440); K4 rounds P before
// P^T.dO (:498) and dS before dS^T.Q (:502). The softmax statistics,
// LSE and delta (computed by the caller from the bf16 dO and O) are f32.
// The masks are those of flash_attn_fwd.cu / flash_attn_bwd.cu: key
// column `col` of query row `row` is live when col < kv_len[b] and (not
// causal or col <= q_start[b] + row), q_start = 0 in the backward; a
// fully masked row gives O = 0 and LSE = -1e30, and a row whose LSE is
// that sentinel has P = 0 in the backward.
//
// What bounds them on an H100: at the training shape [8, 12, 1024, 64]
// causal, K1 does 2 products (12.9 GFLOP), K3 3 and K4 4 of 2 * D flops
// per live (row, key) pair: 13-26 us at the 989 TFLOP/s of dense bf16
// tensor cores, against 12-20 us of HBM bytes. Both bounds are close;
// what limits these simple kernels is the mma.sync throughput and
// the softmax arithmetic between the products (wgmma and a ring of TMA
// loads are later work).
//
// Design. The TPU grid walks its reduction axis sequentially and keeps
// the accumulators in VMEM; on the card a block owns one 64-row output
// tile of one (batch, head) with 4 warps of 16 rows, and loops over the
// reduction axis itself in 64-wide tiles, double-buffered in shared
// memory by cp.async (16 bytes a thread, zero-filled past the live
// range, so unwritten memory never enters a product):
//   K1  block = 64 query rows; K/V tiles stream; Q's A fragments live in
//       registers; S = Q.K^T and the online softmax on the C fragments;
//       P, packed to bf16, is the A fragment of P.V without leaving the
//       registers (bf16_mma.cuh); V's B fragments come from ldmatrix.trans.
//   K3  block = 64 query rows; K/V tiles stream; Q and dO fragments in
//       registers; S and dP = dO.V^T, then dS, then dQ += dS.K with K
//       read by ldmatrix.trans.
//   K4  block = 64 keys, each warp 16 keys; Q/dO tiles and their LSE /
//       delta rows stream; K and V fragments in registers; S^T = K.Q^T
//       and dP^T = V.dO^T (keys x rows), then dV += P^T.dO and
//       dK += dS^T.Q with P^T and dS^T as A fragments from registers and
//       dO, Q read by ldmatrix.trans.
// No tile is copied twice for a transposed use: 16-bit ldmatrix.trans
// delivers the transposed fragments. Tiles wholly past the causal
// diagonal or kv_len are not loaded; the ragged edge is masked on the
// fragments; K1 and K3 start the blocks of the longest causal rows
// first.
//
// Interface: plain C, bound with ctypes; the arguments of the f32
// entries (flash_attn_fwd.cu, flash_attn_bwd.cu) with bf16 tensors.
// q/k/v/dO/O and the gradients are [B, n, T, D] bf16 with arbitrary
// element strides for B, n and T (D contiguous, strides a multiple of 8,
// pointers 16-byte aligned); lse and delta are contiguous f32 [B, n, Tq].
// Returns cudaGetLastError() after the launch, -1 for an unsupported
// head dim or Tq = 1 (the decode step has no bf16 kernel), -2 for a
// kernel this file does not have (the fused K2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "bf16_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;     // rows (or keys) of a block's output tile
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

// -- K1: the forward ---------------------------------------------------------

template <int HD>
constexpr int fwd_smem_bytes() {
  return 4 * kCols * (HD + 8) * static_cast<int>(sizeof(bf16));
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const int* __restrict__ kv_len,
                      const int* __restrict__ q_start, bf16* __restrict__ o,
                      float* __restrict__ lse, int n, int Tq, int Tk,
                      long long sqb, long long sqh, long long sqt,
                      long long skb, long long skh, long long skt,
                      long long svb, long long svh, long long svt,
                      long long sob, long long soh, long long sot,
                      int causal, float scale) {
  constexpr int kTile = kCols * (HD + 8);
  constexpr int DT = HD / 8;           // n-tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // [2][key][HD + 8]
  bf16* vs = ks + 2 * kTile;                       // [2][key][HD + 8]

  const int h = blockIdx.y, b = blockIdx.z;
  // the causal rows reach the most keys at the end: start those first
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int rows = min(kRows, Tq - row0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int klen = min(kv_len[b], Tk);
  const int qoff = q_start[b];
  // exclusive bound on the live keys of block row r (monotone in r)
  auto row_limit = [&](int r) {
    int lim = klen;
    if (causal) lim = min(lim, qoff + row0 + r + 1);
    return max(lim, 0);
  };
  const int tile_limit = row_limit(rows - 1);
  const int r0 = 16 * warp + g, r1 = r0 + 8;  // this lane's block rows
  const int lim0 = row_limit(r0), lim1 = row_limit(r1);
  const int warp_limit =
      16 * warp < rows ? row_limit(min(16 * warp + 15, rows - 1)) : 0;

  const bf16* kb = k + b * skb + h * skh;
  const bf16* vb = v + b * svb + h * svh;
  auto load_tile = [&](int j, int stage) {
    stage_rows<HD>(ks + stage * kTile, kb, skt, j * kCols, tile_limit);
    stage_rows<HD>(vs + stage * kTile, vb, svt, j * kCols, tile_limit);
    bf::cp_async_commit();
  };
  const int n_tiles = (tile_limit + kCols - 1) / kCols;
  if (n_tiles > 0) load_tile(0, 0);

  uint32_t qa[HD / 16][4];
  load_rows_a<HD>(qa, q + b * sqb + h * sqh + row0 * sqt, sqt, r0, rows, t);

  float m0 = -INFINITY, m1 = -INFINITY;  // running row max (quad-shared)
  float l0 = 0.f, l1 = 0.f;              // this lane's share of the sum
  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    bf::cp_async_wait<0>();
    // tile j is visible, and every warp is done with tile j - 1's stage
    __syncthreads();
    if (j + 1 < n_tiles) load_tile(j + 1, stage ^ 1);
    const int c0 = j * kCols;
    if (c0 >= warp_limit) continue;  // warp-uniform: no live key here

    float s[8][4];
    rows_x_tile<HD>(s, qa, ks + stage * kTile, lane);

    // mask, scale and the online softmax on the fragments
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * nt + 2 * t + e;
        s[nt][e] = col < lim0 ? s[nt][e] * scale : -INFINITY;
        s[nt][2 + e] = col < lim1 ? s[nt][2 + e] * scale : -INFINITY;
        mx0 = fmaxf(mx0, s[nt][e]);
        mx1 = fmaxf(mx1, s[nt][2 + e]);
      }
    }
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o2));
    }
    // a row with no live key yet keeps max -inf: exponents against 0
    const float base0 = mx0 == -INFINITY ? 0.f : mx0;
    const float base1 = mx1 == -INFINITY ? 0.f : mx1;
    const float corr0 = expf(m0 - base0), corr1 = expf(m1 - base1);
    m0 = mx0;
    m1 = mx1;
    l0 *= corr0;
    l1 *= corr1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = expf(s[nt][0] - base0);
      s[nt][1] = expf(s[nt][1] - base0);
      s[nt][2] = expf(s[nt][2] - base1);
      s[nt][3] = expf(s[nt][3] - base1);
      l0 += s[nt][0] + s[nt][1];   // the f32 P sums, as K1's l
      l1 += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      acc[i][0] *= corr0;
      acc[i][1] *= corr0;
      acc[i][2] *= corr1;
      acc[i][3] *= corr1;
    }
    // O += P.V with P rounded to bf16 (the reference's p.astype(v.dtype))
    frag_x_tile<HD>(acc, s, vs + stage * kTile, lane);
  }

#pragma unroll
  for (int o2 = 1; o2 <= 2; o2 <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o2);
  }
  // a fully masked row keeps max -inf: O = 0 and the LSE sentinel
  const bool dead0 = m0 == -INFINITY, dead1 = m1 == -INFINITY;
  store_rows<HD>(o + b * sob + h * soh + row0 * sot, sot, acc,
                 dead0 ? 0.f : 1.f / l0, dead1 ? 0.f : 1.f / l1, r0, rows,
                 t);
  if (t == 0) {
    float* lrow = lse + ((long long)b * n + h) * Tq + row0;
    if (r0 < rows) lrow[r0] = dead0 ? kNegSentinel : m0 + logf(l0);
    if (r1 < rows) lrow[r1] = dead1 ? kNegSentinel : m1 + logf(l1);
  }
}

// -- K3, K4: the backward ----------------------------------------------------

constexpr int kD = 64;  // the backward's head dim
constexpr int kS = kD + 8;
constexpr int kTile = kCols * kS;

struct BwdArgs {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *delta;
  const int* kv_len;
  bf16 *dq, *dk, *dv;
  int n, Tq, Tk;
  // element strides (batch, head, row) of q, k, v, dO, dq, dk, dv
  long long sq[3], sk[3], sv[3], sdo[3], sdq[3], sdk[3], sdv[3];
  int causal;
  float scale;
};

// K3: dq of one 64-row q tile of one (batch, head)
__global__ void __launch_bounds__(kThreads)
bwd_dq_bf16_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // [2][key][kS]
  bf16* vs = ks + 2 * kTile;                       // [2][key][kS]

  const int bh = blockIdx.y, b = bh / a.n, h = bh % a.n;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int rows = min(kRows, a.Tq - row0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int klen = max(min(a.kv_len[b], a.Tk), 0);
  const int tile_limit = a.causal ? min(klen, row0 + rows) : klen;
  const int warp_limit =
      a.causal ? min(klen, row0 + min(16 * warp + 16, rows)) : klen;
  const int r0 = 16 * warp + g, r1 = r0 + 8;
  const int row_a = row0 + r0, row_b = row0 + r1;

  const bf16* kb = a.k + b * a.sk[0] + h * a.sk[1];
  const bf16* vb = a.v + b * a.sv[0] + h * a.sv[1];
  auto load_tile = [&](int j, int stage) {
    stage_rows<kD>(ks + stage * kTile, kb, a.sk[2], j * kCols, tile_limit);
    stage_rows<kD>(vs + stage * kTile, vb, a.sv[2], j * kCols, tile_limit);
    bf::cp_async_commit();
  };
  const int n_tiles = (tile_limit + kCols - 1) / kCols;
  if (n_tiles > 0) load_tile(0, 0);

  uint32_t qa[kD / 16][4], oa[kD / 16][4];
  load_rows_a<kD>(qa, a.q + b * a.sq[0] + h * a.sq[1] + row0 * a.sq[2],
                  a.sq[2], r0, rows, t);
  load_rows_a<kD>(oa, a.dout + b * a.sdo[0] + h * a.sdo[1] +
                          row0 * a.sdo[2], a.sdo[2], r0, rows, t);
  const float* lrow = a.lse + (long long)bh * a.Tq;
  const float* drow = a.delta + (long long)bh * a.Tq;
  const float l0 = r0 < rows ? lrow[row_a] : kNegSentinel;
  const float l1 = r1 < rows ? lrow[row_b] : kNegSentinel;
  const float dl0 = r0 < rows ? drow[row_a] : 0.f;
  const float dl1 = r1 < rows ? drow[row_b] : 0.f;
  const bool live0 = l0 > kDeadLse, live1 = l1 > kDeadLse;

  float acc[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    bf::cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < n_tiles) load_tile(j + 1, stage ^ 1);
    const int c0 = j * kCols;
    if (c0 >= warp_limit) continue;  // warp-uniform: no live key here
    const bf16* kt = ks + stage * kTile;

    float s[8][4], dp[8][4];
    rows_x_tile<kD>(s, qa, kt, lane);
    rows_x_tile<kD>(dp, oa, vs + stage * kTile, lane);
    // dS = P * (dP - delta) in the S fragments
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * nt + 2 * t + e;
        const bool ok = col < klen;
        const bool ok0 = ok && live0 && (!a.causal || col <= row_a);
        const bool ok1 = ok && live1 && (!a.causal || col <= row_b);
        const float p0 = ok0 ? expf(a.scale * s[nt][e] - l0) : 0.f;
        const float p1 = ok1 ? expf(a.scale * s[nt][2 + e] - l1) : 0.f;
        s[nt][e] = p0 * (dp[nt][e] - dl0);
        s[nt][2 + e] = p1 * (dp[nt][2 + e] - dl1);
      }
    }
    // dQ += dS.K, dS rounded to bf16 (the reference's ds.astype(k.dtype))
    frag_x_tile<kD>(acc, s, kt, lane);
  }
  store_rows<kD>(a.dq + b * a.sdq[0] + h * a.sdq[1] + row0 * a.sdq[2],
                 a.sdq[2], acc, a.scale, a.scale, r0, rows, t);
}

// K4: dk, dv of one 64-key kv tile of one (batch, head)
__global__ void __launch_bounds__(kThreads)
bwd_dkv_bf16_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [2][row][kS]
  bf16* os = qs + 2 * kTile;                       // [2][row][kS]
  float* lse_s = reinterpret_cast<float*>(os + 2 * kTile);  // [2][64]
  float* delta_s = lse_s + 2 * kCols;                        // [2][64]

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

  // causal: q rows before this tile's first key never attend to it
  const int i0 = a.causal ? key0 / kCols : 0;
  const int nq = (a.Tq + kCols - 1) / kCols;
  // a tile wholly past kv_len gets zero gradients
  const int n_tiles = key0 < klen ? max(nq - i0, 0) : 0;

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
  if (n_tiles > 0) load_tile(i0, 0);

  uint32_t ka[kD / 16][4], va[kD / 16][4];
  load_rows_a<kD>(ka, a.k + b * a.sk[0] + h * a.sk[1] + key0 * a.sk[2],
                  a.sk[2], k0, keys, t);
  load_rows_a<kD>(va, a.v + b * a.sv[0] + h * a.sv[1] + key0 * a.sv[2],
                  a.sv[2], k0, keys, t);
  const bool kl0 = key_a < klen, kl1 = key_b < klen;

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1, row0 = (i0 + it) * kCols;
    bf::cp_async_wait<0>();
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
  }
  store_rows<kD>(a.dk + b * a.sdk[0] + h * a.sdk[1] + key0 * a.sdk[2],
                 a.sdk[2], dk, a.scale, a.scale, k0, keys, t);
  store_rows<kD>(a.dv + b * a.sdv[0] + h * a.sdv[1] + key0 * a.sdv[2],
                 a.sdv[2], dv, 1.f, 1.f, k0, keys, t);
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

template <int HD>
cudaError_t launch_fwd(const bf16* q, const bf16* k, const bf16* v,
                       const int* kv_len, const int* q_start, bf16* o,
                       float* lse, int B, int n, int Tq, int Tk,
                       const long long* st, int causal, float scale,
                       cudaStream_t stream) {
  const dim3 grid((Tq + kRows - 1) / kRows, n, B);
  return launch(flash_fwd_bf16_kernel<HD>, grid, fwd_smem_bytes<HD>(),
                stream, q, k, v, kv_len, q_start, o, lse, n, Tq, Tk, st[0],
                st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
                st[9], st[10], st[11], causal, scale);
}

}  // namespace

extern "C" int pt_flash_attn_fwd_bf16(
    const void* q, const void* k, const void* v, const void* kv_len,
    const void* q_start, void* o, void* lse, int B, int n, int Tq, int Tk,
    int D, long long sqb, long long sqh, long long sqt, long long skb,
    long long skh, long long skt, long long svb, long long svh,
    long long svt, long long sob, long long soh, long long sot, int causal,
    float scale, void* stream) {
  if (Tq < 2) return -1;
  const long long st[12] = {sqb, sqh, sqt, skb, skh, skt,
                            svb, svh, svt, sob, soh, sot};
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  const auto* lp = static_cast<const int*>(kv_len);
  const auto* sp = static_cast<const int*>(q_start);
  auto* op = static_cast<bf16*>(o);
  auto* lsep = static_cast<float*>(lse);
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return static_cast<int>(launch_fwd<32>(qp, kp, vp, lp, sp, op, lsep,
                                             B, n, Tq, Tk, st, causal, scale,
                                             s));
    case 64:
      return static_cast<int>(launch_fwd<64>(qp, kp, vp, lp, sp, op, lsep,
                                             B, n, Tq, Tk, st, causal, scale,
                                             s));
    default:
      return -1;
  }
}

// which: 1 = K3 (dq), 2 = K4 (dk, dv); 0 (the fused K2) has no bf16
// kernel. strides: 22 long longs — (batch, head, row) element strides of
// q, k, v, dO, dq, dk, dv, then one unused (the f32 K2's partial stride).
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
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.n = n;
  a.Tq = Tq;
  a.Tk = Tk;
  long long* dsts[7] = {a.sq, a.sk, a.sv, a.sdo, a.sdq, a.sdk, a.sdv};
  for (int t = 0; t < 7; ++t)
    for (int i = 0; i < 3; ++i) dsts[t][i] = strides[3 * t + i];
  a.causal = causal;
  a.scale = scale;
  auto s = static_cast<cudaStream_t>(stream);
  const int nq = (Tq + kRows - 1) / kRows, nk = (Tk + kRows - 1) / kRows;
  const int tiles = 4 * kTile * static_cast<int>(sizeof(bf16));
  switch (which) {
    case 1:
      return static_cast<int>(
          launch(bwd_dq_bf16_kernel, dim3(nq, B * n), tiles, s, a));
    case 2:
      return static_cast<int>(launch(
          bwd_dkv_bf16_kernel, dim3(nk, B * n),
          tiles + 4 * kCols * static_cast<int>(sizeof(float)), s, a));
    default:
      return -2;
  }
}
