// Flash-attention backward for Hopper (sm_90a), float32: K2, K3 and K4.
//
// Replaces, in paddle_tpu/ops/pallas_attention.py (launched by
// _flash_backward's pl.pallas_call):
//   K2  _bwd_fused_kernel (:513)  one sweep over the q tiles of one kv
//                                 tile: dk, dv and per-kv-tile dq
//                                 partials;
//   K3  _bwd_dq_kernel (:400)     dq of one q tile, a sweep over kv
//                                 tiles;
//   K4  _bwd_dkv_kernel (:450)    dk, dv of one kv tile, a sweep over q
//                                 tiles.
// Same function as the TPU kernels: probabilities are rebuilt from the
// forward's saved log-sum-exp, p = exp(scale * q.k - lse), with
// dp = dO.V^T and ds = p * (dp - delta), delta = rowsum(dO * O) computed
// by the caller; dq = scale * ds.K, dk = scale * ds^T.Q, dv = p^T.dO.
// Key column `col` of query row `row` is live when
//     col < kv_len[b]  and  (not causal or col <= row),
// and a row whose lse is the -1e30 sentinel (fully masked in the
// forward) has p = 0. Tiles wholly past the causal diagonal or past
// kv_len are skipped, as the TPU kernels skip them.
//
// What bounds it on an H100: the five T x T x D products (four per q/kv
// tile pair in K4, three in K3; K2 does all five in one sweep) are
// 2 * D flops per live (row, key) pair each. At [8, 12, 1024, 64] causal
// K2's are 32 GFLOP: 0.48 ms at 67 TFLOP/s of f32 FMA, 0.195 ms at the
// 165 TFLOP/s of 3xTF32 on the tensor cores (tf32_mma.cuh); the bytes
// (q, k, v, dO, lse, delta in, dq, dk, dv out) are ~0.06 ms. So K2 is
// bound by tensor-core operations.
//
// Design of K2 (bwd_fused_tc_kernel). The TPU grid walks its reduction
// axis sequentially and keeps the accumulators in VMEM scratch; on the
// card blocks run in parallel, so a block owns one 64-key kv tile of one
// (batch, head) and loops over the q tiles itself:
//   * K and V are staged once by cp.async and stay resident in shared
//     memory, K also transposed (so dS.K reads it along its rows); the
//     Q and dO tiles and their lse / delta rows are double-buffered by
//     cp.async: q tile i + 1 loads while tile i is computed;
//   * all five products are 3xTF32 mma.sync m16n8k8 with f32
//     accumulation. 8 warps; for each product a warp owns a 16 x 32
//     block of the 64 x 64 output and runs the whole 64-deep reduction.
//     S = Q.K^T and dP = dO.V^T are rows x keys; P and dS are built on
//     those fragments and go through shared memory (2 x 17 KB), from
//     which dV^T += dO^T.P and dK^T += Q^T.dS (d x keys) read them down
//     the rows, and dQ_part = dS.K (rows x d) along them. dV^T and dK^T
//     stay in register fragments across the sweep, each q tile's part
//     summed in a fresh fragment and added in f32 (tf32_mma.cuh);
//   * no tile is copied twice for its transposed use: a product that
//     needs an operand transposed reads the same padded tile down its
//     rows, with the paired labelling, conflict-free (tf32_mma.cuh);
//     wgmma would need its tf32 operands K-major, so these products
//     would need transposed copies of Q, dO, P and dS;
//   * operands are split into hi/lo as a warp loads its fragment, so
//     the tiles stay f32 (157 KB of shared memory, one block of 8 warps
//     an SM);
//   * dq across kv tiles: per-kv-tile partials written to dq_part[j] and
//     summed by the caller afterwards (the TPU kernel's way), not
//     atomics: the sum order is fixed, so K2 is deterministic.
//
// K3 and K4 (bwd_dq_kernel, bwd_dkv_kernel): each block owns one output
// tile and loops over the reduction axis itself, with its accumulators
// in registers: 64 x 64 tiles (D = 64 only), 256 threads as 16 x 16,
// each thread owning a 4 x 4 sub-tile of every 64 x 64 product, the
// reduction read from shared memory as float4 pairs; operands staged in
// the layout each product reads (row-major, or transposed with the
// reduction index outer): K3 uses 96 KB, K4 128 KB. Plain f32 FMAs with
// expf (no fast math).
//
// Interface: plain C, bound with ctypes. q/k/v/dO and the gradients are
// [B, n, T, D] float32 with arbitrary element strides for B, n and T (D
// contiguous, strides a multiple of 4, pointers 16-byte aligned: what a
// 16-byte cp.async needs), so the packed [B, T, n*D] planes pass as head
// views without a copy; lse and delta are contiguous [B, n, Tq]. Returns
// cudaGetLastError() after the launch, -1 for an unsupported head dim, -2
// for an unknown kernel.

#include <cuda_runtime.h>
#include <math.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kT = 64;         // rows of a q tile and of a kv tile
constexpr int kD = 64;         // head dim
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kTile = kT * kD; // floats in one staged tile
constexpr float kDeadLse = -5e29f;  // half the forward's -1e30 sentinel

struct BwdArgs {
  const float *q, *k, *v, *dout, *lse, *delta;
  const int* kv_len;
  float *dq, *dk, *dv;
  int n, Tq, Tk;
  // element strides (batch, head, row) of q, k, v, dO, dq, dk, dv
  long long sq[3], sk[3], sv[3], sdo[3], sdq[3], sdk[3], sdv[3];
  long long dq_tile_stride;  // K2: elements between kv tiles' dq partials
  int causal;
  float scale;
};

// dst[r * 64 + d] = row t0 + r of a [T, 64] operand (zero past T)
__device__ __forceinline__ void load_rows(float* dst, const float* base,
                                          long long st, int t0, int T) {
  for (int idx = threadIdx.x; idx < kT * (kD / 4); idx += kThreads) {
    const int r = idx >> 4, c4 = idx & 15;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t0 + r < T)
      val = reinterpret_cast<const float4*>(base + (t0 + r) * st)[c4];
    reinterpret_cast<float4*>(dst)[r * (kD / 4) + c4] = val;
  }
}

// dst[d * 64 + r] = element d of row t0 + r (the transposed tile)
__device__ __forceinline__ void load_cols(float* dst, const float* base,
                                          long long st, int t0, int T) {
  for (int idx = threadIdx.x; idx < kT * (kD / 4); idx += kThreads) {
    const int r = idx & (kT - 1), c4 = idx >> 6;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t0 + r < T)
      val = reinterpret_cast<const float4*>(base + (t0 + r) * st)[c4];
    dst[(4 * c4 + 0) * kT + r] = val.x;
    dst[(4 * c4 + 1) * kT + r] = val.y;
    dst[(4 * c4 + 2) * kT + r] = val.z;
    dst[(4 * c4 + 3) * kT + r] = val.w;
  }
}

// acc[i][j] += sum_k A[k * 64 + ty * 4 + i] * B[k * 64 + tx * 4 + j]:
// one thread's 4 x 4 share of a 64 x 64 x 64 product whose operands are
// stored with the reduction index outer
__device__ __forceinline__ void mma64(float acc[4][4], const float* A,
                                      const float* B, int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < 64; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(A + k * 64 + ty * 4);
    const float4 b = *reinterpret_cast<const float4*>(B + k * 64 + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// p and ds of one (q tile at row0, kv tile at col0) pair for this
// thread's rows ty*4+i and columns tx*4+j; lse_s/delta_s hold the q
// tile's rows
__device__ __forceinline__ void probs(const BwdArgs& a, float s[4][4],
                                      float dp[4][4],
                                      const float* lse_s,
                                      const float* delta_s, int row0,
                                      int col0, int klen, int ty, int tx,
                                      float p[4][4], float ds[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rl = ty * 4 + i, row = row0 + rl;
    const float l = lse_s[rl], dl = delta_s[rl];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx * 4 + j;
      const bool live = col < klen && (!a.causal || col <= row) &&
                        l > kDeadLse;
      p[i][j] = live ? expf(a.scale * s[i][j] - l) : 0.f;
      ds[i][j] = p[i][j] * (dp[i][j] - dl);
    }
  }
}

// lse and delta of the q tile at row0 (rows past Tq: dead)
__device__ __forceinline__ void load_row_stats(const BwdArgs& a, int bh,
                                               int row0, float* lse_s,
                                               float* delta_s) {
  if (threadIdx.x < kT) {
    const int row = row0 + threadIdx.x;
    const bool in = row < a.Tq;
    lse_s[threadIdx.x] = in ? a.lse[(long long)bh * a.Tq + row] : -1e30f;
    delta_s[threadIdx.x] = in ? a.delta[(long long)bh * a.Tq + row] : 0.f;
  }
}

__device__ __forceinline__ int key_limit(const BwdArgs& a, int b) {
  return max(min(a.kv_len[b], a.Tk), 0);
}

// K3: dq of one q tile (blockIdx.x) of one (batch, head) (blockIdx.y)
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  float* qt = sm;               // [d][r]
  float* dot = qt + kTile;      // [d][r]
  float* kt = dot + kTile;      // [d][c]
  float* vt = kt + kTile;       // [d][c]
  float* kr = vt + kTile;       // [c][d]
  float* dst = kr + kTile;      // [c][r]
  float* lse_s = dst + kTile;
  float* delta_s = lse_s + kT;

  const int bh = blockIdx.y, b = bh / a.n, h = bh % a.n;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int row0 = blockIdx.x * kT;
  const int klen = key_limit(a, b);
  int limit = klen;
  if (a.causal) limit = min(limit, min(row0 + kT, a.Tq));

  load_cols(qt, a.q + b * a.sq[0] + h * a.sq[1], a.sq[2], row0, a.Tq);
  load_cols(dot, a.dout + b * a.sdo[0] + h * a.sdo[1], a.sdo[2], row0,
            a.Tq);
  load_row_stats(a, bh, row0, lse_s, delta_s);

  float acc[4][4];
  zero(acc);
  const float* kb = a.k + b * a.sk[0] + h * a.sk[1];
  const float* vb = a.v + b * a.sv[0] + h * a.sv[1];
  for (int col0 = 0; col0 < limit; col0 += kT) {
    __syncthreads();  // the previous tile's readers are done
    load_cols(kt, kb, a.sk[2], col0, a.Tk);
    load_cols(vt, vb, a.sv[2], col0, a.Tk);
    load_rows(kr, kb, a.sk[2], col0, a.Tk);
    __syncthreads();
    float s[4][4], dp[4][4], p[4][4], ds[4][4];
    zero(s);
    zero(dp);
    mma64(s, qt, kt, ty, tx);
    mma64(dp, dot, vt, ty, tx);
    probs(a, s, dp, lse_s, delta_s, row0, col0, klen, ty, tx, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[(tx * 4 + j) * kT + ty * 4 + i] = ds[i][j];
    __syncthreads();
    mma64(acc, dst, kr, ty, tx);
  }
  float* out = a.dq + b * a.sdq[0] + h * a.sdq[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= a.Tq) continue;
    float4 val = make_float4(a.scale * acc[i][0], a.scale * acc[i][1],
                             a.scale * acc[i][2], a.scale * acc[i][3]);
    reinterpret_cast<float4*>(out + row * a.sdq[2])[tx] = val;
  }
}

// K4: dk, dv of one kv tile (blockIdx.x) of one (batch, head)
// (blockIdx.y)
__global__ void __launch_bounds__(kThreads)
bwd_dkv_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  float* kt = sm;               // [d][c]
  float* vt = kt + kTile;       // [d][c]
  float* qt = vt + kTile;       // [d][r]
  float* dot = qt + kTile;      // [d][r]
  float* qr = dot + kTile;      // [r][d]
  float* dor = qr + kTile;      // [r][d]
  float* pr = dor + kTile;      // [r][c]
  float* dsr = pr + kTile;      // [r][c]
  float* lse_s = dsr + kTile;
  float* delta_s = lse_s + kT;

  const int bh = blockIdx.y, b = bh / a.n, h = bh % a.n;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int col0 = blockIdx.x * kT;
  const int klen = key_limit(a, b);
  const int nq = (a.Tq + kT - 1) / kT;
  const bool block_live = col0 < klen;
  // causal: q tile i reaches key col0 only when its last row >= col0
  const int i_first = a.causal ? col0 / kT : 0;

  const float* kb = a.k + b * a.sk[0] + h * a.sk[1];
  const float* vb = a.v + b * a.sv[0] + h * a.sv[1];
  const float* qb = a.q + b * a.sq[0] + h * a.sq[1];
  const float* dob = a.dout + b * a.sdo[0] + h * a.sdo[1];
  if (block_live) {
    load_cols(kt, kb, a.sk[2], col0, a.Tk);
    load_cols(vt, vb, a.sv[2], col0, a.Tk);
  }

  float dk[4][4], dv[4][4];
  zero(dk);
  zero(dv);
  for (int it = 0; it < nq; ++it) {
    const int row0 = it * kT;
    const bool live = block_live && it >= i_first;
    if (!live) continue;
    __syncthreads();  // the previous q tile's readers are done
    load_cols(qt, qb, a.sq[2], row0, a.Tq);
    load_cols(dot, dob, a.sdo[2], row0, a.Tq);
    load_rows(qr, qb, a.sq[2], row0, a.Tq);
    load_rows(dor, dob, a.sdo[2], row0, a.Tq);
    load_row_stats(a, bh, row0, lse_s, delta_s);
    __syncthreads();
    float s[4][4], dp[4][4], p[4][4], ds[4][4];
    zero(s);
    zero(dp);
    mma64(s, qt, kt, ty, tx);     // rows ty*4+i, keys tx*4+j
    mma64(dp, dot, vt, ty, tx);
    probs(a, s, dp, lse_s, delta_s, row0, col0, klen, ty, tx, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      reinterpret_cast<float4*>(pr + r * kT)[tx] =
          make_float4(p[i][0], p[i][1], p[i][2], p[i][3]);
      reinterpret_cast<float4*>(dsr + r * kT)[tx] =
          make_float4(ds[i][0], ds[i][1], ds[i][2], ds[i][3]);
    }
    __syncthreads();
    mma64(dv, pr, dor, ty, tx);   // keys ty*4+i, head columns tx*4+j
    mma64(dk, dsr, qr, ty, tx);
  }
  float* dkb = a.dk + b * a.sdk[0] + h * a.sdk[1];
  float* dvb = a.dv + b * a.sdv[0] + h * a.sdv[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = col0 + ty * 4 + i;
    if (col >= a.Tk) continue;
    reinterpret_cast<float4*>(dkb + col * a.sdk[2])[tx] =
        make_float4(a.scale * dk[i][0], a.scale * dk[i][1],
                    a.scale * dk[i][2], a.scale * dk[i][3]);
    reinterpret_cast<float4*>(dvb + col * a.sdv[2])[tx] =
        make_float4(dv[i][0], dv[i][1], dv[i][2], dv[i][3]);
  }
}

// K2: dk, dv of one kv tile (blockIdx.x) of one (batch, head)
// (blockIdx.y) and the tile's dq partial of every q tile (zeros for the
// dead ones); 8 warps, 3xTF32 mma.sync, Q/dO double-buffered by cp.async
constexpr int kS = kD + 4;            // padded row stride (floats)
constexpr int kPadTile = kT * kS;     // floats in a padded tile
constexpr int kFusedThreads = 256;
// K, K^T, V; Q and dO x 2 stages; P, dS; lse and delta x 2 stages
constexpr size_t kFusedSmem =
    sizeof(float) * (9 * kPadTile + 4 * kT);

__global__ void __launch_bounds__(kFusedThreads)
bwd_fused_tc_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  float* k_s = sm;                    // [key][d]
  float* kt_s = k_s + kPadTile;       // [d][key]
  float* v_s = kt_s + kPadTile;       // [key][d]
  float* q_s = v_s + kPadTile;        // [2][row][d]
  float* do_s = q_s + 2 * kPadTile;   // [2][row][d]
  float* p_s = do_s + 2 * kPadTile;   // [row][key]
  float* ds_s = p_s + kPadTile;       // [row][key]
  float* lse_s = ds_s + kPadTile;     // [2][row]
  float* delta_s = lse_s + 2 * kT;    // [2][row]

  const int bh = blockIdx.y, b = bh / a.n, h = bh % a.n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = 16 * (warp & 3);     // 16 rows (S, dP, dQ) or d (dV, dK)
  const int wc = 32 * (warp >> 2);    // 32 keys (S, dP, dV, dK) or d (dQ)
  const int col0 = blockIdx.x * kT;
  const int klen = key_limit(a, b);
  const int nq = (a.Tq + kT - 1) / kT;
  // first live q tile: none for a tile past kv_len; causal: q tile i
  // reaches key col0 only when its last row >= col0
  const int i_first = col0 >= klen ? nq : (a.causal ? col0 / kT : 0);

  float* part = a.dq + blockIdx.x * a.dq_tile_stride + b * a.sdq[0] +
                h * a.sdq[1];
  // a dead pair's dq partial is zero
  const int dead_rows = min(i_first * kT, a.Tq);
  for (int i = threadIdx.x; i < dead_rows * (kD / 4); i += kFusedThreads)
    reinterpret_cast<float4*>(part + (i >> 4) * a.sdq[2])[i & 15] =
        make_float4(0.f, 0.f, 0.f, 0.f);

  const float* kb = a.k + b * a.sk[0] + h * a.sk[1];
  const float* vb = a.v + b * a.sv[0] + h * a.sv[1];
  const float* qb = a.q + b * a.sq[0] + h * a.sq[1];
  const float* dob = a.dout + b * a.sdo[0] + h * a.sdo[1];
  const float* lseb = a.lse + (long long)bh * a.Tq;
  const float* deltab = a.delta + (long long)bh * a.Tq;
  auto load_q_tile = [&](int it, int stage) {
    const int row0 = it * kT;
    float* qd = q_s + stage * kPadTile;
    float* dod = do_s + stage * kPadTile;
    for (int i = threadIdx.x; i < kT * (kD / 4); i += kFusedThreads) {
      const int r = i >> 4, c = 4 * (i & 15);
      const bool live = row0 + r < a.Tq;
      const long long src = live ? row0 + r : 0;
      tc::cp_async16(qd + r * kS + c, qb + src * a.sq[2] + c, live);
      tc::cp_async16(dod + r * kS + c, dob + src * a.sdo[2] + c, live);
    }
    if (threadIdx.x < kT) {
      const int r = threadIdx.x;
      const bool live = row0 + r < a.Tq;
      const int src = live ? row0 + r : 0;
      tc::cp_async4(lse_s + stage * kT + r, lseb + src, live);
      tc::cp_async4(delta_s + stage * kT + r, deltab + src, live);
    }
    tc::cp_async_commit();
  };

  float dv_acc[4][4], dk_acc[4][4];   // dV^T, dK^T: d x keys fragments
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv_acc[i][e] = dk_acc[i][e] = 0.f;

  if (i_first < nq) {
    // K and V, zero past kv_len (a dead key's dS and P are 0, and 0 times
    // whatever lies there must not be NaN)
    for (int i = threadIdx.x; i < kT * (kD / 4); i += kFusedThreads) {
      const int r = i >> 4, c = 4 * (i & 15);
      const bool live = col0 + r < klen;
      const long long src = live ? col0 + r : 0;
      tc::cp_async16(k_s + r * kS + c, kb + src * a.sk[2] + c, live);
      tc::cp_async16(v_s + r * kS + c, vb + src * a.sv[2] + c, live);
    }
    tc::cp_async_commit();
    load_q_tile(i_first, 0);
    tc::cp_async_wait<1>();           // K and V have landed
    __syncthreads();
    for (int i = threadIdx.x; i < kT * kD; i += kFusedThreads) {
      const int key = i & (kT - 1), d = i >> 6;
      kt_s[d * kS + key] = k_s[key * kS + d];
    }
  }

  for (int it = i_first; it < nq; ++it) {
    const int stage = (it - i_first) & 1;
    tc::cp_async_wait<0>();
    // tile it (and K^T) is visible, and every warp is done with tile
    // it - 1's stage and with P / dS
    __syncthreads();
    if (it + 1 < nq) load_q_tile(it + 1, stage ^ 1);
    const int row0 = it * kT;
    const float* qs = q_s + stage * kPadTile;
    const float* dos = do_s + stage * kPadTile;

    // S = Q.K^T and dP = dO.V^T: rows wr.., keys wc.. (plain labelling)
    float sf[4][4], dpf[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sf[i][e] = dpf[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 8; ++kk) {
      const int c = 8 * kk + t;
      const float* qa = qs + (wr + g) * kS + c;
      const float* oa = dos + (wr + g) * kS + c;
      uint32_t qh[4], ql[4], oh[4], ol[4];
      tc::split_a(qa[0], qa[8 * kS], qa[4], qa[8 * kS + 4], qh, ql);
      tc::split_a(oa[0], oa[8 * kS], oa[4], oa[8 * kS + 4], oh, ol);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* kp = k_s + (wc + 8 * nt + g) * kS + c;
        const float* vp = v_s + (wc + 8 * nt + g) * kS + c;
        uint32_t bh[2], bl[2];
        tc::split_b(kp[0], kp[4], bh, bl);
        tc::mma3(sf[nt], qh, ql, bh, bl);
        tc::split_b(vp[0], vp[4], bh, bl);
        tc::mma3(dpf[nt], oh, ol, bh, bl);
      }
    }

    // P and dS on the fragments, into shared memory
    const float* ls = lse_s + stage * kT;
    const float* dls = delta_s + stage * kT;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wr + g + 8 * half, row = row0 + r;
      const float l = ls[r], dl = dls[r];
      const bool row_live = row < a.Tq && l > kDeadLse;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float pv[2], dsv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + wc + 8 * nt + 2 * t + e;
          const bool live = row_live && col < klen &&
                            (!a.causal || col <= row);
          pv[e] = live ? expf(a.scale * sf[nt][2 * half + e] - l) : 0.f;
          dsv[e] = pv[e] * (dpf[nt][2 * half + e] - dl);
        }
        const int at = r * kS + wc + 8 * nt + 2 * t;
        *reinterpret_cast<float2*>(p_s + at) = make_float2(pv[0], pv[1]);
        *reinterpret_cast<float2*>(ds_s + at) = make_float2(dsv[0], dsv[1]);
      }
    }
    __syncthreads();

    // dV^T += dO^T.P and dK^T += Q^T.dS: d wr.., keys wc.., reduced
    // over the tile's 64 rows read down the tiles (paired labelling),
    // in fresh fragments added to the sweep's sums after
    float dv_t[4][4], dk_t[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dv_t[i][e] = dk_t[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kT / 8; ++kk) {
      const int r = 8 * kk + 2 * t;
      const float* oa = dos + r * kS + wr + g;
      const float* qa = qs + r * kS + wr + g;
      uint32_t oh[4], ol[4], qh[4], ql[4];
      tc::split_a(oa[0], oa[8], oa[kS], oa[kS + 8], oh, ol);
      tc::split_a(qa[0], qa[8], qa[kS], qa[kS + 8], qh, ql);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* pp = p_s + r * kS + wc + 8 * nt + g;
        const float* dp = ds_s + r * kS + wc + 8 * nt + g;
        uint32_t bh[2], bl[2];
        tc::split_b(pp[0], pp[kS], bh, bl);
        tc::mma3(dv_t[nt], oh, ol, bh, bl);
        tc::split_b(dp[0], dp[kS], bh, bl);
        tc::mma3(dk_t[nt], qh, ql, bh, bl);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dv_acc[i][e] += dv_t[i][e];
        dk_acc[i][e] += dk_t[i][e];
      }

    // dQ_part = dS.K: rows wr.., d wc.., reduced over the tile's keys
    float dq[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kT / 8; ++kk) {
      const int c = 8 * kk + t;
      const float* da = ds_s + (wr + g) * kS + c;
      uint32_t ah[4], al[4];
      tc::split_a(da[0], da[8 * kS], da[4], da[8 * kS + 4], ah, al);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* kp = kt_s + (wc + 8 * nt + g) * kS + c;
        uint32_t bh[2], bl[2];
        tc::split_b(kp[0], kp[4], bh, bl);
        tc::mma3(dq[nt], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + wr + g + 8 * half;
      if (row >= a.Tq) continue;
      float* out = part + row * a.sdq[2] + wc + 2 * t;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        *reinterpret_cast<float2*>(out + 8 * nt) =
            make_float2(a.scale * dq[nt][2 * half],
                        a.scale * dq[nt][2 * half + 1]);
    }
  }

  // dK = scale * (dK^T)^T, dV = (dV^T)^T: fragment (d, key) -> [key][d]
  float* dkb = a.dk + b * a.sdk[0] + h * a.sdk[1];
  float* dvb = a.dv + b * a.sdv[0] + h * a.sdv[1];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = col0 + wc + 8 * nt + 2 * t + (e & 1);
      const int d = wr + g + 8 * (e >> 1);
      if (key >= a.Tk) continue;
      dkb[key * a.sdk[2] + d] = a.scale * dk_acc[nt][e];
      dvb[key * a.sdv[2] + d] = dv_acc[nt][e];
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                   const BwdArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// which: 0 = K2 (fused; dq is the [nk, ...] partials buffer),
//        1 = K3 (dq), 2 = K4 (dk, dv).
// strides: 22 long longs — (batch, head, row) element strides of q, k, v,
// dO, dq, dk, dv, then K2's element stride between kv tiles' partials.
extern "C" int pt_flash_attn_bwd_f32(
    int which, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* delta,
    const void* kv_len, void* dq, void* dk, void* dv, int B, int n, int Tq,
    int Tk, int D, const long long* strides, int causal, float scale,
    void* stream) {
  if (D != kD) return -1;
  BwdArgs a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.dout = static_cast<const float*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.kv_len = static_cast<const int*>(kv_len);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
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
  const int nq = (Tq + kT - 1) / kT, nk = (Tk + kT - 1) / kT;
  const size_t tile = sizeof(float) * kTile, rows = sizeof(float) * 2 * kT;
  switch (which) {
    case 0:
      return static_cast<int>(launch(bwd_fused_tc_kernel, dim3(nk, B * n),
                                     kFusedThreads, kFusedSmem, a, s));
    case 1:
      return static_cast<int>(launch(bwd_dq_kernel, dim3(nq, B * n),
                                     kThreads, 6 * tile + rows, a, s));
    case 2:
      return static_cast<int>(launch(bwd_dkv_kernel, dim3(nk, B * n),
                                     kThreads, 8 * tile + rows, a, s));
    default:
      return -2;
  }
}
