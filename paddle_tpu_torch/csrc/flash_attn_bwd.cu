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
// K3 and K4 (bwd_dq_kernel, bwd_dkv_kernel), the split pair for Tk >
// 256. What bounds them at [8, 12, 1024, 64] causal: K3 runs three
// products (S, dP, dS.K), 19.3 GFLOP: 0.289 ms at 67 TFLOP/s of f32 FMA,
// 0.117 ms at 165 TFLOP/s of 3xTF32; K4 four (S^T, dP^T, P^T.dO,
// dS^T.Q), 25.8 GFLOP: 0.385 and 0.156 ms; their bytes are ~0.04 ms
// each. So both are bound by tensor-core operations. Both are 3xTF32
// mma.sync m16n8k8 kernels of 4 warps, which own 16 rows (K3) or 16
// keys (K4) of a 64-row / 64-key block and sweep the reduction axis
// themselves:
//   * K3 is K1 (flash_attn_fwd.cu) with one more product and no online
//     softmax. Per kv tile S = Q.K^T and dP = dO.V^T go into register
//     fragments, P and dS = P * (dP - delta) are formed on them, and dS,
//     a C fragment under the paired labelling, is the A operand of dS.K
//     straight from registers, with K read down the rows of the tile
//     that S read along them. Q and dO are staged once and their A
//     fragments read and split again per kv tile; K and V come one tile
//     at a time. That is 68 KB of shared memory and, capped by the
//     launch bounds, 168 registers: three blocks (12 warps) an SM. K1's
//     way (Q split once in registers, K and V double-buffered: 87 KB,
//     239 registers, two blocks an SM) took 3 % longer;
//   * K4 computes the transposed products, keys as the fragment rows:
//     S^T = K.Q^T and dP^T = V.dO^T, so P^T and dS^T come out as C
//     fragments and are the A operands of dV += P^T.dO and dK += dS^T.Q
//     straight from registers. Nothing passes through shared memory
//     between the products, and no barrier falls inside a q tile. K and
//     V stay resident (their A fragments are read and split again per q
//     tile); Q, dO and their lse / delta rows are double-buffered by
//     cp.async, each read along its rows and down them from one padded
//     tile;
//   * each kv tile's (K3) or q tile's (K4) part of the output is summed
//     in a fresh fragment and added in f32 (tf32_mma.cuh);
//   * operands are split by split_rz (tf32_mma.cuh: lo is left for the
//     tensor core to truncate), three instructions a value: with lo
//     rounded, K3 took 8 % and K4 10 % longer on an H100;
//   * P by expf, without fast math: exp2f with the scale and log2 e
//     folded into one fmaf took 5 % longer;
//   * the grid runs the tile index slowest, so the heaviest causal tiles
//     of every head start first (K3 the last q tiles, K4 the first kv
//     tiles). Heaviest first within each head, as K1 and K2 order their
//     grids, left a tail of heavy blocks behind the light ones of the
//     other heads: K3 took 22 % and K4 35 % longer;
//   * K3 uses 69,632 bytes of shared memory and 168 registers with 8
//     bytes of spill (three blocks an SM), K4 105,472 bytes and 249
//     registers without spills (two blocks an SM; nvcc -Xptxas -v).
//     Measured and not kept: K4 with a single-buffered Q / dO tile, so
//     three blocks fit an SM, 7 % longer; 128-row K3 and 128-key K4
//     blocks of 8 warps, 10 % and 38 % longer; K4 with S^T / dP^T and
//     dV / dK each in one k-loop (16 accumulator chains), no faster;
//   * no atomics: each output element is written once, by one lane, so
//     both kernels are deterministic.
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
constexpr int kS = kD + 4;     // padded row stride of a shared tile (floats)
constexpr int kPadTile = kT * kS;     // floats in a padded tile
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

__device__ __forceinline__ int key_limit(const BwdArgs& a, int b) {
  return max(min(a.kv_len[b], a.Tk), 0);
}

// rows [r0, r0 + 64) of a [T, 64] operand into a padded shared tile by
// cp.async, zero past `limit` (not committed)
__device__ __forceinline__ void stage_rows(float* dst, const float* base,
                                           long long st, int r0, int limit,
                                           int threads) {
  for (int i = threadIdx.x; i < kT * (kD / 4); i += threads) {
    const int r = i >> 4, c = 4 * (i & 15);
    const bool live = r0 + r < limit;
    const long long src = live ? r0 + r : 0;
    tc::cp_async16(dst + r * kS + c, base + src * st + c, live);
  }
}

// K3: dq of one 64-row q tile (blockIdx.y) of one (batch, head)
// (blockIdx.x); 4 warps of 16 rows, Q and dO staged once, one K/V tile
// at a time by cp.async, 3xTF32 mma.sync; three blocks an SM
constexpr int kDqThreads = 128;
// K, V, Q, dO
constexpr size_t kDqSmem = sizeof(float) * 4 * kPadTile;

__global__ void __launch_bounds__(kDqThreads, 3)
bwd_dq_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  float* k_s = sm;                    // [key][d]
  float* v_s = k_s + kPadTile;        // [key][d]
  float* q_s = v_s + kPadTile;        // [row][d]
  float* do_s = q_s + kPadTile;       // [row][d]

  const int bh = blockIdx.x, b = bh / a.n, h = bh % a.n;
  // the causal rows reach the most keys at the end: the blocks of every
  // head's last q tiles start first
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kT;
  const int rows = min(kT, a.Tq - row0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int klen = key_limit(a, b);
  // exclusive bound on the live keys of block row r (monotone in r)
  auto row_limit = [&](int r) {
    return a.causal ? min(klen, row0 + r + 1) : klen;
  };
  const int tile_limit = row_limit(rows - 1);
  const int n_tiles = (tile_limit + kT - 1) / kT;
  const int r0 = 16 * warp + g, r1 = r0 + 8;  // this lane's block rows
  const int warp_limit =
      16 * warp < rows ? row_limit(min(16 * warp + 15, rows - 1)) : 0;

  const float* kb = a.k + b * a.sk[0] + h * a.sk[1];
  const float* vb = a.v + b * a.sv[0] + h * a.sv[1];
  auto load_kv = [&](int j) {
    stage_rows(k_s, kb, a.sk[2], j * kT, tile_limit, kDqThreads);
    stage_rows(v_s, vb, a.sv[2], j * kT, tile_limit, kDqThreads);
    tc::cp_async_commit();
  };
  if (n_tiles > 0) {
    // Q and dO ride in tile 0's group
    stage_rows(q_s, a.q + b * a.sq[0] + h * a.sq[1] + row0 * a.sq[2],
               a.sq[2], 0, rows, kDqThreads);
    stage_rows(do_s, a.dout + b * a.sdo[0] + h * a.sdo[1] +
                         row0 * a.sdo[2],
               a.sdo[2], 0, rows, kDqThreads);
    load_kv(0);
  }
  // this lane's rows' lse and delta; a row past Tq or with the
  // sentinel lse is dead
  const float* lseb = a.lse + (long long)bh * a.Tq + row0;
  const float* deltab = a.delta + (long long)bh * a.Tq + row0;
  const float l0 = r0 < rows ? lseb[r0] : -1e30f;
  const float l1 = r1 < rows ? lseb[r1] : -1e30f;
  const float d0 = r0 < rows ? deltab[r0] : 0.f;
  const float d1 = r1 < rows ? deltab[r1] : 0.f;
  const int lim0 = l0 > kDeadLse ? row_limit(r0) : 0;
  const int lim1 = l1 > kDeadLse ? row_limit(r1) : 0;

  float acc[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    if (j > 0) {
      __syncthreads();  // every warp is done with tile j - 1
      load_kv(j);
    }
    tc::cp_async_wait<0>();
    __syncthreads();  // tile j is visible
    const int c0 = j * kT;
    if (c0 >= warp_limit) continue;  // warp-uniform: no live key here

    // S = Q.K^T and dP = dO.V^T: rows x keys (plain labelling), K and V
    // read along their rows
    float s[kT / 8][4], dp[kT / 8][4];
#pragma unroll
    for (int i = 0; i < kT / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 8; ++kk) {
      const float* oa = do_s + r0 * kS + 8 * kk + t;
      const float* qa = q_s + r0 * kS + 8 * kk + t;
      uint32_t oh[4], ol[4], qh[4], ql[4];
      tc::split_a<false>(oa[0], oa[8 * kS], oa[4], oa[8 * kS + 4], oh, ol);
      tc::split_a<false>(qa[0], qa[8 * kS], qa[4], qa[8 * kS + 4], qh, ql);
#pragma unroll
      for (int nt = 0; nt < kT / 8; ++nt) {
        const float* kp = k_s + (8 * nt + g) * kS + 8 * kk + t;
        const float* vp = v_s + (8 * nt + g) * kS + 8 * kk + t;
        uint32_t bhi[2], blo[2];
        tc::split_b<false>(kp[0], kp[4], bhi, blo);
        tc::mma3(s[nt], qh, ql, bhi, blo);
        tc::split_b<false>(vp[0], vp[4], bhi, blo);
        tc::mma3(dp[nt], oh, ol, bhi, blo);
      }
    }

    // P = exp(scale * S - lse) and dS = P * (dP - delta) on the
    // fragments, dS in dp's registers
#pragma unroll
    for (int nt = 0; nt < kT / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * nt + 2 * t + e;
        const float p0 = col < lim0 ? expf(a.scale * s[nt][e] - l0) : 0.f;
        const float p1 =
            col < lim1 ? expf(a.scale * s[nt][2 + e] - l1) : 0.f;
        dp[nt][e] = p0 * (dp[nt][e] - d0);
        dp[nt][2 + e] = p1 * (dp[nt][2 + e] - d1);
      }
    }

    // dQ += dS.K over the tile's keys, in a fresh fragment: dS's C
    // fragment of keys 8kk.. is the A fragment of k-step kk under the
    // paired labelling, K read down its rows
    float dq[kD / 8][4];
#pragma unroll
    for (int i = 0; i < kD / 8; ++i)
      dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kT / 8; ++kk) {
      uint32_t ah[4], al[4];
      tc::split_a<false>(dp[kk][0], dp[kk][2], dp[kk][1], dp[kk][3], ah, al);
      const float* kp = k_s + (8 * kk + 2 * t) * kS + g;
#pragma unroll
      for (int nt = 0; nt < kD / 8; ++nt) {
        uint32_t bhi[2], blo[2];
        tc::split_b<false>(kp[8 * nt], kp[kS + 8 * nt], bhi, blo);
        tc::mma3(dq[nt], ah, al, bhi, blo);
      }
    }
#pragma unroll
    for (int i = 0; i < kD / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] += dq[i][e];
  }

  float* out = a.dq + b * a.sdq[0] + h * a.sdq[1];
  const int rr[2] = {r0, r1};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (rr[half] >= rows) continue;
    float* o = out + (row0 + rr[half]) * a.sdq[2] + 2 * t;
#pragma unroll
    for (int nt = 0; nt < kD / 8; ++nt)
      *reinterpret_cast<float2*>(o + 8 * nt) =
          make_float2(a.scale * acc[nt][2 * half],
                      a.scale * acc[nt][2 * half + 1]);
  }
}

// K4: dk, dv of one 64-key kv tile (blockIdx.y) of one (batch, head)
// (blockIdx.x; causal: the first kv tiles, which meet the most q
// tiles, start first); 4 warps of 16 keys, K and V resident, Q / dO tiles and
// their lse / delta rows double-buffered by cp.async, 3xTF32 mma.sync
// on the transposed products
constexpr int kDkvThreads = 128;
// K, V; Q and dO x 2 stages; lse and delta x 2 stages
constexpr size_t kDkvSmem = sizeof(float) * (6 * kPadTile + 4 * kT);

__global__ void __launch_bounds__(kDkvThreads)
bwd_dkv_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  float* k_s = sm;                    // [key][d]
  float* v_s = k_s + kPadTile;        // [key][d]
  float* q_s = v_s + kPadTile;        // [2][row][d]
  float* do_s = q_s + 2 * kPadTile;   // [2][row][d]
  float* lse_s = do_s + 2 * kPadTile; // [2][row]
  float* delta_s = lse_s + 2 * kT;    // [2][row]

  const int bh = blockIdx.x, b = bh / a.n, h = bh % a.n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = blockIdx.y * kT;
  const int klen = key_limit(a, b);
  const int nq = (a.Tq + kT - 1) / kT;
  // first live q tile: none for a tile past kv_len; causal: q tile i
  // reaches key col0 only when its last row >= col0
  const int i_first = col0 >= klen ? nq : (a.causal ? col0 / kT : 0);
  const int k0 = 16 * warp + g, k1 = k0 + 8;  // this lane's tile keys
  const int key0 = col0 + k0, key1 = col0 + k1;
  const bool key0_live = key0 < klen, key1_live = key1 < klen;

  const float* qb = a.q + b * a.sq[0] + h * a.sq[1];
  const float* dob = a.dout + b * a.sdo[0] + h * a.sdo[1];
  const float* lseb = a.lse + (long long)bh * a.Tq;
  const float* deltab = a.delta + (long long)bh * a.Tq;
  auto load_q_tile = [&](int it, int stage) {
    const int row0 = it * kT;
    stage_rows(q_s + stage * kPadTile, qb, a.sq[2], row0, a.Tq,
               kDkvThreads);
    stage_rows(do_s + stage * kPadTile, dob, a.sdo[2], row0, a.Tq,
               kDkvThreads);
    if (threadIdx.x < kT) {
      const int r = threadIdx.x;
      const bool live = row0 + r < a.Tq;
      const int src = live ? row0 + r : 0;
      tc::cp_async4(lse_s + stage * kT + r, lseb + src, live);
      tc::cp_async4(delta_s + stage * kT + r, deltab + src, live);
    }
    tc::cp_async_commit();
  };
  if (i_first < nq) {
    // K and V, zero past kv_len (0 times whatever lies there must not be
    // NaN), in the first q tile's group
    stage_rows(k_s, a.k + b * a.sk[0] + h * a.sk[1], a.sk[2], col0, klen,
               kDkvThreads);
    stage_rows(v_s, a.v + b * a.sv[0] + h * a.sv[1], a.sv[2], col0, klen,
               kDkvThreads);
    load_q_tile(i_first, 0);
  }

  // dK and dV: keys x d fragments, each q tile's part added in f32
  float dk_acc[kD / 8][4], dv_acc[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  for (int it = i_first; it < nq; ++it) {
    const int stage = (it - i_first) & 1;
    tc::cp_async_wait<0>();
    // tile it is visible, and every warp is done with tile it - 1's stage
    __syncthreads();
    if (it + 1 < nq) load_q_tile(it + 1, stage ^ 1);
    const int row0 = it * kT;
    const float* qs = q_s + stage * kPadTile;
    const float* dos = do_s + stage * kPadTile;
    const float* ls = lse_s + stage * kT;
    const float* dls = delta_s + stage * kT;

    // S^T = K.Q^T: keys x rows (plain labelling), Q read along its rows
    float st[kT / 8][4];
#pragma unroll
    for (int i = 0; i < kT / 8; ++i)
      st[i][0] = st[i][1] = st[i][2] = st[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 8; ++kk) {
      const float* ka = k_s + k0 * kS + 8 * kk + t;
      uint32_t ah[4], al[4];
      tc::split_a<false>(ka[0], ka[8 * kS], ka[4], ka[8 * kS + 4], ah, al);
#pragma unroll
      for (int nt = 0; nt < kT / 8; ++nt) {
        const float* qp = qs + (8 * nt + g) * kS + 8 * kk + t;
        uint32_t bhi[2], blo[2];
        tc::split_b<false>(qp[0], qp[4], bhi, blo);
        tc::mma3(st[nt], ah, al, bhi, blo);
      }
    }

    // P^T = exp(scale * S^T - lse[row]) on the fragments: column 2t + e
    // of n-tile nt is row 8nt + 2t + e
#pragma unroll
    for (int nt = 0; nt < kT / 8; ++nt) {
      const int r = 8 * nt + 2 * t, row = row0 + r;
      const float2 l = *reinterpret_cast<const float2*>(ls + r);
      const float lv[2] = {l.x, l.y};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool row_live = row + e < a.Tq && lv[e] > kDeadLse;
        const bool live0 =
            row_live && key0_live && (!a.causal || key0 <= row + e);
        const bool live1 =
            row_live && key1_live && (!a.causal || key1 <= row + e);
        st[nt][e] = live0 ? expf(a.scale * st[nt][e] - lv[e]) : 0.f;
        st[nt][2 + e] =
            live1 ? expf(a.scale * st[nt][2 + e] - lv[e]) : 0.f;
      }
    }

    // dV += P^T.dO over the tile's rows, in a fresh fragment: P^T's C
    // fragment of rows 8kk.. is the A fragment of k-step kk under the
    // paired labelling, dO read down its rows
    {
      float dv[kD / 8][4];
#pragma unroll
      for (int i = 0; i < kD / 8; ++i)
        dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kT / 8; ++kk) {
        uint32_t ah[4], al[4];
        tc::split_a<false>(st[kk][0], st[kk][2], st[kk][1], st[kk][3], ah, al);
        const float* op = dos + (8 * kk + 2 * t) * kS + g;
#pragma unroll
        for (int nt = 0; nt < kD / 8; ++nt) {
          uint32_t bhi[2], blo[2];
          tc::split_b<false>(op[8 * nt], op[kS + 8 * nt], bhi, blo);
          tc::mma3(dv[nt], ah, al, bhi, blo);
        }
      }
#pragma unroll
      for (int i = 0; i < kD / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) dv_acc[i][e] += dv[i][e];
    }

    // dP^T = V.dO^T: keys x rows, dO read along its rows; then dS^T =
    // P^T * (dP^T - delta[row]) in dpt's registers
    float dpt[kT / 8][4];
#pragma unroll
    for (int i = 0; i < kT / 8; ++i)
      dpt[i][0] = dpt[i][1] = dpt[i][2] = dpt[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 8; ++kk) {
      const float* va = v_s + k0 * kS + 8 * kk + t;
      uint32_t ah[4], al[4];
      tc::split_a<false>(va[0], va[8 * kS], va[4], va[8 * kS + 4], ah, al);
#pragma unroll
      for (int nt = 0; nt < kT / 8; ++nt) {
        const float* op = dos + (8 * nt + g) * kS + 8 * kk + t;
        uint32_t bhi[2], blo[2];
        tc::split_b<false>(op[0], op[4], bhi, blo);
        tc::mma3(dpt[nt], ah, al, bhi, blo);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kT / 8; ++nt) {
      const float2 dl = *reinterpret_cast<const float2*>(dls + 8 * nt +
                                                         2 * t);
      dpt[nt][0] = st[nt][0] * (dpt[nt][0] - dl.x);
      dpt[nt][1] = st[nt][1] * (dpt[nt][1] - dl.y);
      dpt[nt][2] = st[nt][2] * (dpt[nt][2] - dl.x);
      dpt[nt][3] = st[nt][3] * (dpt[nt][3] - dl.y);
    }

    // dK += dS^T.Q over the tile's rows, in a fresh fragment, Q read
    // down its rows
    {
      float dk[kD / 8][4];
#pragma unroll
      for (int i = 0; i < kD / 8; ++i)
        dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kT / 8; ++kk) {
        uint32_t ah[4], al[4];
        tc::split_a<false>(dpt[kk][0], dpt[kk][2], dpt[kk][1], dpt[kk][3], ah,
                    al);
        const float* qp = qs + (8 * kk + 2 * t) * kS + g;
#pragma unroll
        for (int nt = 0; nt < kD / 8; ++nt) {
          uint32_t bhi[2], blo[2];
          tc::split_b<false>(qp[8 * nt], qp[kS + 8 * nt], bhi, blo);
          tc::mma3(dk[nt], ah, al, bhi, blo);
        }
      }
#pragma unroll
      for (int i = 0; i < kD / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk_acc[i][e] += dk[i][e];
    }
  }

  // dK = scale * dK, dV: fragment (key, d) -> [key][d], d 2t, 2t + 1
  float* dkb = a.dk + b * a.sdk[0] + h * a.sdk[1];
  float* dvb = a.dv + b * a.sdv[0] + h * a.sdv[1];
  const int keys[2] = {key0, key1};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = keys[half];
    if (key >= a.Tk) continue;
    float* dko = dkb + key * a.sdk[2] + 2 * t;
    float* dvo = dvb + key * a.sdv[2] + 2 * t;
#pragma unroll
    for (int nt = 0; nt < kD / 8; ++nt) {
      *reinterpret_cast<float2*>(dko + 8 * nt) =
          make_float2(a.scale * dk_acc[nt][2 * half],
                      a.scale * dk_acc[nt][2 * half + 1]);
      *reinterpret_cast<float2*>(dvo + 8 * nt) =
          make_float2(dv_acc[nt][2 * half], dv_acc[nt][2 * half + 1]);
    }
  }
}

// K2: dk, dv of one kv tile (blockIdx.x) of one (batch, head)
// (blockIdx.y) and the tile's dq partial of every q tile (zeros for the
// dead ones); 8 warps, 3xTF32 mma.sync, Q/dO double-buffered by cp.async
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
  switch (which) {
    case 0:
      return static_cast<int>(launch(bwd_fused_tc_kernel, dim3(nk, B * n),
                                     kFusedThreads, kFusedSmem, a, s));
    case 1:
      return static_cast<int>(launch(bwd_dq_kernel, dim3(B * n, nq),
                                     kDqThreads, kDqSmem, a, s));
    case 2:
      return static_cast<int>(launch(bwd_dkv_kernel, dim3(B * n, nk),
                                     kDkvThreads, kDkvSmem, a, s));
    default:
      return -2;
  }
}
