// Flash-attention forward for Hopper (sm_90a), float32.
//
// Replaces: paddle_tpu/ops/pallas_attention.py::_kernel (K1, :212, launched
// by _flash_forward's pl.pallas_call). Same function: an online softmax
// over the key axis with f32 running max, denominator and accumulator;
// key column `col` of query row `row` is live when
//     col < kv_len[b]  and  (not causal or col <= q_start[b] + row),
// which is K1's mask with a per-batch query offset (q_start = 0 is K1
// exactly; the LM server's decode step has Tq = 1, q_start = pos,
// kv_len = pos + 1). A fully masked row gives O = 0 and LSE = -1e30, as
// K1's _finalize does.
//
// What bounds it on an H100. Tq > 1 (training, prefill, the int8
// server's forward) does 4 * D flops per live (row, key) pair: at the
// training shape [8, 12, 1024, 64] causal that is 12.9 GFLOP, 0.19 ms at
// 67 TFLOP/s of f32 FMA, 0.078 ms at the 165 TFLOP/s of 3xTF32 on the
// tensor cores (tf32_mma.cuh), against 0.02 ms of bytes. So Tq > 1 is
// bound by tensor-core operations. The decode step (Tq = 1) reads every
// live key and value once and is bound by HBM bytes (3.35 TB/s).
//
// Design, Tq > 1 (flash_fwd_tc_kernel). The TPU kernel walks a
// sequential kv grid axis and carries the softmax state in VMEM scratch;
// on the card blocks run in parallel, so one block owns a 64-row query
// tile of one (batch, head), 4 warps of 16 rows, and loops over 64-key
// tiles itself:
//   * each warp splits its Q fragments into TF32 hi/lo once and keeps
//     them in registers;
//   * K/V tiles are double-buffered in shared memory by cp.async (16 B a
//     thread, zero-filled past the tile's last live key, so unwritten
//     cache memory never enters a product): tile j + 1 loads while tile
//     j is computed. 2 stages x (K + V) x 64 x 68 floats = 68 KB;
//   * S = Q.K^T is 3xTF32 mma.sync m16n8k8 into register fragments; the
//     online softmax runs on the fragments (row max and sum by quad
//     shuffles, expf without fast math); P, split again, is the A operand
//     of P.V straight from registers (the paired labelling), V the B
//     operand read down the rows of its tile;
//   * K/V operands are split into hi/lo as each warp loads its fragment,
//     so the tiles stay f32 in shared memory (half the bytes of a split
//     copy) at five integer and float instructions a loaded value;
//   * mma.sync, not wgmma: wgmma takes tf32 operands K-major only, and
//     P.V reduces over the keys, the rows of V, so V would need a
//     transposed copy in shared memory;
//   * P.V of each key tile goes into a fresh fragment, added to the
//     rescaled output in f32 (tf32_mma.cuh: long chains on one tensor-
//     core accumulator lose accuracy);
//   * tiles wholly past the block's last live key are not loaded, a warp
//     skips tiles wholly past its own rows' limits (the causal
//     diagonal), and the ragged edge is masked on the fragments; the
//     blocks of the longest causal rows are scheduled first.
// Serving prefill (Tq <= 256, a few blocks per head) takes this path
// too: on an H100 it measured faster than the 16-row f32 FMA path it
// replaced, so no Tq threshold keeps the old one (PERF.md).
// Tq = 1 (flash_decode_kernel, the decode step). One query row reads
// every live key and value once: 2 flops a loaded float, so the kernel
// is all bytes and latency, and tensor cores do not help. The old design
// (one block a (row, head), 8 warps) left the card idle: 96 blocks on 132
// SMs, the longest row setting the time, a dependent load chain a chunk.
// This one:
//   * splits each row's live keys [0, lim) into parts that depend only on
//     lim and on constants: parts = clamp(ceil(lim / 32), 1, 4) of
//     ceil(lim / parts) keys, so a row's result never depends on the
//     batch, the grid or the SM count (co-batched generation stays
//     bitwise equal to solo);
//   * runs a cluster of 4 blocks a (row, head), rank r owning part r;
//     ranks past the row's parts exit at once. 4 ranks, not 8: on an
//     H100 every launched block costs, idle or not, and 8 ranks measured
//     slower at every batch and length tried; one block a (row, head),
//     4 or 8 warps and no cluster, took 9-49 % longer over the serving
//     engine's own decode steps (PERF.md);
//   * loads a part in rounds of up to 3 chunks of 32 keys, all of a
//     round's K/V rows in flight at once (16-byte cp.async into an
//     unpadded, XOR-swizzled ring), the row's page ids fetched beside
//     its length. In a round each of the 4 warps takes 8 keys of every
//     chunk: a lane a quarter of one key's dot product, the products of
//     the chunks independent of each other; one online-softmax update a
//     round (reductions over the 8 keys only), P.V over a lane's own
//     output columns;
//   * merges: each warp's state (m, l, acc[D]) goes to rank 0's shared
//     memory (distributed shared memory, one remote mbarrier arrival a
//     block), and rank 0 merges the parts * 4 states in (rank, warp)
//     order, so each call gives the same bits;
//   * reads K/V through a page table: key j of row b lives at page
//     tables[b, j / page_len], row j % page_len, of a pool plane [P, n,
//     page_len, D]; the contiguous [B, n, Tk, D] layout is the same
//     kernel with page = b (no table) and page_len = Tk. A key that is not
//     live is never read (zero-filled in shared memory): unbacked table
//     slots point at a trash page and pool memory past a row's length may
//     hold anything, NaN included;
//   * takes any D <= its HD (32 or 64) that is a multiple of 4, masking
//     the tail columns, so the paged entry pads nothing.
// f32 FMAs and expf (no fast math), as the plain version.
//
// Interface: plain C, bound with ctypes. q/k/v are [B, n, T, D] float32
// with arbitrary element strides for B, n and T (D contiguous, strides a
// multiple of 4, pointers 16-byte aligned: what a 16-byte cp.async
// needs); O is written through its own strides, LSE is contiguous
// [B, n, Tq]. Returns cudaGetLastError() after the launch, or -1 for an
// unsupported head dim.

#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr float kNegSentinel = -1e30f;

// Tq = 1: a cluster of kDecRanks blocks a (row, head), one part each.
// kDecRanks and kDecMinKeys must equal DECODE_RANKS and DECODE_MIN_KEYS
// in ops/flash_attention.py (a CPU test reads them here)
constexpr int kDecRanks = 4;      // most parts a row's keys are cut into
constexpr int kDecMinKeys = 32;   // keys a part takes before another is cut
constexpr int kDecWarps = 4;
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kDecChunk = 8 * kDecWarps;  // keys a shared-memory stage holds
constexpr int kDecStages = 3;     // chunks resident at once: one round
constexpr int kDecStates = kDecRanks * kDecWarps;
constexpr int kDecTable = 256;    // page ids of a row staged up front

struct DecodeArgs {
  const float* q;          // [B, n, 1, D]
  const float* k;          // pool [P, n, page_len, D], or [B, n, Tk, D]
  const float* v;
  const int* kv_len;       // [B]
  const int* q_start;      // [B]
  const int* tables;       // [B, m] page ids, or null: page = b
  float* o;                // [B, n, 1, D] through its strides
  float* lse;              // contiguous [B, n]
  int n, m, page_len, D, causal;
  float scale;
  long long sqb, sqh, skp, skh, skt, svp, svh, svt, sob, soh;
};

// K/V rows unpadded, the 16-byte chunk c of row r stored at chunk
// c ^ (r & 7): a lane group's reads of 8 rows' same chunk, and a warp's
// read of one row, touch each bank once
template <int HD>
struct DecodeSmem {
  float k[kDecStages][kDecChunk][HD];
  float v[kDecStages][kDecChunk][HD];
  float st[kDecStates][HD + 2];      // each warp's (acc[HD], m, l)
  int tab[kDecTable];
  uint64_t done;                     // rank 0: the other parts' states in
};

__device__ __forceinline__ int swz(int r, int c4) { return 4 * (c4 ^ (r & 7)); }

// max and sum over the 8 keys a warp holds (lanes 8 apart hold the same)
__device__ __forceinline__ float max8(float v) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float sum8(float v) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int HD>
__global__ void __cluster_dims__(kDecRanks, 1, 1)
__launch_bounds__(kDecThreads) flash_decode_kernel(const DecodeArgs a) {
  constexpr int C4 = HD / 4;                 // 16-byte chunks of a row
  constexpr int QW = HD / 4;                 // a lane's quarter of a row
  constexpr int DPL = HD / 32;               // output columns of a lane
  constexpr int kItems = kDecChunk * C4 / kDecThreads;
  static_assert(kDecChunk * C4 % kDecThreads == 0, "chunk load split");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<DecodeSmem<HD>*>(smem_raw);
  const int rank = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the row's length and its page-table row, fetched together (the
  // table by cp.async, so nothing waits on it before the length)
  const int* tab = a.tables ? a.tables + (long long)b * a.m : nullptr;
  if (tab) {
    for (int i = threadIdx.x; i < min(a.m, kDecTable); i += kDecThreads)
      tc::cp_async4(&sm.tab[i], tab + i, true);
    tc::cp_async_commit();
  }
  int lim = min(a.kv_len[b], a.m * a.page_len);
  if (a.causal) lim = min(lim, a.q_start[b] + 1);
  lim = max(lim, 0);
  // this rank's part [k0, k1) of the live keys [0, lim)
  const int parts =
      min(kDecRanks, max(1, (lim + kDecMinKeys - 1) / kDecMinKeys));
  const int len = (lim + parts - 1) / parts;
  const int k0 = min(lim, rank * len), k1 = min(lim, k0 + len);

  if (rank == 0 && threadIdx.x == 0) {
    hp::mbar_init(&sm.done, max(1, parts - 1));
    hp::mbar_init_fence();
  }
  hp::cluster_arrive();         // releases rank 0's initialised barrier
  if (rank >= parts) {          // no part here: no K/V is read for it
    tc::cp_async_wait<0>();
    hp::cluster_wait();
    return;
  }

  const int key = lane & 7, quarter = lane >> 3;
  float qr[QW];                 // this lane's quarter of q, tail zeroed
  {
    const float* qb = a.q + b * a.sqb + h * a.sqh + quarter * QW;
#pragma unroll
    for (int c = 0; c < QW / 4; ++c) {
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      if (quarter * QW + 4 * c < a.D)
        t = reinterpret_cast<const float4*>(qb)[c];
      qr[4 * c] = t.x; qr[4 * c + 1] = t.y;
      qr[4 * c + 2] = t.z; qr[4 * c + 3] = t.w;
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();              // the table row is in shared memory

  const float* kb = a.k + h * a.skh;
  const float* vb = a.v + h * a.svh;
  auto load_chunk = [&](int c, int stage) {
    const int base = k0 + c * kDecChunk;
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int i = threadIdx.x + it * kDecThreads;
      const int r = i / C4, c4 = i % C4;
      const int j = base + r;
      const bool ok = j < k1 && 4 * c4 < a.D;
      const float* ks = kb;     // dead: zero-filled, nothing read
      const float* vs = vb;
      if (ok) {
        long long page = b;
        int row = j;
        if (tab) {
          const int slot = j / a.page_len;
          page = slot < kDecTable ? sm.tab[slot] : tab[slot];
          row = j - slot * a.page_len;
        }
        ks = kb + page * a.skp + row * a.skt + 4 * c4;
        vs = vb + page * a.svp + row * a.svt + 4 * c4;
      }
      tc::cp_async16(&sm.k[stage][r][swz(r, c4)], ks, ok);
      tc::cp_async16(&sm.v[stage][r][swz(r, c4)], vs, ok);
    }
  };

  float m = -INFINITY, l = 0.f, acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
  const int nchunks = (k1 - k0 + kDecChunk - 1) / kDecChunk;
  // rounds of up to kDecStages chunks: all of a round's loads in flight
  // at once, then each warp's 8 keys of every chunk of it
  for (int c0 = 0; c0 < nchunks; c0 += kDecStages) {
    const int nc = min(kDecStages, nchunks - c0);
    if (c0 > 0) __syncthreads();  // every warp is done with the last round
    for (int c = 0; c < nc; ++c) load_chunk(c0 + c, c);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
    const int r = 8 * warp + key;   // this lane's row of each chunk
    float s[kDecStages];
    float mx = m;
#pragma unroll
    for (int c = 0; c < kDecStages; ++c) {
      s[c] = -INFINITY;
      const int first = k0 + (c0 + c) * kDecChunk + 8 * warp;
      if (c < nc && first < k1) {   // warp-uniform
        const float* kr = sm.k[c][r];
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < QW / 4; ++i) {
          const float4 t = *reinterpret_cast<const float4*>(
              kr + swz(r, quarter * (QW / 4) + i));
          d = fmaf(qr[4 * i], t.x, d);
          d = fmaf(qr[4 * i + 1], t.y, d);
          d = fmaf(qr[4 * i + 2], t.z, d);
          d = fmaf(qr[4 * i + 3], t.w, d);
        }
        d += __shfl_xor_sync(0xffffffffu, d, 8);
        d += __shfl_xor_sync(0xffffffffu, d, 16);
        if (first + key < k1) s[c] = d * a.scale;
      }
      mx = fmaxf(mx, s[c]);
    }
    mx = max8(mx);
    if (mx == -INFINITY) continue;  // warp-uniform: no live key yet
    const float corr = expf(m - mx);  // 0 from m = -inf
    float p[kDecStages], ps = 0.f;
#pragma unroll
    for (int c = 0; c < kDecStages; ++c) {
      p[c] = expf(s[c] - mx);         // 0 for a dead key
      ps += p[c];
    }
    l = fmaf(l, corr, sum8(ps));
    m = mx;
    float pv[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) pv[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDecStages; ++c) {
      if (c >= nc) break;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p[c], j);
        const int row = 8 * warp + j, col = DPL * lane;
        const float* vr = &sm.v[c][row][swz(row, col >> 2) + (col & 3)];
#pragma unroll
        for (int i = 0; i < DPL; ++i) pv[i] = fmaf(pj, vr[i], pv[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] = fmaf(acc[i], corr, pv[i]);
  }

  // this warp's state into slot (rank, warp) of rank 0's shared memory
  float* st = sm.st[rank * kDecWarps + warp];
  hp::cluster_wait();           // rank 0's barrier is initialised
  if (rank > 0) {
    const uint32_t dst = hp::map_rank(st, 0);
    if constexpr (DPL == 2)
      hp::st_cluster_f2(dst + 8u * lane, acc[0], acc[1]);
    else
      hp::st_cluster_f1(dst + 4u * lane, acc[0]);
    if (lane == 0) hp::st_cluster_f2(dst + 4u * HD, m, l);
    __syncthreads();            // the block's states are written
    if (threadIdx.x == 0) hp::mbar_arrive_remote(hp::map_rank(&sm.done, 0));
    return;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) st[DPL * lane + i] = acc[i];
  if (lane == 0) {
    st[HD] = m;
    st[HD + 1] = l;
  }
  __syncthreads();
  if (parts > 1) hp::mbar_wait_cluster(&sm.done, 0);

  // merge the parts * 4 states in (rank, warp) order
  const int nst = parts * kDecWarps;
  float mm = -INFINITY;
#pragma unroll
  for (int i = 0; i < kDecStates; ++i)
    if (i < nst) mm = fmaxf(mm, sm.st[i][HD]);
  const int d = threadIdx.x;
  if (d >= a.D) return;
  float* out = a.o + b * a.sob + h * a.soh;
  float* lse = a.lse + (long long)b * a.n + h;
  if (mm == -INFINITY) {        // no live key: the fully masked row
    out[d] = 0.f;
    if (d == 0) *lse = kNegSentinel;
    return;
  }
  float ll = 0.f, od = 0.f;
#pragma unroll
  for (int i = 0; i < kDecStates; ++i) {
    if (i >= nst) break;
    const float mi = sm.st[i][HD];
    const float f = mi == -INFINITY ? 0.f : expf(mi - mm);
    ll = fmaf(sm.st[i][HD + 1], f, ll);
    od = fmaf(sm.st[i][d], f, od);
  }
  out[d] = od / ll;
  if (d == 0) *lse = mm + logf(ll);
}

template <int HD>
cudaError_t launch_decode(const DecodeArgs& a, int B, cudaStream_t stream) {
  constexpr int smem = sizeof(DecodeSmem<HD>);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_decode_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(kDecRanks, a.n, B);
  flash_decode_kernel<HD><<<grid, kDecThreads, smem, stream>>>(a);
  return cudaSuccess;
}

// D (a multiple of 4, <= 64) -> the decode kernel's HD, 32 or 64; a
// smaller D runs with its tail columns masked
cudaError_t dispatch_decode(const DecodeArgs& a, int B, cudaStream_t s) {
  return a.D <= 32 ? launch_decode<32>(a, B, s) : launch_decode<64>(a, B, s);
}

// Tq > 1: one block per (64-row query tile, head, batch), 4 warps of 16
// rows, 64-key K/V tiles double-buffered by cp.async, 3xTF32 mma.sync
constexpr int kTcRows = 64;    // query rows of a block
constexpr int kTcKeys = 64;    // keys of a K/V tile
constexpr int kTcThreads = 128;

template <int HD>
constexpr int tc_smem_bytes() {
  return 4 * kTcKeys * (HD + 4) * static_cast<int>(sizeof(float));
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const int* __restrict__ kv_len,
                    const int* __restrict__ q_start, float* __restrict__ o,
                    float* __restrict__ lse, int n, int Tq, int Tk,
                    long long sqb, long long sqh, long long sqt,
                    long long skb, long long skh, long long skt,
                    long long svb, long long svh, long long svt,
                    long long sob, long long soh, long long sot,
                    int causal, float scale) {
  constexpr int S = HD + 4;            // padded row stride (floats)
  constexpr int kTile = kTcKeys * S;
  constexpr int KS = HD / 8;           // k-steps of Q.K^T, n-tiles of P.V
  constexpr int NT = kTcKeys / 8;      // n-tiles of Q.K^T, k-steps of P.V
  constexpr int C4 = HD / 4;           // 16-byte chunks of a row
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;                      // [2][key][S]
  float* vs = sm + 2 * kTile;          // [2][key][S]

  const int h = blockIdx.y, b = blockIdx.z;
  // the causal rows reach the most keys at the end: start those first
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kTcRows;
  const int rows = min(kTcRows, Tq - row0);
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

  const float* kb = k + b * skb + h * skh;
  const float* vb = v + b * svb + h * svh;
  auto load_tile = [&](int j, int stage) {
    const int c0 = j * kTcKeys;
    float* kd = ks + stage * kTile;
    float* vd = vs + stage * kTile;
    for (int i = threadIdx.x; i < kTcKeys * C4; i += kTcThreads) {
      const int r = i / C4, c = 4 * (i % C4);
      const bool live = c0 + r < tile_limit;
      const long long src = live ? c0 + r : 0;
      tc::cp_async16(kd + r * S + c, kb + src * skt + c, live);
      tc::cp_async16(vd + r * S + c, vb + src * svt + c, live);
    }
    tc::cp_async_commit();
  };
  const int n_tiles = (tile_limit + kTcKeys - 1) / kTcKeys;
  if (n_tiles > 0) load_tile(0, 0);

  // Q fragments (plain labelling), split once
  uint32_t qh[KS][4], ql[KS][4];
  {
    const float* qb = q + b * sqb + h * sqh + row0 * sqt;
    auto qv = [&](int r, int c) {
      return r < rows ? qb[r * sqt + c] : 0.f;
    };
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int c = 8 * kk + t;
      tc::split_a(qv(r0, c), qv(r1, c), qv(r0, c + 4), qv(r1, c + 4),
                  qh[kk], ql[kk]);
    }
  }

  float m0 = -INFINITY, m1 = -INFINITY;  // running row max (quad-shared)
  float l0 = 0.f, l1 = 0.f;              // this lane's share of the sum
  float acc[KS][4];
#pragma unroll
  for (int i = 0; i < KS; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    tc::cp_async_wait<0>();
    // tile j is visible, and every warp is done with tile j - 1's stage
    __syncthreads();
    if (j + 1 < n_tiles) load_tile(j + 1, stage ^ 1);
    const int c0 = j * kTcKeys;
    if (c0 >= warp_limit) continue;  // warp-uniform: no live key here
    const float* kt = ks + stage * kTile;
    const float* vt = vs + stage * kTile;

    float s[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* kp = kt + (8 * nt + g) * S + 8 * kk + t;
        uint32_t bh[2], bl[2];
        tc::split_b(kp[0], kp[4], bh, bl);
        tc::mma3(s[nt], qh[kk], ql[kk], bh, bl);
      }
    }

    // mask, scale and the online softmax on the fragments
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
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
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = expf(s[nt][0] - base0);
      s[nt][1] = expf(s[nt][1] - base0);
      s[nt][2] = expf(s[nt][2] - base1);
      s[nt][3] = expf(s[nt][3] - base1);
      l0 += s[nt][0] + s[nt][1];
      l1 += s[nt][2] + s[nt][3];
    }

    // O = O * corr + P.V, the tile's P.V in a fresh fragment: P's C
    // fragment of keys 8kk.. is the A fragment of k-step kk under the
    // paired labelling (keys 2t, 2t + 1)
    float pv[KS][4];
#pragma unroll
    for (int i = 0; i < KS; ++i)
      pv[i][0] = pv[i][1] = pv[i][2] = pv[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      uint32_t ph[4], pl[4];
      tc::split_a(s[kk][0], s[kk][2], s[kk][1], s[kk][3], ph, pl);
      const float* vp = vt + (8 * kk + 2 * t) * S + g;
#pragma unroll
      for (int nt = 0; nt < KS; ++nt) {
        uint32_t bh[2], bl[2];
        tc::split_b(vp[8 * nt], vp[S + 8 * nt], bh, bl);
        tc::mma3(pv[nt], ph, pl, bh, bl);
      }
    }
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      acc[i][0] = fmaf(acc[i][0], corr0, pv[i][0]);
      acc[i][1] = fmaf(acc[i][1], corr0, pv[i][1]);
      acc[i][2] = fmaf(acc[i][2], corr1, pv[i][2]);
      acc[i][3] = fmaf(acc[i][3], corr1, pv[i][3]);
    }
  }

#pragma unroll
  for (int o2 = 1; o2 <= 2; o2 <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o2);
  }
  const int rr[2] = {r0, r1};
  const float mm[2] = {m0, m1}, ll[2] = {l0, l1};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = rr[half];
    if (r >= rows) continue;
    const bool dead = mm[half] == -INFINITY;  // fully masked row
    float* out = o + b * sob + h * soh + (row0 + r) * sot + 2 * t;
#pragma unroll
    for (int nt = 0; nt < KS; ++nt) {
      float2 val = make_float2(0.f, 0.f);
      if (!dead)
        val = make_float2(acc[nt][2 * half] / ll[half],
                          acc[nt][2 * half + 1] / ll[half]);
      *reinterpret_cast<float2*>(out + 8 * nt) = val;
    }
    if (t == 0)
      lse[((long long)b * n + h) * Tq + row0 + r] =
          dead ? kNegSentinel : mm[half] + logf(ll[half]);
  }
}

template <int HD>
cudaError_t launch_tc(const float* q, const float* k, const float* v,
                      const int* kv_len, const int* q_start, float* o,
                      float* lse, int B, int n, int Tq, int Tk,
                      const long long* st, int causal, float scale,
                      cudaStream_t stream) {
  constexpr int smem = tc_smem_bytes<HD>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + kTcRows - 1) / kTcRows, n, B);
  flash_fwd_tc_kernel<HD><<<grid, kTcThreads, smem, stream>>>(
      q, k, v, kv_len, q_start, o, lse, n, Tq, Tk, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      causal, scale);
  return cudaSuccess;
}

}  // namespace

extern "C" int pt_flash_attn_fwd_f32(
    const void* q, const void* k, const void* v, const void* kv_len,
    const void* q_start, void* o, void* lse, int B, int n, int Tq, int Tk,
    int D, long long sqb, long long sqh, long long sqt, long long skb,
    long long skh, long long skt, long long svb, long long svh,
    long long svt, long long sob, long long soh, long long sot, int causal,
    float scale, void* stream) {
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  const auto* lp = static_cast<const int*>(kv_len);
  const auto* sp = static_cast<const int*>(q_start);
  auto* op = static_cast<float*>(o);
  auto* lsep = static_cast<float*>(lse);
  auto s = static_cast<cudaStream_t>(stream);
  if (D != 32 && D != 64) return -1;
  cudaError_t err;
  if (Tq == 1) {  // decode: the split-key kernel, page = b, page_len = Tk
    const DecodeArgs a{qp, kp, vp, lp, sp, nullptr, op, lsep, n, 1, Tk, D,
                       causal, scale, sqb, sqh, skb, skh, skt, svb, svh,
                       svt, sob, soh};
    err = dispatch_decode(a, B, s);
  } else {
    const long long st[12] = {sqb, sqh, sqt, skb, skh, skt,
                              svb, svh, svt, sob, soh, sot};
    err = D == 32 ? launch_tc<32>(qp, kp, vp, lp, sp, op, lsep, B, n, Tq, Tk,
                                  st, causal, scale, s)
                  : launch_tc<64>(qp, kp, vp, lp, sp, op, lsep, B, n, Tq, Tk,
                                  st, causal, scale, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// the decode step through page tables: q [B, n, 1, D], K/V pool planes
// [P, n, page_len, D] (strides skp/svp, skh/svh, skt/svt), tables [B, m]
// int32, causal (key j live when j < kv_len[b] and j <= q_start[b]).
// D <= 64, a multiple of 4. Returns cudaGetLastError() after the launch,
// or -1 for an unsupported head dim.
extern "C" int pt_flash_attn_decode_f32(
    const void* q, const void* k, const void* v, const void* tables,
    const void* kv_len, const void* q_start, void* o, void* lse, int B,
    int n, int m, int page_len, int D, long long sqb, long long sqh,
    long long skp, long long skh, long long skt, long long svp,
    long long svh, long long svt, long long sob, long long soh,
    float scale, void* stream) {
  if (D <= 0 || D % 4 != 0 || D > 64) return -1;
  const DecodeArgs a{static_cast<const float*>(q),
                     static_cast<const float*>(k),
                     static_cast<const float*>(v),
                     static_cast<const int*>(kv_len),
                     static_cast<const int*>(q_start),
                     static_cast<const int*>(tables),
                     static_cast<float*>(o), static_cast<float*>(lse),
                     n, m, page_len, D, 1, scale, sqb, sqh, skp, skh, skt,
                     svp, svh, svt, sob, soh};
  const cudaError_t err =
      dispatch_decode(a, B, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
