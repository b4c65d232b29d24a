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
// Tq = 1 (flash_fwd_kernel<HD, 1, 8>, the decode step): one block per
// (slot, head), 8 warps split the key axis; lane j holds key j's row
// and its share of the chunk's V columns in registers; the NW partial
// softmax states are merged at the end. Plain f32 FMAs: the step is
// bound by bytes, not operations.
//
// Interface: plain C, bound with ctypes. q/k/v are [B, n, T, D] float32
// with arbitrary element strides for B, n and T (D contiguous, strides a
// multiple of 4, pointers 16-byte aligned: what a 16-byte cp.async
// needs); O is written through its own strides, LSE is contiguous
// [B, n, Tq]. Returns cudaGetLastError() after the launch, or -1 for an
// unsupported head dim.

#include <cuda_runtime.h>
#include <math.h>

#include "tf32_mma.cuh"

namespace {

constexpr float kNegSentinel = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int HD, int BQ, int NW>
__global__ void __launch_bounds__(NW * 32)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ kv_len,
                 const int* __restrict__ q_start, float* __restrict__ o,
                 float* __restrict__ lse, int n, int Tq, int Tk,
                 long long sqb, long long sqh, long long sqt,
                 long long skb, long long skh, long long skt,
                 long long svb, long long svh, long long svt,
                 long long sob, long long soh, long long sot,
                 int causal, float scale) {
  constexpr int DPL = HD / 32;  // output columns owned by each lane
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * BQ;
  const int rows = min(BQ, Tq - row0);

  __shared__ __align__(16) float q_s[BQ][HD];
  __shared__ __align__(16) float p_s[NW][32];
  __shared__ float acc_s[NW][BQ][HD];
  __shared__ float m_s[NW][BQ];
  __shared__ float l_s[NW][BQ];

  const int klen = min(kv_len[b], Tk);
  const int qoff = q_start[b];
  // exclusive bound on live key columns of tile row r (monotone in r)
  auto row_limit = [&](int r) {
    int lim = klen;
    if (causal) lim = min(lim, qoff + row0 + r + 1);
    return max(lim, 0);
  };
  const int tile_limit = row_limit(rows - 1);

  const float* qb = q + b * sqb + h * sqh + row0 * sqt;
  for (int i = threadIdx.x; i < BQ * (HD / 4); i += NW * 32) {
    const int r = i / (HD / 4), c = i % (HD / 4);
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) val = reinterpret_cast<const float4*>(qb + r * sqt)[c];
    reinterpret_cast<float4*>(q_s[r])[c] = val;
  }
  for (int i = lane; i < BQ * HD; i += 32) (&acc_s[warp][0][0])[i] = 0.f;
  __syncthreads();

  float m[BQ], l[BQ];
#pragma unroll
  for (int r = 0; r < BQ; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }

  const float* kb = k + b * skb + h * skh;
  const float* vb = v + b * svb + h * svh;
  for (int c0 = warp * 32; c0 < tile_limit; c0 += NW * 32) {
    const int col = c0 + lane;
    // columns at or past the tile's limit are never read: their K/V stay
    // zero in registers, so unwritten cache memory cannot leak in
    float kr[HD];
    if (col < tile_limit) {
      const float4* src = reinterpret_cast<const float4*>(kb + col * skt);
#pragma unroll
      for (int c = 0; c < HD / 4; ++c) {
        const float4 t = src[c];
        kr[4 * c] = t.x; kr[4 * c + 1] = t.y;
        kr[4 * c + 2] = t.z; kr[4 * c + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int d = 0; d < HD; ++d) kr[d] = 0.f;
    }
    float vr[32][DPL];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const bool live = c0 + j < tile_limit;
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        vr[j][i] = live ? vb[(c0 + j) * svt + lane + 32 * i] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < BQ; ++r) {
      if (r >= rows) break;
      const int lim = row_limit(r);
      if (c0 >= lim) continue;  // warp-uniform: no live key for this row
      const float4* qv = reinterpret_cast<const float4*>(q_s[r]);
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < HD / 4; ++c) {
        const float4 t = qv[c];
        s = fmaf(t.x, kr[4 * c], s);
        s = fmaf(t.y, kr[4 * c + 1], s);
        s = fmaf(t.z, kr[4 * c + 2], s);
        s = fmaf(t.w, kr[4 * c + 3], s);
      }
      s = col < lim ? s * scale : -INFINITY;
      // the chunk holds >= 1 live column (c0 < lim), so m_new is finite
      const float m_new = fmaxf(m[r], warp_max(s));
      const float p = expf(s - m_new);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
      p_s[warp][lane] = p;
      __syncwarp();
      float a[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) a[i] = 0.f;
      const float4* pv = reinterpret_cast<const float4*>(p_s[warp]);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float4 t = pv[c];
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          a[i] = fmaf(t.x, vr[4 * c][i], a[i]);
          a[i] = fmaf(t.y, vr[4 * c + 1][i], a[i]);
          a[i] = fmaf(t.z, vr[4 * c + 2][i], a[i]);
          a[i] = fmaf(t.w, vr[4 * c + 3][i], a[i]);
        }
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        float* acc = &acc_s[warp][r][lane + 32 * i];
        *acc = *acc * corr + a[i];
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < BQ; ++r) {
      m_s[warp][r] = m[r];
      l_s[warp][r] = l[r];
    }
  }
  __syncthreads();

  // merge the NW per-warp partial states of every row
  for (int i = threadIdx.x; i < rows * HD; i += NW * 32) {
    const int r = i / HD, d = i % HD;
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) mm = fmaxf(mm, m_s[w][r]);
    float* out = o + b * sob + h * soh + (row0 + r) * sot;
    float* lse_out = lse + ((long long)b * n + h) * Tq + row0 + r;
    if (mm == -INFINITY) {  // fully masked row
      out[d] = 0.f;
      if (d == 0) *lse_out = kNegSentinel;
      continue;
    }
    float ll = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(m_s[w][r] - mm);
      ll = fmaf(l_s[w][r], f, ll);
      acc = fmaf(acc_s[w][r][d], f, acc);
    }
    out[d] = acc / ll;
    if (d == 0) *lse_out = mm + logf(ll);
  }
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

template <int HD, int BQ, int NW>
void launch(const float* q, const float* k, const float* v, const int* kv_len,
            const int* q_start, float* o, float* lse, int B, int n, int Tq,
            int Tk, const long long* st, int causal, float scale,
            cudaStream_t stream) {
  const dim3 grid((Tq + BQ - 1) / BQ, n, B);
  flash_fwd_kernel<HD, BQ, NW><<<grid, NW * 32, 0, stream>>>(
      q, k, v, kv_len, q_start, o, lse, n, Tq, Tk, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      causal, scale);
}

template <int HD>
cudaError_t dispatch(const float* q, const float* k, const float* v,
                     const int* kv_len, const int* q_start, float* o,
                     float* lse, int B, int n, int Tq, int Tk,
                     const long long* st, int causal, float scale,
                     cudaStream_t stream) {
  if (Tq == 1) {  // decode: one row per block, 8 warps split the keys
    launch<HD, 1, 8>(q, k, v, kv_len, q_start, o, lse, B, n, Tq, Tk, st,
                     causal, scale, stream);
    return cudaSuccess;
  }
  return launch_tc<HD>(q, k, v, kv_len, q_start, o, lse, B, n, Tq, Tk, st,
                       causal, scale, stream);
}

}  // namespace

extern "C" int pt_flash_attn_fwd_f32(
    const void* q, const void* k, const void* v, const void* kv_len,
    const void* q_start, void* o, void* lse, int B, int n, int Tq, int Tk,
    int D, long long sqb, long long sqh, long long sqt, long long skb,
    long long skh, long long skt, long long svb, long long svh,
    long long svt, long long sob, long long soh, long long sot, int causal,
    float scale, void* stream) {
  const long long st[12] = {sqb, sqh, sqt, skb, skh, skt,
                            svb, svh, svt, sob, soh, sot};
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  const auto* lp = static_cast<const int*>(kv_len);
  const auto* sp = static_cast<const int*>(q_start);
  auto* op = static_cast<float*>(o);
  auto* lsep = static_cast<float*>(lse);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32:
      err = dispatch<32>(qp, kp, vp, lp, sp, op, lsep, B, n, Tq, Tk, st,
                         causal, scale, s);
      break;
    case 64:
      err = dispatch<64>(qp, kp, vp, lp, sp, op, lsep, B, n, Tq, Tk, st,
                         causal, scale, s);
      break;
    default:
      return -1;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
