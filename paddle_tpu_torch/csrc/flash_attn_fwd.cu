// Flash-attention forward for Hopper (sm_90a), float32.
//
// Replaces: paddle_tpu/ops/pallas_attention.py::_kernel (K1, launched by
// _flash_forward's pl.pallas_call). Same function: an online softmax over
// the key axis with f32 running max, denominator and accumulator; key
// column `col` of query row `row` is live when
//     col < kv_len[b]  and  (not causal or col <= q_start[b] + row),
// which is K1's mask with a per-batch query offset (q_start = 0 is K1
// exactly; the LM server's decode step has Tq = 1, q_start = pos,
// kv_len = pos + 1). A fully masked row gives O = 0 and LSE = -1e30, as
// K1's _finalize does.
//
// What bounds it on an H100: in float32 there are no tensor cores, so the
// prefill (about 4*Tq*Tk/2*D multiply-adds per head) is bounded by the
// card's 67 TFLOP/s of f32 FMA; the decode step (Tq = 1) reads every live
// key and value once and is bounded by HBM bytes (3.35 TB/s).
//
// Design. The TPU kernel walks a sequential kv grid axis and carries the
// softmax state in VMEM scratch; on the card blocks run in parallel and
// nothing carries between them, so one block owns a (batch, head,
// BQ-row query tile) and loops over the keys itself:
//   * the query tile is staged once in shared memory and read by
//     broadcast;
//   * the block's NW warps split the KEY axis: warp w takes the 32-key
//     chunks w, w + NW, ... up to the tile's last live column (chunks
//     wholly past it are never touched). Lane j holds key j's row and
//     its share of the chunk's V columns in registers, so each K/V
//     element is loaded once per block and reused by all BQ rows;
//   * per (row, chunk) the lanes compute 32 scores, a warp max/sum by
//     shuffles, and the P.V update of the lane's D/32 output columns,
//     with the partial accumulator in shared memory and the running
//     max/denominator in registers;
//   * at the end the NW partial states of each row are merged (the
//     usual max-rescaled sum) and O and LSE are written.
// Splitting keys across warps is what keeps the decode launch (Tq = 1,
// one block per (slot, head), 8 warps each) spread over the card: 8 slots
// x 12 heads = 96 blocks x 8 warps, each warp streaming its own chunks.
// The arithmetic is plain f32 FMAs with expf/logf (no fast math);
// wgmma/TMA and a split-K decode are later work.
//
// Interface: plain C, bound with ctypes. q/k/v are [B, n, T, D] float32
// with arbitrary element strides for B, n and T (D contiguous, strides a
// multiple of 4, pointers 16-byte aligned); O is written through its own
// strides, LSE is contiguous [B, n, Tq]. Returns cudaGetLastError() after
// the launch, or -1 for an unsupported head dim.

#include <cuda_runtime.h>
#include <math.h>

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
void dispatch(const float* q, const float* k, const float* v,
              const int* kv_len, const int* q_start, float* o, float* lse,
              int B, int n, int Tq, int Tk, const long long* st, int causal,
              float scale, cudaStream_t stream) {
  if (Tq == 1)  // decode: one row per block, 8 warps split the keys
    launch<HD, 1, 8>(q, k, v, kv_len, q_start, o, lse, B, n, Tq, Tk, st,
                     causal, scale, stream);
  else
    launch<HD, 16, 4>(q, k, v, kv_len, q_start, o, lse, B, n, Tq, Tk, st,
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
  switch (D) {
    case 32:
      dispatch<32>(qp, kp, vp, lp, sp, op, lsep, B, n, Tq, Tk, st, causal,
                   scale, s);
      break;
    case 64:
      dispatch<64>(qp, kp, vp, lp, sp, op, lsep, B, n, Tq, Tk, st, causal,
                   scale, s);
      break;
    default:
      return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
