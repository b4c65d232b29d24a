// Flash-attention backward for Hopper (sm_90a), float32: K2, K3 and K4.
//
// Replaces, in paddle_tpu/ops/pallas_attention.py (launched by
// _flash_backward's pl.pallas_call):
//   K2  _bwd_fused_kernel  one sweep over the q tiles of one kv tile:
//                          dk, dv and per-kv-tile dq partials;
//   K3  _bwd_dq_kernel     dq of one q tile, a sweep over kv tiles;
//   K4  _bwd_dkv_kernel    dk, dv of one kv tile, a sweep over q tiles.
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
// What bounds it on an H100: in float32 there are no tensor cores, so the
// five T x T x D products (four per q/kv tile pair in K4, three in K3;
// K2 does all five in one sweep) are bounded by the card's 67 TFLOP/s of
// f32 FMA; the bytes (q, k, v, dO, O-derived delta and lse in, dq, dk,
// dv out) are a few hundred MB at the training shape, far below it.
//
// Design. The TPU grid walks its reduction axis sequentially and keeps
// the accumulators in VMEM scratch; on the card blocks run in parallel,
// so each block owns one output tile and loops over the reduction axis
// itself, with its accumulators in registers:
//   * tiles are 64 rows x 64 head columns (D = 64 only), 256 threads as
//     16 x 16, each thread owning a 4 x 4 sub-tile of every 64 x 64
//     product, the reduction read from shared memory as float4 pairs;
//   * operands are staged in shared memory in the layout each product
//     reads (row-major, or transposed with the reduction index outer):
//     K3 uses 96 KB, K4 128 KB, K2 160 KB of dynamic shared memory;
//   * dq across kv tiles in K2: per-kv-tile partials written to
//     dq_part[j] and summed by the caller afterwards (the TPU kernel's
//     way), not atomics: the sum order is fixed, so K2 is deterministic
//     and its dq differs from K3's by the order of at most nk f32 terms.
// The arithmetic is plain f32 FMAs with expf (no fast math); wgmma,
// TMA and pipelined loads are later work.
//
// Interface: plain C, bound with ctypes. q/k/v/dO and the gradients are
// [B, n, T, D] float32 with arbitrary element strides for B, n and T (D
// contiguous, strides a multiple of 4, pointers 16-byte aligned), so the
// packed [B, T, n*D] planes pass as head views without a copy; lse and
// delta are contiguous [B, n, Tq]. Returns cudaGetLastError() after the
// launch, -1 for an unsupported head dim, -2 for an unknown kernel.

#include <cuda_runtime.h>
#include <math.h>

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

// K4 (fused = false) and K2 (fused = true): dk, dv of one kv tile
// (blockIdx.x) of one (batch, head) (blockIdx.y); K2 also writes the kv
// tile's dq partial of every q tile (zeros for the dead ones)
template <bool kFused>
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
  float* kr = delta_s + kT;     // K2 only: [c][d]
  float* dst = kr + kTile;      // K2 only: [c][r]

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
    if (kFused) load_rows(kr, kb, a.sk[2], col0, a.Tk);
  }

  float dk[4][4], dv[4][4];
  zero(dk);
  zero(dv);
  for (int it = 0; it < nq; ++it) {
    const int row0 = it * kT;
    const bool live = block_live && it >= i_first;
    if (!live) {
      if (kFused) {  // a dead pair's dq partial is zero
        float* part = a.dq + blockIdx.x * a.dq_tile_stride +
                      b * a.sdq[0] + h * a.sdq[1];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = row0 + ty * 4 + i;
          if (row < a.Tq)
            reinterpret_cast<float4*>(part + row * a.sdq[2])[tx] =
                make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
      continue;
    }
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
      if (kFused) {
#pragma unroll
        for (int j = 0; j < 4; ++j) dst[(tx * 4 + j) * kT + r] = ds[i][j];
      }
    }
    __syncthreads();
    mma64(dv, pr, dor, ty, tx);   // keys ty*4+i, head columns tx*4+j
    mma64(dk, dsr, qr, ty, tx);
    if (kFused) {
      float dq[4][4];
      zero(dq);
      mma64(dq, dst, kr, ty, tx); // rows ty*4+i, head columns tx*4+j
      float* part = a.dq + blockIdx.x * a.dq_tile_stride + b * a.sdq[0] +
                    h * a.sdq[1];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + ty * 4 + i;
        if (row < a.Tq)
          reinterpret_cast<float4*>(part + row * a.sdq[2])[tx] =
              make_float4(a.scale * dq[i][0], a.scale * dq[i][1],
                          a.scale * dq[i][2], a.scale * dq[i][3]);
      }
    }
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

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, const BwdArgs& a,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
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
      return static_cast<int>(launch(bwd_dkv_kernel<true>,
                                     dim3(nk, B * n), 10 * tile + rows, a, s));
    case 1:
      return static_cast<int>(launch(bwd_dq_kernel, dim3(nq, B * n),
                                     6 * tile + rows, a, s));
    case 2:
      return static_cast<int>(launch(bwd_dkv_kernel<false>,
                                     dim3(nk, B * n), 8 * tile + rows, a, s));
    default:
      return -2;
  }
}
