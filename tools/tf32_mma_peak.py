"""Peak rate of the instruction K1 and K2 run their products on.

    python3 tools/tf32_mma_peak.py

Builds a small CUDA kernel for sm_90a (nvcc, the flags of
paddle_tpu_torch/_build.py) in which every warp issues back-to-back
`mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32` on 8 independent
accumulators, and the same loop of f32 FMAs, and times both with CUDA
events at 4, 8 and 16 warps an SM. Prints TFLOP/s (2 flops a
multiply-add) beside the card's name and power limit. The 3xTF32
ceiling of a kernel built on mma.sync is a third of the tf32 rate.

Needs a CUDA card and nvcc; imports torch and the port's build helper,
nothing of JAX.
"""

import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from paddle_tpu_torch import _build  # noqa: E402

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kAcc = 8;   // independent accumulators a warp keeps busy

__global__ void mma_loop(float* out, int iters) {
  const uint32_t x = threadIdx.x * 0x9e3779b9u;
  uint32_t a[4] = {x & 0xffffe000u, (x ^ 1u) & 0xffffe000u,
                   (x ^ 2u) & 0xffffe000u, (x ^ 3u) & 0xffffe000u};
  uint32_t b[2] = {(x ^ 4u) & 0xffffe000u, (x ^ 5u) & 0xffffe000u};
  float c[kAcc][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < kAcc; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%0, %1, %2, %3};"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kAcc; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void ffma_loop(float* out, int iters) {
  float c[kAcc];
  const float m = 1.0f + threadIdx.x * 1e-7f;
#pragma unroll
  for (int j = 0; j < kAcc; ++j) c[j] = j * 1e-3f;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < kAcc; ++j) c[j] = fmaf(c[j], m, 1e-7f);
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kAcc; ++j) s += c[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int pt_peak_loop(int which, int blocks, int threads, int iters,
                            void* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<float*>(out);
  if (which == 0)
    mma_loop<<<blocks, threads, 0, s>>>(o, iters);
  else
    ffma_loop<<<blocks, threads, 0, s>>>(o, iters);
  return static_cast<int>(cudaGetLastError());
}
"""

# flops a warp's loop iteration does: 8 mma of 16 x 8 x 8, or 4 x 8
# FMAs on 32 lanes
FLOPS_PER_ITER = {"tf32 mma.sync": 8 * 2 * 16 * 8 * 8,
                  "f32 FMA": 4 * 8 * 32 * 2}


def build():
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, "tf32_mma_peak.cu")
    lib = os.path.join(_build.BUILD_DIR, "libtf32_mma_peak.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                   check=True)
    fn = ctypes.CDLL(lib).pt_peak_loop
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def main():
    if not torch.cuda.is_available():
        sys.exit("tf32_mma_peak: no CUDA card visible")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    fn = build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    iters = 20000
    for which, name in enumerate(FLOPS_PER_ITER):
        for warps in (4, 8, 16):
            blocks, threads = sms * warps // 4, 128
            out = torch.empty(blocks * threads, device="cuda")
            for _ in range(2):                      # warm-up, then timed
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                rc = fn(which, blocks, threads, iters, out.data_ptr(),
                        stream)
                end.record()
                end.synchronize()
                if rc != 0:
                    raise RuntimeError(f"launch failed: cudaError {rc}")
            ms = start.elapsed_time(end)
            flops = FLOPS_PER_ITER[name] * iters * blocks * threads / 32
            print(f"{name}: {warps} warps an SM, {flops / ms / 1e9:.1f} "
                  f"TFLOP/s ({ms:.3f} ms) | {smi}", flush=True)


if __name__ == "__main__":
    main()
