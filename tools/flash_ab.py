"""Time the flash-attention kernels of one checkout of the port, for A/B
comparisons of kernel variants.

    python3 tools/flash_ab.py TREE LABEL [f32|bf16|all]

TREE is a directory holding `chip_smoke.py` and `paddle_tpu_torch/` (a
`git archive` of a commit, or a copy with a variant of csrc/); its
kernels are built from its own sources. Prints lines tagged "AB LABEL":

- f32: K1 (flash forward, Tq > 1) and K2 (fused backward) device ms
  (CUDA-graph replay, chip_smoke's `time_ms`) and their max errors
  against the plain versions at GPT-2-small's training shapes
  [8, 12, 1024, 64] and [32, 12, 256, 64] causal, then chip_smoke's K1
  serving cases;
- bf16: K3-bf16 and K4-bf16 at [8, 12, 1024, 64] causal (views of the
  packed planes) and K2-bf16 at [32, 12, 256, 64] where the tree has
  it, with their errors relative to the largest plain gradient, beside
  the device time of cuDNN's SDPA backward on the same inputs;
  then the SASS check of the built bf16 library: the HGMMA (wgmma) and
  UTMALDG (TMA load) instructions in bwd_dq_bf16_kernel and
  bwd_dkv_bf16_kernel (cuobjdump -sass).

Compare two trees only within one call, in turns: parent, change,
change, parent. Needs a CUDA card.
"""

import importlib
import os
import re
import subprocess
import sys

import numpy as np
import torch


def f32_kernels(cs, label):
    fa = cs.fa
    cs._build.build_libraries(["flash_attn_fwd", "flash_attn_bwd"])
    rng = np.random.RandomState(0)
    scale = 1.0 / float(np.sqrt(cs.HEAD_DIM))
    for name, (B, T) in {"train": (cs.TRAIN_B, cs.TRAIN_T),
                         "short": (cs.SHORT_B, cs.SHORT_T)}.items():
        full = [T] * B
        sets = [cs.bwd_inputs(rng, B, T, T, full, True, scale)
                for _ in range(2)]
        lens = sets[0][6]
        starts = torch.zeros(B, dtype=torch.int32, device="cuda")
        fsets = [s[:3] for s in sets]
        o, lse = fa.flash_attn_fwd(*fsets[0], lens, starts, True, scale)
        o_ref, lse_ref = fa.flash_attn_fwd_plain(*fsets[0], lens, starts,
                                                 True, scale)
        e1 = max(float((o - o_ref).abs().max()),
                 float((lse - lse_ref).abs().max()))
        k1 = cs.time_ms(lambda q, k, v: fa.flash_attn_fwd(
            q, k, v, lens, starts, True, scale), fsets, reps=20)
        got = fa.flash_attn_bwd_fused(*sets[0], True, scale)
        ref = fa.flash_attn_bwd_fused_plain(*sets[0], True, scale)
        e2 = max(cs.rel_err(g, r) for g, r in zip(got, ref))
        e2a = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        k2 = cs.time_ms(lambda *a: fa.flash_attn_bwd_fused(
            *a, True, scale), sets, reps=10)
        print(f"AB {label} {name}: K1 {k1:.4f} ms err {e1:.2e} | K2 "
              f"{k2:.4f} ms err abs {e2a:.2e} rel {e2:.2e}", flush=True)
        del sets, fsets, got, ref
        torch.cuda.empty_cache()
    for case in cs.kernel_phase():
        print(f"AB {label} K1 {case['case']}: {case['ms']:.4f} ms err "
              f"{case['max_abs_err']:.2e}", flush=True)


def library_backward_ms(cs, args, scale):
    """cuDNN's SDPA backward on the same inputs, by the tree's own
    yardstick: queued CUDA events where the tree has them, else the sum
    of its profiled kernels."""
    ms, names = cs.sdpa_backward(args, scale)
    return ms if hasattr(cs, "time_queued") else sum(names.values()) / 1e3


def bf16_kernels(cs, label):
    fa = cs.fa
    lib = cs._build.build_library("flash_attn_bf16")
    rng = np.random.RandomState(0)
    scale = 1.0 / float(np.sqrt(cs.HEAD_DIM))
    B, T = cs.TRAIN_B, cs.TRAIN_T
    sets = [cs.bf16_attn_inputs(rng, B, T, T, [T] * B, True, scale)[0]
            for _ in range(2)]
    ref = fa.flash_attn_bwd_fused_plain(*sets[0], True, scale)
    dq = fa.flash_attn_bwd_dq_bf16(*sets[0], True, scale)
    dk, dv = fa.flash_attn_bwd_dkv_bf16(*sets[0], True, scale)
    e3 = cs.bf16_err(dq, ref[0])[1]
    e4 = max(cs.bf16_err(dk, ref[1])[1], cs.bf16_err(dv, ref[2])[1])
    k3 = cs.time_ms(lambda *a: fa.flash_attn_bwd_dq_bf16(*a, True, scale),
                    sets, reps=20)
    k4 = cs.time_ms(lambda *a: fa.flash_attn_bwd_dkv_bf16(*a, True, scale),
                    sets, reps=20)
    cudnn = library_backward_ms(cs, sets[0], scale)
    print(f"AB {label} bf16 [{B}, 12, {T}, 64]: K3 {k3:.4f} ms err {e3:.2e}"
          f" | K4 {k4:.4f} ms err {e4:.2e} | pair {k3 + k4:.4f} ms | cuDNN "
          f"SDPA backward {cudnn:.4f} ms", flush=True)
    del sets, ref, dq, dk, dv
    torch.cuda.empty_cache()
    if hasattr(fa, "flash_attn_bwd_fused_bf16"):
        B, T = cs.SHORT_B, cs.SHORT_T
        sets = [cs.bf16_attn_inputs(rng, B, T, T, [T] * B, True, scale)[0]
                for _ in range(2)]
        ref = fa.flash_attn_bwd_fused_plain(*sets[0], True, scale)
        got = fa.flash_attn_bwd_fused_bf16(*sets[0], True, scale)
        e2 = max(cs.bf16_err(g, r)[1] for g, r in zip(got, ref))
        k2 = cs.time_ms(lambda *a: fa.flash_attn_bwd_fused_bf16(
            *a, True, scale), sets, reps=20)
        cudnn = library_backward_ms(cs, sets[0], scale)
        print(f"AB {label} bf16 [{B}, 12, {T}, 64]: K2 {k2:.4f} ms err "
              f"{e2:.2e} | cuDNN SDPA backward {cudnn:.4f} ms", flush=True)
        del sets, ref, got
        torch.cuda.empty_cache()
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    for kernel in ("bwd_dq_bf16_kernel", "bwd_dkv_bf16_kernel"):
        body = re.search(r"Function : \S*" + kernel + r"\S*\n(.*?)"
                         r"(?=\n\s*Function : |\Z)", sass, re.S)
        text = body.group(1) if body else ""
        print(f"AB {label} SASS {kernel}: HGMMA "
              f"{len(re.findall(r'HGMMA', text))} UTMALDG "
              f"{len(re.findall(r'UTMALDG', text))}", flush=True)


def main():
    tree, label = sys.argv[1], sys.argv[2]
    what = sys.argv[3] if len(sys.argv) > 3 else "all"
    sys.path.insert(0, tree)
    cs = importlib.import_module("chip_smoke")   # the tree's own script
    if what in ("f32", "all"):
        f32_kernels(cs, label)
    if what in ("bf16", "all"):
        bf16_kernels(cs, label)


if __name__ == "__main__":
    main()
