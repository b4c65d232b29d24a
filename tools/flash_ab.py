"""Time the flash-attention and int8 kernels of one checkout of the port,
for A/B comparisons of kernel variants.

    python3 tools/flash_ab.py TREE LABEL [f32|bf16|int8|lse|step|short|all[,...]]

TREE is a directory holding `chip_smoke.py` and `paddle_tpu_torch/` (a
`git archive` of a commit, or a copy with a variant of csrc/); its
kernels are built from its own sources. Prints lines tagged "AB LABEL":

- f32: K1 (flash forward, Tq > 1) and K2 (fused backward) device ms
  (CUDA-graph replay, chip_smoke's `time_ms`) and their max errors
  against the plain versions at GPT-2-small's training shapes
  [8, 12, 1024, 64] and [32, 12, 256, 64] causal; at [8, 12, 1024, 64]
  also the split backward K3 (dq) and K4 (dk, dv), each and as a pair,
  beside the device time of SDPA's f32 backward on the same inputs;
  then chip_smoke's K1 serving cases and the SASS check of the built
  f32 backward library: the HMMA (mma.sync) and LDGSTS (cp.async)
  instructions in bwd_dq_kernel, bwd_dkv_kernel and
  bwd_fused_tc_kernel;
- bf16: K1-bf16 at [8, 12, 1024, 64] causal beside cuDNN's SDPA
  forward, K3-bf16 and K4-bf16 at the same shape (views of the packed
  planes) and K2-bf16 at [32, 12, 256, 64] where the tree has it, with
  their errors relative to the largest plain output, beside the device
  time of cuDNN's SDPA backward on the same inputs; K2-bf16 also without
  the wrapper's sum of f32 dq partials, where the tree has one; then the
  SASS check of the built bf16 library: the HGMMA (wgmma) and UTMALDG
  (TMA load) instructions in flash_fwd_bf16_kernel, bwd_dq_bf16_kernel,
  bwd_dkv_bf16_kernel and bwd_fused_bf16_kernel (cuobjdump -sass);
- int8: the int8 matmul core of a rung-8 dispatch (the five GPT-2-small
  products at M 8192, weighted by their launches): the whole core as
  the serving path runs it (`quant_ops.int8_matmul`: the activation
  quantize, K6, the rescale) and K6 alone, each on the weight layout
  the tree stores on the card (column-major where the tree has
  `quant_ops.is_column_major`, else row-major); then the SASS counts of
  the built int8 library (GMMA / IMMA products, UTMALDG);
- lse (not in `all`): the f32 K5 at x [8192, 768] @ w [768, 50304]
  beside torch.logsumexp(x @ w), its error against the plain version,
  whether two calls give the same bits, and the HMMA / LDGSTS counts of
  the built lse_kernel;
- step (not in `all`): the tree's own f32 training phase (chip_smoke's
  phase 7: GPT-2-small, T 1024, batch 8, the split K3 + K4 route): the
  unprofiled step wall and a profiled step's device time, busy share
  and K3 / K4 / K5 device ms;
- short (not in `all`): the tree's own T 256, B 32 phases, f32 (phase 8:
  K2, K5) and amp (phase 13: K2-bf16, K5-bf16): step wall, a profiled
  step's device time and its K2 / K5 ms.

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
    lib = cs._build.build_libraries(["flash_attn_fwd", "flash_attn_bwd"])[
        "flash_attn_bwd"]
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
        if name == "train":
            dq = fa.flash_attn_bwd_dq(*sets[0], True, scale)
            dk, dv = fa.flash_attn_bwd_dkv(*sets[0], True, scale)
            e3 = float((dq - ref[0]).abs().max())
            e4 = max(float((dk - ref[1]).abs().max()),
                     float((dv - ref[2]).abs().max()))
            k3 = cs.time_ms(lambda *a: fa.flash_attn_bwd_dq(
                *a, True, scale), sets, reps=10)
            k4 = cs.time_ms(lambda *a: fa.flash_attn_bwd_dkv(
                *a, True, scale), sets, reps=10)
            sdpa = library_backward_ms(cs, sets[0], scale)
            print(f"AB {label} {name}: K3 {k3:.4f} ms err abs {e3:.2e} | "
                  f"K4 {k4:.4f} ms err abs {e4:.2e} | pair {k3 + k4:.4f} ms"
                  f" | SDPA backward (f32) {sdpa:.4f} ms", flush=True)
            del dq, dk, dv
        del sets, fsets, got, ref
        torch.cuda.empty_cache()
    for case in cs.kernel_phase():
        print(f"AB {label} K1 {case['case']}: {case['ms']:.4f} ms err "
              f"{case['max_abs_err']:.2e}", flush=True)
    sass_counts(lib, ("bwd_dq_kernel", "bwd_dkv_kernel",
                      "bwd_fused_tc_kernel"), label)


def library_backward_ms(cs, args, scale):
    """cuDNN's SDPA backward on the same inputs, by the tree's own
    yardstick: queued CUDA events where the tree has them, else the sum
    of its profiled kernels."""
    ms, names = cs.sdpa_backward(args, scale)
    return ms if hasattr(cs, "time_queued") else sum(names.values()) / 1e3


def sass_counts(lib, kernels, label):
    """GMMA / MMA products, UTMALDG (TMA loads) and LDGSTS (cp.async
    loads) in each named kernel of a built library (cuobjdump -sass;
    several template instances of a kernel are summed)."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    for kernel in kernels:
        text = "".join(re.findall(r"Function : \S*" + kernel + r"\S*\n(.*?)"
                                  r"(?=\n\s*Function : |\Z)", sass, re.S))
        ops = {op: len(re.findall(op + r"\b", text))
               for op in ("HGMMA", "IGMMA", "HMMA", "IMMA", "UTMALDG",
                          "LDGSTS")}
        print(f"AB {label} SASS {kernel}: "
              + " ".join(f"{k} {v}" for k, v in ops.items() if v), flush=True)


def bf16_kernels(cs, label):
    fa = cs.fa
    lib = cs._build.build_library("flash_attn_bf16")
    rng = np.random.RandomState(0)
    scale = 1.0 / float(np.sqrt(cs.HEAD_DIM))
    B, T = cs.TRAIN_B, cs.TRAIN_T
    sets = [cs.bf16_attn_inputs(rng, B, T, T, [T] * B, True, scale)[0]
            for _ in range(2)]
    fsets = [s[:3] for s in sets]
    lens = sets[0][6]
    starts = torch.zeros_like(lens)
    o, lse = fa.flash_attn_fwd_bf16(*fsets[0], lens, starts, True, scale)
    o_ref, lse_ref = fa.flash_attn_fwd_plain(*fsets[0], lens, starts, True,
                                             scale)
    e1 = cs.bf16_err(o, o_ref)[1]
    e1l = float((lse - lse_ref).abs().max())
    k1 = cs.time_ms(lambda q, k, v: fa.flash_attn_fwd_bf16(
        q, k, v, lens, starts, True, scale), fsets, reps=20)
    sdpa = cs.time_ms(lambda q, k, v: torch.nn.functional
                      .scaled_dot_product_attention(q, k, v, is_causal=True,
                                                    scale=scale),
                      fsets, reps=20)
    print(f"AB {label} bf16 [{B}, 12, {T}, 64]: K1 {k1:.4f} ms err {e1:.2e} "
          f"(LSE {e1l:.2e}) | cuDNN SDPA forward {sdpa:.4f} ms", flush=True)
    del fsets, o, lse, o_ref, lse_ref
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
        k2_alone = cs.time_ms(lambda *a: fused_bf16_kernel_alone(
            fa, *a, scale), sets, reps=20)
        cudnn = library_backward_ms(cs, sets[0], scale)
        print(f"AB {label} bf16 [{B}, 12, {T}, 64]: K2 {k2:.4f} ms err "
              f"{e2:.2e} (without the wrapper's dq sum {k2_alone:.4f} ms) | "
              f"cuDNN SDPA backward {cudnn:.4f} ms", flush=True)
        del sets, ref, got
        torch.cuda.empty_cache()
    sass_counts(lib, ("flash_fwd_bf16_kernel", "bwd_dq_bf16_kernel",
                      "bwd_dkv_bf16_kernel", "bwd_fused_bf16_kernel"), label)


def fused_bf16_kernel_alone(fa, q, k, v, do, lse, delta, lens, scale):
    """The bf16 K2 launch without the wrapper's dq sum: a tree whose
    fused wrapper writes f32 partials (no `dq_partials` counter) gets
    them allocated and the kernel launched, not summed; a tree whose bf16
    K2 sums dq on chip has no sum to leave out, and runs its wrapper."""
    if hasattr(fa.flash_attn_bwd_fused, "dq_partials"):
        return fa.flash_attn_bwd_fused_bf16(q, k, v, do, lse, delta, lens,
                                            True, scale)
    B, n, Tq, D = q.shape
    Tk = k.shape[2]
    part = torch.empty((-(-Tk // fa.BWD_TILE), B, Tq, n, D),
                       dtype=torch.float32, device=q.device)
    dk = fa._plane_grad(B, n, Tk, D, q.device, k.dtype)
    dv = fa._plane_grad(B, n, Tk, D, q.device, v.dtype)
    fa._bwd_launch("fused", q, k, v, do, lse, delta, lens,
                   part.permute(0, 1, 3, 2, 4), dk, dv, True, scale,
                   tile_stride=part.stride(0))
    return part, dk, dv


def lse_kernel(cs, label):
    """The f32 K5 at x [8192, 768] @ w [768, 50304] (chip_smoke's phase 6
    inputs) beside torch.logsumexp(x @ w), its error against the plain
    version, and the SASS counts of the built f32 K5 library."""
    ce = cs.ce
    lib = cs._build.build_library("lm_head_lse")
    rng = np.random.RandomState(0)
    N = cs.TRAIN_B * cs.TRAIN_T
    sets = [(torch.from_numpy(rng.randn(N, cs.HID).astype(np.float32)).cuda(),
             torch.from_numpy((rng.randn(cs.HID, cs.VOCAB) * 0.02)
                              .astype(np.float32)).cuda())
            for _ in range(2)]
    got = ce.lm_head_lse(*sets[0])
    again = ce.lm_head_lse(*sets[0])
    err = float((got - ce.lm_head_lse_plain(*sets[0])).abs().max())
    k5 = cs.time_ms(ce.lm_head_lse, sets, reps=6)
    lib_ms = cs.time_ms(lambda x, w: torch.logsumexp(x @ w, dim=1), sets,
                        reps=3)
    print(f"AB {label} lse [{N}, {cs.HID}] @ [{cs.HID}, {cs.VOCAB}]: K5 "
          f"{k5:.4f} ms err {err:.2e} bitwise-repeatable "
          f"{bool(torch.equal(got, again))} | logsumexp(x @ w) "
          f"{lib_ms:.4f} ms", flush=True)
    del sets
    torch.cuda.empty_cache()
    sass_counts(lib, ("lse_kernel",), label)


def int8_path(cs, label):
    qo = cs.qo
    lib = cs._build.build_library("int8_matmul")
    rng = np.random.RandomState(0)
    M = cs.SERVE_B * cs.TRAIN_T
    colmajor = hasattr(qo, "is_column_major")
    core_total = k6_total = 0.0
    for name, (K, N, count) in cs.INT8_PRODUCTS.items():
        sets = []
        for _ in range(2):
            x = torch.from_numpy(rng.randn(M, K).astype(np.float32)).cuda()
            w = torch.from_numpy(rng.randint(-127, 128, (K, N))
                                 .astype(np.int8)).cuda()
            col = torch.from_numpy(rng.rand(1, N).astype(np.float32)
                                   * 1e-2).cuda()
            sets.append((x, w.t().contiguous().t() if colmajor else w, col))
        reps = 4 if N > 10000 else 20
        core = cs.time_ms(lambda x, w, col: qo.int8_matmul(x, w, col), sets,
                          reps=reps)
        qsets = [(*qo.quantize_activations(x), w, col) for x, w, col in sets]
        if colmajor:
            k6 = cs.time_ms(lambda xq, ax, w, col: qo.int8_matmul_rescaled(
                xq, w, ax, col), qsets, reps=reps)
        else:
            k6 = cs.time_ms(lambda xq, ax, w, col: qo.int8_matmul_i32(xq, w),
                            qsets, reps=reps)
        print(f"AB {label} int8 {name} [{M},{K}]@[{K},{N}] x{count}: core "
              f"{core:.4f} ms | K6 {k6:.4f} ms", flush=True)
        core_total += core * count
        k6_total += k6 * count
        del sets, qsets
        torch.cuda.empty_cache()
    layout = "column" if colmajor else "row"
    print(f"AB {label} int8 per rung-8 dispatch ({layout}-major weights): "
          f"core (quantize + K6 + rescale) {core_total:.4f} ms | K6 "
          f"{k6_total:.4f} ms", flush=True)
    sass_counts(lib, ("int8_matmul_kernel",), label)


def f32_step(cs, label):
    _, smi = cs.device_phase()
    cs._build.build_libraries(cs._build.KERNEL_SOURCES)
    _, r = cs.training_phase(smi)
    b = r["breakdown"]
    if b is None:
        print(f"AB {label} f32 step: wall {r['step_ms']:.1f} ms; device "
              f"time not measured", flush=True)
        return
    k = b["kernel_ms"]
    print(f"AB {label} f32 step [T {cs.TRAIN_T}, B {cs.TRAIN_B}]: wall "
          f"{r['step_ms']:.1f} ms | device {b['device_ms']:.1f} ms | busy "
          f"{b['device_ms'] / r['step_ms']:.3f} | K3 "
          f"{k['flash_attn_bwd_dq']:.2f} ms K4 {k['flash_attn_bwd_dkv']:.2f}"
          f" ms K5 {k['lm_head_lse']:.2f} ms a step", flush=True)


def short_steps(cs, label):
    """The tree's own T 256, B 32 training phases, f32 (K2, K5) then amp
    (K2-bf16, K5-bf16): unprofiled step wall, a profiled step's device
    time and its K2 / K5 ms."""
    _, smi = cs.device_phase()
    cs._build.build_libraries(cs._build.KERNEL_SOURCES)
    _, r = cs.short_training_phase(smi)
    b = r["breakdown"]
    if b is not None:
        k = b["kernel_ms"]
        print(f"AB {label} f32 step [T {cs.SHORT_T}, B {cs.SHORT_B}]: wall "
              f"{r['step_ms']:.1f} ms | device {b['device_ms']:.1f} ms | K2 "
              f"{k['flash_attn_bwd_fused']:.2f} ms K5 "
              f"{k['lm_head_lse']:.2f} ms a step", flush=True)
    _, a = cs.amp_training_phase(smi, r["losses"][0], cs.SHORT_T, cs.SHORT_B,
                                 cs.SEED + 5, 3)
    b = a["breakdown"]
    if b is not None:
        k = b["kernel_ms"]
        print(f"AB {label} amp step [T {cs.SHORT_T}, B {cs.SHORT_B}]: wall "
              f"{a['step_ms']:.1f} ms | device {b['device_ms']:.1f} ms | "
              f"K2-bf16 {k['flash_attn_bwd_fused_bf16']:.3f} ms K5-bf16 "
              f"{k['lm_head_lse_bf16']:.2f} ms a step", flush=True)


def main():
    tree, label = sys.argv[1], sys.argv[2]
    what = set((sys.argv[3] if len(sys.argv) > 3 else "all").split(","))
    sys.path.insert(0, tree)
    cs = importlib.import_module("chip_smoke")   # the tree's own script
    if what & {"f32", "all"}:
        f32_kernels(cs, label)
    if what & {"bf16", "all"}:
        bf16_kernels(cs, label)
    if what & {"int8", "all"}:
        int8_path(cs, label)
    if "lse" in what:
        lse_kernel(cs, label)
    if "step" in what:
        f32_step(cs, label)
    if "short" in what:
        short_steps(cs, label)


if __name__ == "__main__":
    main()
