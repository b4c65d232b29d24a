"""Time the flash-attention and int8 kernels of one checkout of the port,
for A/B comparisons of kernel variants.

    python3 tools/flash_ab.py TREE LABEL [f32|bf16|int8|lse|lse16|step|short|amp32|traffic|decode|decodek|serve|slabprefill|all[,...]]

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
- bf16: K1-bf16 at [8, 12, 1024, 64] and [32, 12, 1024, 64] causal
  beside cuDNN's SDPA forward, K3-bf16 and K4-bf16 at the first shape
  (views of the packed planes) and K2-bf16 at [32, 12, 256, 64] where the tree has it, with
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
- lse16 (not in `all`): the bf16 K5 at x [8192, 768] @ w [768, 50304]
  (the amp B 8 step's shape) and at x [32768, 768] (B 32) beside
  torch.logsumexp(torch.mm(x, w, out_dtype=float32)), its error against
  the plain version, whether two calls give the same bits, and the
  HGMMA / UTMALDG / HMMA counts of the built lse_bf16_kernel;
- step (not in `all`): the tree's own f32 training phase (chip_smoke's
  phase 7: GPT-2-small, T 1024, batch 8, the split K3 + K4 route): the
  unprofiled step wall and a profiled step's device time, busy share
  and K3 / K4 / K5 device ms;
- short (not in `all`): the tree's own T 256, B 32 phases, f32 (phase 8:
  K2, K5) and amp (phase 13: K2-bf16, K5-bf16): step wall, a profiled
  step's device time and its K2 / K5 ms;
- amp32 (not in `all`): the tree's own amp phase at T 1024, B 32
  (chip_smoke's phase 14): step wall, a profiled step's device time,
  busy share and its bf16 K5 / K1 ms a step;
- traffic (not in `all`): runs the tree's engine phase (chip_smoke's
  phase 4: GPT-2-small, seven requests over HTTP) and saves the host
  inputs of every decode step its scheduler dispatched (positions, live
  slots, page tables) to build/decode_traffic.npz beside this script's
  checkout, with their row-length mix; run it once before `decode`;
- decode (not in `all`): the f32 decode attention and the paged decode
  step. K1 at Tq = 1 at chip_smoke's "decode" case (contiguous [8, 12,
  1, 64], kv 1-384) and at the engine's paged geometry (page_len 16, 24
  shuffled pages a row of a 100 MB pool): the tree's `flash_attn_decode`
  where it has one, else what its decode step runs there (the K and V
  page gathers, then `flash_attn_fwd`); the contiguous K1 with one key a
  row (B 8: the fixed cost) and at kv 384 for B 1-16 (where the bytes
  take over); the same attention over the recorded engine traffic (12
  layers a step, each over its own pool planes), K1's us a launch by
  kind of step, and K1 alone at the position-300 step's geometry in and
  past the L2; then GPT-2-small's paged decode step (chip_smoke's phase
  4 engine, 8 slots at position 300, no requests): host wall,
  CUDA-graph device time and one profiled step's kernels by class (K1,
  index, copy, cuBLAS, the rest). `decodek` is `decode` without the
  step;
- serve (not in `all`): a serving window on the tree's GPT-2-small
  engine (the engine phase's configuration: 8 slots, prefill batch 4,
  paged, prefix cache; random weights, seed 0): SERVE_REQUESTS
  /v1/generate requests over HTTP, prompts of 16-256 random tokens and
  16-64 new tokens (numpy seed), from SERVE_CLIENTS client threads, in
  a process of their own, that each send their next request when their
  last one ends. Run in turns on
  an engine whose rungs are CUDA graphs and on one whose rungs run
  eagerly (graph, eager, eager, graph); every run's tokens must equal
  the first's. Prints per run TTFT p50 / p99 (client side), tokens/s
  over the whole window, the engine's decode step wall (mean, p50, p99)
  and, for the graph engine, the device time of its decode replays and
  of every replay over the window, between CUDA events;
- slabprefill (not in `all`): the slab engine's prefill:4x256 rung at
  GPT-2-small (8 slots, rows on slots 5, 2, 7 and one pad row): its
  profiled kernels by class and their sum, the eager dispatch's wall,
  and, where the tree captures its rungs, the graph's wall and replay
  device time. For parent / change comparisons of the slab writes.

Compare two trees only within one call, in turns: parent, change,
change, parent. Needs a CUDA card.
"""

import importlib
import os
import re
import subprocess
import sys
import threading
import time

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
    # K1-bf16 at the amp B 32 step's shape, beside cuDNN's forward
    B32 = 32
    big = [cs.bf16_attn_inputs(rng, B32, T, T, [T] * B32, True, scale)[0][:3]
           for _ in range(2)]
    lens32 = torch.full((B32,), T, dtype=torch.int32, device="cuda")
    k1_32 = cs.time_ms(lambda q, k, v: fa.flash_attn_fwd_bf16(
        q, k, v, lens32, torch.zeros_like(lens32), True, scale), big,
        reps=20)
    sdpa_32 = cs.time_ms(lambda q, k, v: torch.nn.functional
                         .scaled_dot_product_attention(q, k, v,
                                                       is_causal=True,
                                                       scale=scale),
                         big, reps=20)
    print(f"AB {label} bf16 [{B32}, 12, {T}, 64]: K1 {k1_32:.4f} ms | cuDNN "
          f"SDPA forward {sdpa_32:.4f} ms", flush=True)
    del big
    torch.cuda.empty_cache()
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


def lse16_kernel(cs, label):
    """The bf16 K5 at the amp steps' shapes beside
    logsumexp(mm(x, w) with f32 output), its error against the plain
    version, whether two calls give the same bits, and the SASS counts
    of the built bf16 K5 library."""
    ce = cs.ce
    lib = cs._build.build_library("lm_head_lse_bf16")
    rng = np.random.RandomState(0)
    for N in (cs.TRAIN_B * cs.TRAIN_T, 32 * cs.TRAIN_T):
        sets = [(torch.from_numpy(rng.randn(N, cs.HID).astype(np.float32))
                 .to("cuda", torch.bfloat16),
                 torch.from_numpy((rng.randn(cs.HID, cs.VOCAB) * 0.02)
                                  .astype(np.float32)).to("cuda",
                                                          torch.bfloat16))
                for _ in range(2)]
        got = ce.lm_head_lse_bf16(*sets[0])
        again = ce.lm_head_lse_bf16(*sets[0])
        err = float((got - ce.lm_head_lse_plain(*sets[0])).abs().max())
        k5 = cs.time_ms(ce.lm_head_lse_bf16, sets, reps=10)
        lib_ms = cs.time_ms(lambda x, w: torch.logsumexp(
            torch.mm(x, w, out_dtype=torch.float32), dim=1), sets, reps=5)
        print(f"AB {label} lse16 [{N}, {cs.HID}] @ [{cs.HID}, {cs.VOCAB}]: "
              f"K5-bf16 {k5:.4f} ms err {err:.2e} bitwise-repeatable "
              f"{bool(torch.equal(got, again))} | logsumexp(mm(x, w, f32 "
              f"out)) {lib_ms:.4f} ms", flush=True)
        del sets, got, again
        torch.cuda.empty_cache()
    sass_counts(lib, ("lse_bf16_kernel",), label)


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


def amp_b32_step(cs, label):
    """The tree's own amp T 1024, B 32 phase: unprofiled step wall, a
    profiled step's device time, busy share and K5-bf16 / K1-bf16 ms a
    step."""
    _, smi = cs.device_phase()
    cs._build.build_libraries(cs._build.KERNEL_SOURCES)
    r = cs.amp_batch_phase(smi)
    b = r["breakdown"]
    if b is None:
        print(f"AB {label} amp step [T {cs.TRAIN_T}, B {r['batch']}]: wall "
              f"{r['step_ms']:.1f} ms; device time not measured", flush=True)
        return
    k = b["kernel_ms"]
    print(f"AB {label} amp step [T {cs.TRAIN_T}, B {r['batch']}]: wall "
          f"{r['step_ms']:.1f} ms | device {b['device_ms']:.1f} ms | busy "
          f"{b['busy']:.3f} | K5-bf16 {k['lm_head_lse_bf16']:.2f} ms K1-bf16 "
          f"{k['flash_attn_fwd_bf16']:.2f} ms a step", flush=True)


DECODE_KV = [384, 1, 17, 250, 100, 64, 333, 5]   # chip_smoke's decode case
PAGE_LEN, PAGES_A_ROW, POOL_PAGES = 16, 24, 1024
DECODE_CLASSES = (("K1", ("flash_decode_", "flash_fwd_")),
                  ("index", ("index",)), ("copy", ("copy",)),
                  ("cuBLAS", ("gemm", "nvjet", "xmma", "cutlass")))
# the engine phase's decode steps, as `traffic` records them
TRAFFIC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build", "decode_traffic.npz")


def profiled_events(fn, calls=3):
    """The device kernels [(name, us)] of one call of fn under
    torch.profiler, in launch order: of `calls` profiled calls the one
    that recorded the most (the profiler now and then drops events)."""
    from torch.profiler import ProfilerActivity, profile
    best = []
    for _ in range(calls):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        got = [(ev.name, float(ev.time_range.elapsed_us()))
               for ev in prof.events()
               if getattr(ev, "device_type", None)
               == torch.autograd.DeviceType.CUDA]
        best = got if len(got) > len(best) else best
    return best


def by_class(events):
    """{class: (us, launches)} of profiled events by DECODE_CLASSES; a
    name matching none is "rest"."""
    out = {c: [0.0, 0] for c, _ in DECODE_CLASSES + (("rest", ()),)}
    for name, us in events:
        c = next((c for c, frags in DECODE_CLASSES
                  if any(f in name for f in frags)), "rest")
        out[c][0] += us
        out[c][1] += 1
    return {c: (round(us, 1), n) for c, (us, n) in out.items()}


def engine_config(cs):
    """chip_smoke's phase 4 engine configuration."""
    return cs.GenerationConfig(max_slots=8, prefill_batch=4,
                               max_prompt_len=256, max_new_tokens=128,
                               paged=True, page_len=PAGE_LEN,
                               prefix_cache=True)


def record_traffic(cs, label):
    """Run the tree's engine phase (chip_smoke phase 4: GPT-2-small, the
    seven requests over HTTP) and save the host inputs of every decode
    step its scheduler dispatched (pos_idx, live, page tables) to
    TRAFFIC, with the size of its page pool; print their row-length
    mix."""
    _, smi = cs.device_phase()
    cs._build.build_library("flash_attn_fwd")
    steps, engines = [], []
    real = cs.GenerationEngine._dispatch_decode

    def spy(self, tok, pos_idx, live, tables=None):
        # the phase's first engine (warmed first), on its scheduler's
        # thread: not warmup's or the breakdown's calls, nor those of an
        # eager yardstick engine the phase builds after it
        if not engines:
            engines.append(self)
        if self is engines[0] and \
                threading.current_thread() is not threading.main_thread():
            steps.append((pos_idx.copy(), live.copy(), tables.copy()))
        return real(self, tok, pos_idx, live, tables)

    cs.GenerationEngine._dispatch_decode = spy
    try:
        cs.engine_phase(smi)
    finally:
        cs.GenerationEngine._dispatch_decode = real
    pos, live, tables = (np.stack(x) for x in zip(*steps))
    os.makedirs(os.path.dirname(TRAFFIC), exist_ok=True)
    np.savez(TRAFFIC, pos=pos, live=live, tables=tables,
             pages=engine_config(cs).num_pages + 1)
    kv = (pos + 1)[live]
    rows = {int(r): int(c) for r, c in zip(*np.unique(
        live.sum(1), return_counts=True))}
    print(f"AB {label} decode traffic: {len(pos)} steps of {pos.shape[1]} "
          f"slots; steps by live rows {rows}; "
          f"live kv min {kv.min()} p25 {np.percentile(kv, 25):.0f} median "
          f"{np.median(kv):.0f} p75 {np.percentile(kv, 75):.0f} max "
          f"{kv.max()}; dead slots (kv 1) {int((~live).sum())}", flush=True)
    for name, steps_of in traffic_groups(pos, live):
        k = (pos[steps_of] + 1)[live[steps_of]]
        print(f"AB {label} decode traffic: {name}: {len(steps_of)} steps, "
              f"live kv {k.min()}-{k.max()}", flush=True)


def traffic_groups(pos, live):
    """The recorded steps by kind: [(name, step indices)]."""
    nlive = live.sum(1)
    top = np.where(live, pos + 1, 0).max(1)
    kinds = [("several live rows", nlive > 1),
             ("one live row, kv < 128", (nlive == 1) & (top < 128)),
             ("one live row, kv >= 128", (nlive == 1) & (top >= 128))]
    return [(name, np.flatnonzero(sel)) for name, sel in kinds]


def attention_of(fa, scale):
    """(name, fn(q, k plane, v plane, tables, lens, starts)): what the
    tree's paged decode step runs for one layer's attention."""
    if hasattr(fa, "flash_attn_decode"):
        return "flash_attn_decode", (
            lambda q, kp, vp, t, lens, starts: fa.flash_attn_decode(
                q, kp, vp, t, PAGE_LEN, lens, starts, scale))
    gather = importlib.import_module(
        "paddle_tpu_torch.ops.transformer_ops")._gather_pages
    return "gather K, V + flash_attn_fwd", (
        lambda q, kp, vp, t, lens, starts: fa.flash_attn_fwd(
            q, gather(kp, t), gather(vp, t), lens, starts, True, scale))


def paged_inputs(rng, sets, lens, starts, n=12, D=64):
    """`sets` (q [8, n, 1, D], K pool, V pool, tables [8, 24], lens,
    starts) over one K and one V pool [POOL_PAGES, n, 16, D]: each set's
    rows take their own pages of the pool in a shuffled order (page 0,
    the trash page, on unbacked slots)."""
    kp, vp = (torch.randn(POOL_PAGES, n, PAGE_LEN, D, device="cuda")
              for _ in range(2))
    free = iter(rng.permutation(np.arange(1, POOL_PAGES)))
    out = []
    for _ in range(sets):
        tables = np.zeros((len(DECODE_KV), PAGES_A_ROW), np.int32)
        for b, kv in enumerate(DECODE_KV):
            for slot in range(-(-kv // PAGE_LEN)):
                tables[b, slot] = next(free)
        q = torch.from_numpy(rng.randn(len(DECODE_KV), n, 1, D).astype(
            np.float32)).cuda()
        out.append((q, kp, vp, torch.from_numpy(tables).cuda(), lens,
                    starts))
    return out


def traffic_replay(cs, fa, label, rng, scale):
    """K1 over the engine phase's own decode steps (TRAFFIC): every step
    runs the tree's attention in each of the 12 layers, each layer over
    its own K and V pool planes (228 MB of pools, past the L2), as the
    engine's step does. Device ms of the whole replay (CUDA-graph) and,
    from a profiled replay, K1's us and launches, whole and by kind of
    step. Then K1 alone at the position-300 step's geometry (8 rows at kv
    301 on contiguous pages): over one input set (it stays in the L2)
    and over the 12 layers' sets."""
    if not os.path.exists(TRAFFIC):
        print(f"AB {label} decode traffic: {TRAFFIC} not recorded (run "
              f"the `traffic` mode first)", flush=True)
        return
    rec = np.load(TRAFFIC)
    pos, live, tables = rec["pos"], rec["live"], rec["tables"]
    L, n, D = 12, cs.N_HEADS, cs.HEAD_DIM
    kp, vp = (torch.randn(L, int(rec["pages"]), n, PAGE_LEN, D,
                          device="cuda") for _ in range(2))
    what, attend = attention_of(fa, scale)
    sets = []
    for s in range(len(pos)):
        q = torch.from_numpy(rng.randn(pos.shape[1], n, 1, D).astype(
            np.float32)).cuda()
        lens, starts, tab = (torch.from_numpy(np.ascontiguousarray(a)).cuda()
                             for a in (pos[s] + 1, pos[s], tables[s]))
        sets += [(q, kp[l], vp[l], tab, lens, starts) for l in range(L)]
    total = len(sets) * cs.time_ms(attend, sets, reps=len(sets))
    events = [us for name, us in profiled_events(
        lambda: [attend(*a) for a in sets])
        if any(f in name for f in DECODE_CLASSES[0][1])]
    groups = []
    if len(events) == len(sets):       # every K1 launch recorded: by step
        per_step = np.asarray(events).reshape(len(pos), L).sum(1)
        for name, steps_of in traffic_groups(pos, live):
            us = per_step[steps_of].sum() / (L * len(steps_of))
            groups.append(f"{name} {us:.2f}")
    print(f"AB {label} decode traffic ({what}): {len(pos)} steps x {L} "
          f"layers: {total:.4f} ms (graph replay); K1 {sum(events):.1f} us "
          f"over {len(events)} launches, mean {np.mean(events):.2f} us; by "
          f"kind of step (K1 us a launch) {' | '.join(groups)}", flush=True)
    del sets

    m = tables.shape[2]
    tab = torch.arange(1, 8 * m + 1, dtype=torch.int32,
                       device="cuda").view(8, m)
    lens = torch.full((8,), 301, dtype=torch.int32, device="cuda")
    starts = lens - 1
    q = torch.randn(8, n, 1, D, device="cuda")
    if what == "flash_attn_decode":
        k1 = attend
        step_sets = [(q, kp[l], vp[l], tab, lens, starts) for l in range(L)]
    else:                                # the parent's K1 on its views
        def k1(q, k, v, lens, starts):
            return fa.flash_attn_fwd(q, k, v, lens, starts, True, scale)
        gather = importlib.import_module(
            "paddle_tpu_torch.ops.transformer_ops")._gather_pages
        step_sets = [(q, gather(kp[l], tab), gather(vp[l], tab), lens,
                      starts) for l in range(L)]
    warm = 1e3 * cs.time_ms(k1, step_sets[:1])
    cold = 1e3 * cs.time_ms(k1, step_sets)
    print(f"AB {label} decode K1 at the step geometry [8 rows, kv 301]: "
          f"one set (in the L2) {warm:.2f} us | 12 layers' sets {cold:.2f} "
          f"us", flush=True)
    del step_sets, kp, vp
    torch.cuda.empty_cache()


def decode_path(cs, label, step=True):
    fa = cs.fa
    _, smi = cs.device_phase()
    cs._build.build_library("flash_attn_fwd")   # the serving path's only
    rng = np.random.RandomState(0)
    scale = 1.0 / float(np.sqrt(cs.HEAD_DIM))
    starts_np = [kv - 1 for kv in DECODE_KV]
    # 8 sets: 57 MB of live K/V, more than the L2 holds (chip_smoke's
    # decode case cycles 6, 43 MB)
    sets, lens, starts = cs.make_case(rng, len(DECODE_KV), 1, DECODE_KV,
                                      starts_np, 8)
    k1 = cs.time_ms(lambda q, k, v: fa.flash_attn_fwd(
        q, k, v, lens, starts, True, scale), sets)
    del sets
    what, attend = attention_of(fa, scale)
    psets = paged_inputs(rng, 8, lens, starts)
    paged = cs.time_ms(attend, psets)
    print(f"AB {label} decode [8, 12, 1, 64] kv 1-384: contiguous K1 "
          f"{k1:.4f} ms | paged ({what}) {paged:.4f} ms | {smi}", flush=True)
    del psets
    steps = []
    for B, kv in [(8, 1)] + [(B, 384) for B in (1, 2, 4, 6, 8, 12, 16)]:
        sets, lens, starts = cs.make_case(rng, B, 1, [kv] * B,
                                          [kv - 1] * B, 4)
        us = 1e3 * cs.time_ms(lambda q, k, v: fa.flash_attn_fwd(
            q, k, v, lens, starts, True, scale), sets)
        steps.append(f"B {B} kv {kv}: {us:.2f}")
        del sets
    print(f"AB {label} decode contiguous K1 (us): {' | '.join(steps)}",
          flush=True)
    torch.cuda.empty_cache()
    traffic_replay(cs, fa, label, rng, scale)
    if not step:
        return

    spec = cs.LMSpec(50304, 768, 12, 12, 1024)
    cfg = engine_config(cs)
    engine = cs.GenerationEngine(spec, cs.init_lm_weights(spec, seed=cs.SEED),
                                 config=cfg, ready=False, start=False)
    S, m = cfg.max_slots, cfg.pages_per_seq
    host = (np.arange(S, dtype=np.int32), np.full(S, 300, np.int32),
            np.ones(S, bool),
            np.arange(1, S * m + 1, dtype=np.int32).reshape(S, m))
    for _ in range(3):
        engine._dispatch_decode(*host)
    walls = []
    for _ in range(20):
        t0 = time.perf_counter()
        engine._dispatch_decode(*host)
        walls.append(1e3 * (time.perf_counter() - t0))
    args = engine._to_device(*host)
    with torch.inference_mode():
        device_ms = cs.time_ms(lambda: engine._decode_fn(*args), [()], 20)
        events = profiled_events(lambda: engine._decode_fn(*args))
    print(f"AB {label} decode step [8 slots, position 300]: wall median "
          f"{float(np.median(walls)):.3f} ms (min {min(walls):.3f}) | device "
          f"{device_ms:.4f} ms (graph replay) | profiled step "
          f"{len(events)} kernels, (us, launches) {by_class(events)}",
          flush=True)


SERVE_REQUESTS, SERVE_CLIENTS = 400, 8


def serve_windows(cs, label):
    _, smi = cs.device_phase()
    cs.flags.set_flag("metrics", True)         # serving_lm.* histograms
    spec = cs.LMSpec(50304, 768, 12, 12, 1024)
    weights = cs.init_lm_weights(spec, seed=cs.SEED)
    rng = np.random.RandomState(cs.SEED + 21)
    bodies = [{"prompt": rng.randint(0, spec.vocab_size,
                                     rng.randint(16, 257)).tolist(),
               "max_new_tokens": int(rng.randint(16, 65))}
              for _ in range(SERVE_REQUESTS)]
    first = None
    for run, kind in enumerate(("graph", "eager", "eager", "graph")):
        engine = cs.GenerationEngine(spec, weights,
                                     config=engine_config(cs), ready=False)
        if kind == "eager":
            engine._graphs = None
        t0 = time.perf_counter()
        engine.warmup()
        warm = time.perf_counter() - t0
        got = serve_window(cs, engine, bodies)
        engine.shutdown(drain=True, timeout=600)
        toks = got.pop("tokens")
        if first is None:
            first = toks
        elif toks != first:
            raise AssertionError(f"run {run} ({kind}): tokens differ from "
                                 f"run 0's")
        print(f"AB {label} serve window {run} ({kind} rungs, warmed in "
              f"{warm:.1f} s): {SERVE_REQUESTS} requests from "
              f"{SERVE_CLIENTS} clients: {got} | {smi}", flush=True)
        del engine
        torch.cuda.empty_cache()


def serve_window(cs, engine, bodies):
    """Serve `bodies` through engine behind HTTP to SERVE_CLIENTS
    closed-loop clients in a process of their own (`--clients`: the
    server's process runs no client code); returns the window's numbers
    (ms) and each request's tokens."""
    import json
    import tempfile
    server = cs.make_server(engine, port=0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    graphs = engine._graphs
    keys = ({id(r.graph): k for k, r in graphs._rungs.items()}
            if graphs is not None else {})
    marks = []                  # (rung key, start event, end event)
    real = torch.cuda.CUDAGraph.replay

    def timed(graph):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        real(graph)
        end.record()
        marks.append((keys.get(id(graph)), start, end))

    os.makedirs(os.path.dirname(TRAFFIC), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.dirname(TRAFFIC)) as tmp:
        src, dst = os.path.join(tmp, "in.json"), os.path.join(tmp, "out.json")
        with open(src, "w") as f:
            json.dump(bodies, f)
        cs.monitor.reset()
        torch.cuda.CUDAGraph.replay = timed
        try:
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--clients", str(port), src, dst,
                            str(SERVE_CLIENTS)], check=True, timeout=1200)
        finally:
            torch.cuda.CUDAGraph.replay = real
            server.shutdown()
        with open(dst) as f:
            got = json.load(f)
    if got["errors"]:
        raise AssertionError(f"serve window: {len(got['errors'])} requests "
                             f"failed: {got['errors'][:3]}")
    torch.cuda.synchronize()
    hist = cs.monitor.snapshot()["histograms"]
    step = hist["serving_lm.decode_step_s"]
    wall, results = got["wall_s"], got["results"]
    ttft = np.array([t for _, t in results]) * 1e3
    generated = sum(len(t) for t, _ in results)
    out = {"wall_s": wall, "generated": generated,
           "tokens_per_s": generated / wall,
           "ttft_p50_ms": float(np.percentile(ttft, 50)),
           "ttft_p99_ms": float(np.percentile(ttft, 99)),
           "decode_steps": step["count"],
           "decode_step_ms": {q: 1e3 * step[q] for q in
                              ("mean", "p50", "p99")},
           "prefills": hist["serving_lm.prefill_batch_size"]["count"]}
    if marks:
        ms = [(k, s.elapsed_time(e)) for k, s, e in marks]
        dec = [t for k, t in ms if k == "decode"]
        device = sum(t for _, t in ms)
        out.update({"decode_device_ms": {"mean": float(np.mean(dec)),
                                         "p50": float(np.median(dec))},
                    "decode_busy": float(np.mean(dec))
                    / out["decode_step_ms"]["mean"],
                    "replays": len(ms), "device_s": device / 1e3,
                    "window_busy": device / 1e3 / wall})
    out["tokens"] = [t for t, _ in results]
    return out


def clients(port, src, dst, n):
    """The serve window's clients: n threads, each POSTing the next of
    src's bodies to /v1/generate as a stream when its last one ended;
    writes {"wall_s", "results": [[tokens, ttft_s]], "errors"} to dst."""
    import http.client
    import json
    with open(src) as f:
        bodies = json.load(f)
    todo = list(range(len(bodies)))
    results, errors = [None] * len(bodies), []
    lock = threading.Lock()

    def post(body):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        t0 = time.perf_counter()
        conn.request("POST", "/v1/generate", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            raise RuntimeError(f"/v1/generate -> {resp.status}")
        toks, ttft = [], None
        for line in resp:
            ev = json.loads(line)
            if ev["event"] == "token":
                ttft = time.perf_counter() - t0 if ttft is None else ttft
                toks.append(ev["token"])
            elif ev["event"] == "error":
                raise RuntimeError(f"in-band error: {ev}")
        conn.close()
        return toks, ttft

    def client():
        while True:
            with lock:
                if not todo:
                    return
                i = todo.pop(0)
            try:
                results[i] = post(dict(bodies[i], stream=True))
            except Exception as e:
                errors.append([i, repr(e)])

    threads = [threading.Thread(target=client) for _ in range(n)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    with open(dst, "w") as f:
        json.dump({"wall_s": time.perf_counter() - t0, "results": results,
                   "errors": errors}, f)


def slab_prefill(cs, label):
    _, smi = cs.device_phase()
    spec = cs.LMSpec(50304, 768, 12, 12, 1024)
    cfg = cs.GenerationConfig(max_slots=8, prefill_batch=4,
                              max_prompt_len=256, max_new_tokens=128,
                              paged=False)
    engine = cs.GenerationEngine(spec, cs.init_lm_weights(spec,
                                                          seed=cs.SEED),
                                 config=cfg, ready=False, start=False)
    rng = np.random.RandomState(cs.SEED + 5)
    host = (rng.randint(0, spec.vocab_size, (4, 256)).astype(np.int32),
            np.array([256, 200, 256, 1], np.int32),
            np.array([5, 2, 7, cfg.max_slots], np.int32))

    def eager():
        with torch.inference_mode():
            return engine._prefill_fn(*engine._to_device(*host)).cpu()

    def walls(fn, reps=20):
        for _ in range(3):
            fn()
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            out.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(out))

    args = engine._to_device(*host)
    with torch.inference_mode():
        events = profiled_events(lambda: engine._prefill_fn(*args))
    line = (f"AB {label} slab prefill:4x256 (3 rows + a pad row): profiled "
            f"{len(events)} kernels, {sum(us for _, us in events):.1f} us, "
            f"(us, launches) {by_class(events)} | eager wall median "
            f"{walls(eager):.3f} ms")
    if getattr(engine, "_graphs", None) is not None:
        graph_wall = walls(lambda: engine._dispatch_prefill(*host))
        device = cs.graph_replay_ms(engine._graphs, "prefill:4x256")
        line += (f" | graph wall median {graph_wall:.3f} ms, device "
                 f"{device:.4f} ms (replay)")
        if not np.array_equal(eager().numpy(),
                              engine._dispatch_prefill(*host)):
            raise AssertionError("slab prefill: graph != eager")
    print(f"{line} | {smi}", flush=True)


def main():
    if sys.argv[1] == "--clients":
        port, src, dst, n = sys.argv[2:6]
        return clients(int(port), src, dst, int(n))
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
    if "lse16" in what:
        lse16_kernel(cs, label)
    if "step" in what:
        f32_step(cs, label)
    if "short" in what:
        short_steps(cs, label)
    if "amp32" in what:
        amp_b32_step(cs, label)
    if "traffic" in what:
        record_traffic(cs, label)
    if what & {"decode", "decodek"}:
        decode_path(cs, label, step="decode" in what)
    if "serve" in what:
        serve_windows(cs, label)
    if "slabprefill" in what:
        slab_prefill(cs, label)


if __name__ == "__main__":
    main()
