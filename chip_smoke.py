"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. device: torch's name for card 0 and nvidia-smi's name and power
     limit;
  2. build: every kernel source under paddle_tpu_torch/csrc/ (K1 flash
     forward, K2-K4 flash backward, K5 lm-head log-sum-exp, K6 int8
     matmul, and the bf16 K1-K5) with nvcc for sm_90a, from
     this checkout, one nvcc per source in parallel;
  3. kernel: K1 held against its plain PyTorch version at the LM
     server's shapes (GPT-2-small heads: n=12, D=64; prefill b=4,
     t=256 over a 384-key page view, cold and prefix-hit; decode 8
     slots x 1 row over 384 keys, contiguous and through the page table
     at the engine's geometry: page_len 16, 24 shuffled pages a row in
     a 100 MB pool that is NaN outside the live rows), float32, ragged
     kv_len, inputs from a numpy seed. Tolerance 1e-4 absolute on O and
     LSE: the two sum in different orders (online softmax over 64-key
     tiles with 3xTF32 tensor-core products for Tq > 1, per-warp states
     over parts of a row merged in order for decode, vs one softmax
     over the row). The paged decode also gives the same bits in two
     calls and for each row alone as in the batch. Times: the kernel,
     the plain version and torch's scaled_dot_product_attention (a
     yardstick only; the port never calls it; paged: over the gathered
     view, and with the gather), each over input sets that together
     exceed the 50 MB L2, beside the least time the card could take;
  4. engine: GPT-2-small at full width (vocab 50304, H 768, 12 layers,
     12 heads, max_len 1024; random weights from numpy seed 0) behind
     the port's HTTP server with the default paged KV cache and prefix
     cache, every rung (decode, 27 prefill rungs, page copy) captured by
     warmup as a CUDA graph (aot_status "cuda_graph"; memory around the
     warmup beside the engine's price). Seven /v1/generate requests:
     four concurrent streams, one buffered, one exact repeat (a full
     prefix hit) and one sharing a page-aligned prefix (a prefix hit
     that prefills from q_start > 0). Checks: token counts, prefix hits,
     page/slot allocs == frees after drain, K1 launches == layers x
     (prefills + decode steps) and page-view gathers == 2 x layers x
     prefills (no decode step gathers), both counted through the graphs'
     replays, and the greedy tokens of three requests against a plain
     full-recompute forward of the same weights on the card. One replay
     of the decode graph and of prefill:4x256, profiled, runs the eager
     function's kernels name by name, as many K1 kernels as the rung
     adds to the counter a replay, and the page gathers the eager
     function counts (none in the decode step). The five
     concurrent requests again on an engine of the same weights with
     eager rungs: its tokens equal, TTFT, decode ms/step and tokens/s
     beside the graphs'. Then one decode step at 8 slots and the
     prefill rungs 4x256 and 1x64: the eager step's host wall against
     the graph's (turns eager, graph, graph, eager; tokens bitwise
     equal) beside the device time of the graph's replay, and a
     profiled step's kernels by class (K1, index, copy, cuBLAS,
     elementwise);
  5. backward kernels: K2 (fused), K3 (dq) and K4 (dk, dv), each called
     explicitly, held against the plain backward at the GPT-2-small
     training shapes q/k/v [8, 12, 1024, 64] and [32, 12, 256, 64]
     causal, and at a ragged kv_len case and a Tq != Tk case; K1 timed
     at the T 1024 shape, K2 at both. Times beside the bound (f32 FMA
     and 3xTF32 tensor cores), the plain version and torch's
     scaled_dot_product_attention forward and backward (a yardstick
     only), whose device kernels are named from a profiled call; one
     line sets the split pair K3 + K4 against K2 and the SDPA backward
     at T 1024 (the inputs of the route rule's question);
  6. K5 (3xTF32 tensor-core products over 33 vocab splits, merged in
     order by a second pass) held against its plain version at the
     training shape x [8192, 768] @ w [768, 50304], two calls bitwise
     equal; timed beside torch.logsumexp(x @ w) in the same run;
  7. training: GPT-2-small at full width (vocab 50304, H 768, 12 layers,
     12 heads, T 1024, batch 8, f32, TF32 off) built with the port's
     front end (transformer_lm_cost + AdamOptimizer(1e-4).minimize),
     initialised by the port's startup program (its torch.Generator,
     seeded 0), fed one fixed token batch from numpy seed 3. Step 1's
     loss and every parameter's gradient are held against a plain
     full recompute (plain attention, plain cross-entropy, torch
     autograd) of the same weights on the card; then five more Adam
     steps, the loss must fall; launches per step: K1 12, the route's
     backward kernels (K3 + K4 at T = 1024) 12 each, K5 1. Step wall
     time, tokens/s and a profiled step's device time by kernel;
  8. short-context training: the same model at T 256, batch 32, where
     the backward route is the fused K2: step 1's loss and gradients
     held against the plain recompute as in phase 7, then three more
     Adam steps; launches per step K1 12, K2 12, K5 1. Step wall time,
     tokens/s and a profiled step's device time by kernel;
  9. K6, the int8 matmul on s8 wgmma + TMA, at the five GPT-2-small
     products of a rung-8 int8 dispatch (M 8192: qkv, proj, ffn_up,
     ffn_down, lm head) and a ragged case, asymmetric operands over the
     whole int8 range, the weight column-major as the port stores it:
     with the rescale in its epilogue (int8_matmul_rescaled) bitwise
     against rescale(int8_matmul_plain) and with its int32 epilogue
     bitwise against int8_matmul_plain; times beside the bound, the plain
     version and torch._int_mm on the same column-major weight (a
     yardstick only); the same checks and times at ResNet-50's int8 fc
     (M 16, K 2048, N 1000: phase 25's rung 16). The activation
     quantize kernel bitwise against quantize_activations_plain on a
     dispatch's activations (K 768 and 3072) and on the ResNet-50 fc's
     input (M 16, K 2048), rows of zeros, rows of exact halves and a
     static scale; its time beside its bytes bound and the plain
     version;
 10. int8 one-shot serving: GPT-2-small transformer_lm + argmax at full
     width (T 1024, f32, TF32 off, the port's startup, generator seed
     0) saved by save_inference_model, quantized by the port's
     quantize_inference_model (50 quantized ops), loaded and served by
     InferenceEngine.from_program (rungs 1, 2, 4, 8, each a CUDA graph
     of Executor.run) behind the HTTP server — the code of `serve
     --model_dir`. The int8 matmul weights
     are column-major on the card, their bytes unchanged. Eight
     /v1/infer requests of 1-3 rows from four client threads must
     co-batch; launches a dispatch: the quantize kernel 49, K6 49 (no
     repack, no K padding), K1 12. Checks: reply ids == Executor.run on
     the same rows; every quant_mul output of a rung-8 run bitwise == the
     plain recompute (plain quantize, int8_matmul_plain, rescale) from
     its own input; logits within 5e-2 of max |logit| of a plain full
     recompute (plain attention, the plain int8 ops), ids equal where its
     top-2 margin exceeds twice the largest difference; the rung-8
     dispatch through the engine's graph against Executor.run, walls in
     turns, ids bitwise equal, beside the graph replay's device time.
     Printed: the f32 model on the same batch, both dispatch walls,
     tokens/s, peak memory,
     weight bytes, and a profiled dispatch's device time split into K6,
     the quantize kernel, K1, an eager rescale (none) and the rest;
 11. bf16 kernels: K1-, K3- and K4-bf16 held against their plain bf16
     versions (the reference's roundings: P and dS to bf16 before the
     products they feed, O and the gradients once at the end) at the
     training shape [8, 12, 1024, 64] (head views of the packed bf16
     planes), a ragged kv_len case and a Tq != Tk case, and K1-bf16 also
     at phase 14's [32, 12, 1024, 64] (more heads than SMs: its other
     unit order); K2-bf16 (the
     fused backward: a cluster of two blocks a (batch, head) that sums dq
     in f32 on chip and writes it once in bf16) at its main path's [32,
     12, 256, 64], a ragged and a Tq > Tk case, two calls bitwise equal;
     K5-bf16 (wgmma + TMA over vocab splits merged in order by a second
     kernel) at x [8192, 768] and phase 14's [32768, 768] @ w [768,
     50304], two calls bitwise equal. Tolerance 1e-2 of the largest |plain|
     element on bf16 outputs (two bf16 ulps), 1e-4 absolute on the f32
     LSEs. Times by CUDA-graph replay beside the bf16 bound (989 TFLOP/s
     dense, 3.35 TB/s), the plain version, and bf16 SDPA forward /
     backward (cuDNN's kernels, named by profiler) or logsumexp(mm(x, w)
     with f32 output) as the yardstick;
 12. amp training: phase 7's program, weights and token batch with
     amp.enable (bench.py's _mfu_bench with amp on, batch 8): step 1's
     loss and every gradient against a plain amp recompute on the card
     (the role casts written out, the plain bf16 kernels, torch autograd;
     loss 1e-5 relative, gradients 2e-2 of their largest element) and
     the loss against phase 7's f32 step 1 (2e-2 relative); every
     gradient, master weight and Adam moment float32; five more Adam
     steps, the loss must fall; launches per step K1-bf16 12, K3-bf16
     12, K4-bf16 12, K5-bf16 1 and no f32 kernel. Step wall, tokens/s,
     peak memory and a profiled step's device time split into cuBLAS's
     bf16 products, the bf16 kernels, casts, Adam and other elementwise;
 13. short-context amp training: phase 8's program, weights and token
     batch (T 256, B 32) with amp.enable, where the backward route is
     the fused K2-bf16: the checks of phase 12 (against phase 8's f32
     step 1), three more Adam steps; launches per step K1-bf16 12,
     K2-bf16 12, K5-bf16 1, and no f32 dq partial buffer allocated (the
     f32 phase 8 allocates one a K2 launch); step wall, tokens/s, peak
     memory and a profiled step;
 14. the amp program at the reference's headline batch, B 32 at T 1024
     (bench.py's bench_transformer_mfu), or the largest of 24 and 16
     that fits: step wall, peak memory and a profiled step's device time
     and busy share;
 15. GPT-2-medium's kernel shapes (vocab 50304, H 1024, 16 heads of 64):
     K5 at x [8192, 1024] and K5-bf16 at [32768, 1024] @ w [1024,
     50304], both also at H 1000 (a ragged last k chunk); K1-, K3- and
     K4-bf16 at [32, 16, 1024, 64] causal, the f32 K1, K3 and K4 at [4,
     16, 1024, 64]: each held to its plain version (the tolerances of
     phases 5, 6 and 11) and timed beside it, its library yardstick and
     its bound;
 16. amp GPT-2-medium training as bench.py's bench_gpt2_medium_mfu
     builds it (24 layers, T 1024, tokens drawn inside the program, one
     stacked transformer_stack op, the remat flag on): step 1 at B 4
     with its loss and every gradient against a plain amp recompute
     (phase 12's tolerances); B 32, a warm-up step and three timed steps
     (wall, tokens/s, peak memory) and a profiled one; B 8 with remat on
     and off, one step each, for their peak memory. Launches per step:
     K1-bf16 48 with remat (the backward's recompute), 24 without;
     K3-bf16 24, K4-bf16 24, K5-bf16 1;
 17. f32 GPT-2-medium training, B 4, remat on, two steps: step 1's loss
     and gradients against the plain f32 recompute (phase 7's
     tolerances); launches K1 48, K3 24, K4 24, K5 1 a step;
 18. generation from phase 16's trained weights: the LM engine (default
     paged KV and prefix cache, every rung a CUDA graph) and
     transformer_lm_generate in a program over a scope of the same
     weights, three prompts of 16 new tokens each; greedy tokens ==
     a plain full-recompute forward; K1 launches == layers x (prefills
     + decode steps) in the engine, layers x 16 in the program;
 19. the stacked inference program (transformer_lm + argmax) with those
     weights quantized by the port (quant_transformer_stack over four
     int8 planes, dequantized a layer at a time; quant_mul for the
     head), served one-shot at rungs 1-8 (CUDA graphs) over /v1/infer:
     a dispatch launches K6 and the quantize kernel once (the head) and
     K1 24 times, no repack; replies == Executor.run; logits and ids
     against the plain recompute over the dequantized weights (phase
     10's gates); the rung-8 dispatch wall, eager and graph;
 20. the trainer: phase 7's GPT-2-small (f32, TF32 off, T 1024, B 8)
     built with the reference's recipe — AdamOptimizer over an
     exponentially decayed LR under set_gradient_clip(
     GradientClipByGlobalNorm(1.0)) — and trained by the port's Trainer
     (on the card by default) over a deterministic reader of numpy
     token examples through reader.batch and a one-worker DeviceFeeder,
     2 passes of 3 batches. Run A uninterrupted (the main path: K1, K3,
     K4 12 a step, K5 1); B checkpoints and is preempted from its event
     handler after (pass 1, batch 0); C, a new Trainer in a fresh
     scope, resumes B at (1, 1) from disk and finishes: every step's
     loss and every persistable == A's bitwise; D, a transient fault
     injected at step 2 and retried: == A bitwise; E, skip_batch with
     the NaN guard on: the update of (0, 1) turned non-finite (one
     Beta2Pow poked to 2.0) fires IterationSkipped with every
     persistable bitwise its pre-step value and none written in place,
     then training goes on. Each trainer step's launches == a bare
     Executor.run step's; the trainer's step wall beside the bare
     step's, checkpoint bytes and io.checkpoint_save_s / _load_s, peak
     memory with the guard off and on, the feed counters;
 21. the optimizer suite: every update op once at [768, 3072] on the
     card, held to the same op on the CPU (1e-6 of each output's
     largest element: FMA contraction may differ), the guard's
     new-tensor mode == the in-place mode bitwise;
 22. ResNet-50 amp training (R1): bench.py's bench_resnet50 program
     exactly (224 x 224, 1000 classes, in-graph uniform_random images
     and labels, Momentum(0.1, 0.9), amp.enable) at RESNET_B, the
     largest of 1024, 512, 256, 128 that fits on one H100:
     images/s median, low and high of 10 steps after 3, peak memory, a
     profiled step's device time by class (cuDNN forward, data and
     weight gradients, layout transforms, GEMM kernels, casts, Momentum,
     batch norm and the other elementwise kernels) beside the step
     wall, its 12 largest kernels;
 23. ResNet-50 on the card against the port on the CPU (R2): f32, TF32
     off, B 4, one forward and one Momentum step from one scope, run
     free: the loss, the fc weight and the first and last running stats
     within 1e-4, the updated stem filter and first batch-norm scale
     within 5e-2 (a relu input within f32 rounding of 0 flips); op by
     op, every op on the CPU's values of its inputs within 1e-4; two
     identical
     two-step runs, f32 and amp, bitwise equal; the stem conv's
     space-to-depth rewrite against the direct conv in f32 at RESNET_B,
     and both timed forward + backward in bf16;
 24. host-fed training (R3): bench.py's bench_resnet50_hostfed program,
     uint8 images through the DeviceFeeder with the port's defaults:
     images/s against phase 22's and the feed counters;
 25. ResNet-50 serving (R4), the clone(for_test=True) program over
     phase 22's weights, f32: in-process fed images/s at B 1 and 16;
     the one-shot engine's rungs 1-16 as CUDA graphs, each rung's
     dispatch wall against its replay's device time, each replay
     bitwise == Executor.run, the running stats unchanged; int8 (53
     quant_conv2d, which dequantize the filter and run the f32 conv, and
     a quant_mul for the fc): the rung-16 wall against f32's, the
     dequantize's share of a dispatch's device time, weight bytes, top-1
     agreement with f32 on 256 images. The timed steps of 22 and 24 and
     the f32 rung-16 dispatches of 25 launch none of the hand-written
     kernels (their counts are checked to be 0); the int8 engine's fc
     launches the quantize kernel and K6 once a dispatch, counted as the
     path resnet50_serving_int8.

The second-to-last line is the kernel table as JSON (with the ResNet-50
results under "resnet50"); the last line is
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when
no CUDA card is visible or when run outside a checkout of the repo.
"""

import json
import os
import shutil
import subprocess
import sys
import threading
import time
import types

import numpy as np

try:
    import torch
except ImportError:
    sys.exit("chip_smoke: torch is not installed")

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA card visible (torch.cuda.is_available() "
             "is False); nothing was run")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
try:
    from paddle_tpu_torch import _build, amp, flags, monitor
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import quant
    from paddle_tpu_torch.executor import lower_ops_on
    from paddle_tpu_torch.ops import chunked_ce as ce
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import launch_counts
    from paddle_tpu_torch.ops import quant_ops as qo
    from paddle_tpu_torch.ops import registry as op_registry
    from paddle_tpu_torch.ops import transformer_ops as T
    from paddle_tpu_torch.serving import (EngineConfig, GenerationConfig,
                                          GenerationEngine, InferenceEngine,
                                          LMSpec, init_lm_weights)
    from paddle_tpu_torch.serving.http import make_server
    from paddle_tpu_torch.weights import (lm_weights_from_numpy,
                                          scope_from_numpy)
    from paddle_tpu_torch._device import use_full_f32
except ImportError as e:
    sys.exit(f"chip_smoke: the paddle_tpu_torch package is not beside "
             f"this script ({e}); run it from a checkout of the repo")

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, dense
# int8 on the tensor cores, HBM; f32-accurate products on the tensor
# cores take three dense TF32 products each (3xTF32, K1 and K2)
PEAK_F32_FLOPS = 67e12
PEAK_3XTF32_FLOPS = 495e12 / 3
PEAK_BF16_FLOPS = 989e12         # dense bf16 on the tensor cores
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12
TOL = 1e-4
SEED = 0
# GPT-2-small training at full width (bench.py's _mfu_bench model, f32)
VOCAB, HID, LAYERS, TRAIN_T, TRAIN_B = 50304, 768, 12, 1024, 8
SHORT_T, SHORT_B = 256, 32
LR = 1e-4
N_HEADS, HEAD_DIM = 12, 64
VIEW = 384            # page view of max_prompt_len 256 + max_new 128


def log(msg):
    print(msg, flush=True)


# -- phase 1: device ----------------------------------------------------------

def device_phase():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device: {name}")
    log(smi)                            # nvidia-smi's name, power limit
    return name, smi


# -- phase 3: kernel vs plain -------------------------------------------------

def make_case(rng, B, Tq, kv_len, q_start, sets):
    dev = torch.device("cuda")
    out = []
    for _ in range(sets):
        q, k, v = (torch.from_numpy(rng.randn(B, N_HEADS, T, HEAD_DIM)
                                    .astype(np.float32)).to(dev)
                   for T in (Tq, VIEW, VIEW))
        out.append((q, k, v))
    lens = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    starts = torch.tensor(q_start, dtype=torch.int32, device=dev)
    return out, lens, starts


def bound(flops, nbytes):
    """(ms, what bounds it): the larger of the f32 operations at the
    card's f32 FMA peak and the bytes at the HBM peak."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def bound_3xtf32(flops, nbytes):
    """The same work's least time with its products on the tensor cores
    at f32 accuracy (3xTF32, a third of the dense TF32 peak), in ms."""
    return max(flops / PEAK_3XTF32_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3


def live_mask(B, Tq, kv_len, q_start):
    col = np.arange(VIEW)[None, None, :]
    limit = np.minimum(np.asarray(kv_len)[:, None],
                       np.asarray(q_start)[:, None] + np.arange(Tq)[None]
                       + 1)[:, :, None]
    return col < limit                                   # [B, Tq, Tk]


def bound_of(B, Tq, kv_len, q_start):
    """Least time for this call's work on the card: its live (row, key)
    pairs' FLOPs (QK^T and PV, 2 each per D) at the f32 peak, against
    the bytes it must move (q, the live K/V rows, O and LSE) at the
    HBM peak; returns (ms, bound_by, ms with 3xTF32 tensor cores)."""
    live = live_mask(B, Tq, kv_len, q_start)
    pairs = int(live.sum()) * N_HEADS
    flops = 4.0 * HEAD_DIM * pairs
    kv_rows = int(np.minimum(kv_len, VIEW).sum()) * N_HEADS
    nbytes = 4 * (B * N_HEADS * Tq * HEAD_DIM * 2       # q in, O out
                  + 2 * kv_rows * HEAD_DIM              # live K and V
                  + B * N_HEADS * Tq)                   # LSE out
    return (*bound(flops, nbytes), bound_3xtf32(flops, nbytes))


def time_ms(fn, sets, reps=60):
    """Device ms per call: reps calls cycling through the input sets
    (more bytes than the L2 holds) captured once in a CUDA graph, the
    graph replayed between CUDA events. Timing the eager loop instead
    would measure the host's enqueue rate (~70 us a call from Python),
    not the card."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for s in sets:
            fn(*s)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(*sets[i % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_phase():
    rng = np.random.RandomState(SEED)
    scale = 1.0 / float(np.sqrt(HEAD_DIM))
    cases = {
        # cold prefill: q_start 0, ragged prompt lengths
        "prefill_cold": (4, 256, [256, 200, 77, 130], [0, 0, 0, 0]),
        # prefix-hit prefill: rows resume after page-aligned prefixes
        "prefill_hit": (4, 256, [300, 128 + 90, 256, 32 + 17],
                        [64, 128, 0, 32]),
        # decode: 8 slots, one row each at pos = kv_len - 1
        "decode": (8, 1, [384, 1, 17, 250, 100, 64, 333, 5],
                   [383, 0, 16, 249, 99, 63, 332, 4]),
    }
    results = []
    for name, (B, Tq, kv_len, q_start) in cases.items():
        sets, lens, starts = make_case(rng, B, Tq, kv_len, q_start, 6)
        q, k, v = sets[0]
        o, lse = fa.flash_attn_fwd(q, k, v, lens, starts, True, scale)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.flash_attn_fwd_plain(q, k, v, lens, starts,
                                                 True, scale)
        err_o = float((o - o_ref).abs().max())
        err_lse = float((lse - lse_ref).abs().max())
        if not (np.isfinite(err_o) and np.isfinite(err_lse)):
            raise AssertionError(f"{name}: non-finite kernel output")
        log(f"kernel {name}: q [{B},{N_HEADS},{Tq},{HEAD_DIM}] kv "
            f"{VIEW} max_abs_err O {err_o:.3e} LSE {err_lse:.3e} "
            f"(tol {TOL:g})")
        if err_o > TOL or err_lse > TOL:
            raise AssertionError(f"{name}: kernel disagrees with the plain "
                                 f"version beyond {TOL:g}")
        mask = torch.from_numpy(live_mask(B, Tq, kv_len, q_start)
                                )[:, None].cuda()
        ms = time_ms(lambda q, k, v: fa.flash_attn_fwd(
            q, k, v, lens, starts, True, scale), sets)
        plain_ms = time_ms(lambda q, k, v: fa.flash_attn_fwd_plain(
            q, k, v, lens, starts, True, scale), sets)
        library_ms = time_ms(
            lambda q, k, v: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=scale), sets)
        bound_ms, bound_by, tc_ms = bound_of(B, Tq, kv_len, q_start)
        log(f"kernel {name}: ms {ms:.4f} plain_ms {plain_ms:.4f} "
            f"library_ms {library_ms:.4f} bound_ms {bound_ms:.5f} "
            f"({bound_by}), 3xTF32 {tc_ms:.5f}")
        results.append({"case": name, "q": [B, N_HEADS, Tq, HEAD_DIM],
                        "kv": VIEW, "max_abs_err": max(err_o, err_lse),
                        "ms": ms, "plain_ms": plain_ms,
                        "library_ms": library_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "bound_3xtf32_ms": tc_ms})
    kv_len, q_start = cases["decode"][2:]
    results.append(paged_decode_case(rng, kv_len, q_start, scale))
    return results


PAGE_LEN, POOL_PAGES = 16, 1024    # the engine's page_len; 100 MB of K + V


def paged_decode_inputs(rng, kv_len, sets):
    """`sets` (q [8, 12, 1, 64], tables [8, 24]) over one K and one V
    pool plane [POOL_PAGES, 12, 16, 64]: every set's rows take their own
    pages in a shuffled order. The pool is NaN except the live rows
    (page 0, every unbacked table slot's trash page, pool rows past a
    row's length): a read of anything but a live key shows."""
    dev = torch.device("cuda")
    m = VIEW // PAGE_LEN
    shape = (POOL_PAGES, N_HEADS, PAGE_LEN, HEAD_DIM)
    pools = [np.full(shape, np.nan, np.float32) for _ in range(2)]
    free = iter(rng.permutation(np.arange(1, POOL_PAGES)))
    out = []
    for _ in range(sets):
        tables = np.zeros((len(kv_len), m), np.int32)
        for b, n_live in enumerate(kv_len):
            for slot in range(-(-n_live // PAGE_LEN)):
                page = tables[b, slot] = next(free)
                rows = min(PAGE_LEN, n_live - slot * PAGE_LEN)
                for pool in pools:
                    pool[page, :, :rows] = rng.randn(N_HEADS, rows, HEAD_DIM)
        q = rng.randn(len(kv_len), N_HEADS, 1, HEAD_DIM).astype(np.float32)
        out.append((torch.from_numpy(q).to(dev),
                    torch.from_numpy(tables).to(dev)))
    kp, vp = (torch.from_numpy(p).to(dev) for p in pools)
    return out, kp, vp


def paged_decode_case(rng, kv_len, q_start, scale):
    """K1 at Tq = 1 through the page table at the engine's geometry (8
    rows, page_len 16, 24 pages a row, kv 1-384): held to
    flash_attn_decode_plain at TOL, the same bits in two calls and for
    each row alone as in the batch of 8; timed beside its plain version,
    the decode bound, masked SDPA over the gathered view and the gather
    + that SDPA (the parent's path: yardsticks only)."""
    B = len(kv_len)
    sets, kp, vp = paged_decode_inputs(rng, kv_len, 8)
    lens = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    starts = torch.tensor(q_start, dtype=torch.int32, device="cuda")
    q, tables = sets[0]

    def run(q, tables, lens=lens, starts=starts):
        return fa.flash_attn_decode(q, kp, vp, tables, PAGE_LEN, lens,
                                    starts, scale)

    o, lse = run(q, tables)
    again = run(q, tables)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_attn_decode_plain(q, kp, vp, tables, PAGE_LEN,
                                                lens, starts, scale)
    err = max(float((o - o_ref).abs().max()),
              float((lse - lse_ref).abs().max()))
    same = torch.equal(o, again[0]) and torch.equal(lse, again[1])
    alone = all(
        torch.equal(ob[0], o[b]) and torch.equal(lb[0], lse[b])
        for b in range(B)
        for ob, lb in [run(q[b:b + 1], tables[b:b + 1], lens[b:b + 1],
                           starts[b:b + 1])])
    log(f"kernel decode_paged: q [{B},{N_HEADS},1,{HEAD_DIM}] page_len "
        f"{PAGE_LEN} x {VIEW // PAGE_LEN} pages (shuffled, NaN past the "
        f"live rows) max_abs_err {err:.3e} (tol {TOL:g}); two calls "
        f"bitwise equal: {same}; each row alone == in the batch: {alone}")
    if not err <= TOL:
        raise AssertionError("decode_paged: kernel disagrees with "
                             "flash_attn_decode_plain")
    if not (same and alone):
        raise AssertionError("decode_paged: bits differ between calls or "
                             "between a row alone and in the batch")
    mask = torch.from_numpy(live_mask(B, 1, kv_len, q_start))[:, None].cuda()

    def gathered(tables):      # the view with its dead keys zeroed
        return [torch.where(mask[:, :, 0, :, None], T._gather_pages(p, tables),
                            0.0) for p in (kp, vp)]

    views = [(q, *gathered(tables)) for q, tables in sets]
    ms = time_ms(run, sets)
    plain_ms = time_ms(lambda q, tables: fa.flash_attn_decode_plain(
        q, kp, vp, tables, PAGE_LEN, lens, starts, scale), sets)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda q, k, v: sdpa(q, k, v, attn_mask=mask,
                                              scale=scale), views)
    gather_ms = time_ms(lambda q, tables: sdpa(
        q, T._gather_pages(kp, tables), T._gather_pages(vp, tables),
        attn_mask=mask, scale=scale), sets)
    bound_ms, bound_by, tc_ms = bound_of(B, 1, kv_len, q_start)
    log(f"kernel decode_paged: ms {ms:.4f} plain_ms {plain_ms:.4f} "
        f"library_ms {library_ms:.4f} (SDPA over the gathered view; with "
        f"the gather {gather_ms:.4f}) bound_ms {bound_ms:.5f} ({bound_by})")
    return {"case": "decode_paged", "q": [B, N_HEADS, 1, HEAD_DIM],
            "kv": VIEW, "page_len": PAGE_LEN, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_with_gather_ms": gather_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_3xtf32_ms": tc_ms}


# -- phase 4: the engine behind HTTP -----------------------------------------

def post(port, body):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    t0 = time.perf_counter()
    conn.request("POST", "/v1/generate", json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    if resp.status != 200:
        raise AssertionError(f"/v1/generate -> {resp.status}: "
                             f"{resp.read()!r}")
    if not body.get("stream", True):
        out = json.loads(resp.read())
        conn.close()
        return out["tokens"], time.perf_counter() - t0
    toks, ttft = [], None
    for line in resp:
        ev = json.loads(line)
        if ev["event"] == "token":
            if ttft is None:
                ttft = time.perf_counter() - t0
            toks.append(ev["token"])
        elif ev["event"] == "error":
            raise AssertionError(f"in-band error: {ev}")
    conn.close()
    return toks, ttft


def post_concurrently(port, bodies):
    """POST every {key: body} to /v1/generate at once, one thread each;
    returns ({key: post()'s result}, [(key, error)])."""
    results, errors = {}, []

    def run(key, body):
        try:
            results[key] = post(port, body)
        except Exception as e:           # re-raised by the caller
            errors.append((key, e))

    threads = [threading.Thread(target=run, args=kv)
               for kv in bodies.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    return results, errors


def reference_greedy(w, spec, prompt, n_new):
    """Greedy tokens by recomputing the full causal forward for every
    new token — no KV cache, plain softmax attention — with the same
    f32 weights on the card."""
    H, n = spec.hidden_size, spec.num_heads
    D = H // n

    def ln(x, g, b):
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + 1e-5) * g + b

    dev = w["tok_emb"].device
    toks = list(prompt)
    with torch.inference_mode():
        for _ in range(n_new):
            T_ = len(toks)
            x = (w["tok_emb"][torch.tensor(toks, device=dev)]
                 + w["pos_emb"][:T_])
            causal = torch.ones(T_, T_, dtype=torch.bool,
                                device=dev).tril()
            for l in range(spec.num_layers):
                g = {k.split(".")[1]: v[l] for k, v in w.items()
                     if k.startswith("stack.")}
                h = ln(x, g["Ln1G"], g["Ln1B"])
                qkv = (h @ g["Wqkv"] + g["Bqkv"]).view(T_, n, 3, D)
                q, k, v = (qkv[:, :, m].transpose(0, 1) for m in range(3))
                s = (q @ k.transpose(1, 2)) / float(np.sqrt(D))
                p = torch.softmax(s.masked_fill(~causal, float("-inf")),
                                  -1)
                a = (p @ v).transpose(0, 1).reshape(T_, H)
                x = x + a @ g["Wproj"] + g["Bproj"]
                h = ln(x, g["Ln2G"], g["Ln2B"])
                up = torch.nn.functional.gelu(h @ g["Wup"] + g["Bup"],
                                              approximate="tanh")
                x = x + up @ g["Wdown"] + g["Bdown"]
            logits = ln(x[-1], w["ln_f.w_0"], w["ln_f.w_1"]) @ w["lm_head.w"]
            toks.append(int(torch.argmax(logits)))
    return toks[len(prompt):]


def engine_phase(smi):
    spec = LMSpec(50304, 768, 12, 12, 1024)
    flags.set_flag("metrics", True)     # serving_lm.* histograms
    t0 = time.perf_counter()
    weights = init_lm_weights(spec, seed=SEED)
    cfg = GenerationConfig(max_slots=8, prefill_batch=4, max_prompt_len=256,
                           max_new_tokens=128, paged=True, page_len=16,
                           prefix_cache=True)
    engine = GenerationEngine(spec, weights, config=cfg, ready=False)
    log(f"engine: GPT-2-small {spec.to_meta()} on {engine.device}, "
        f"paged page_len {cfg.page_len} x {cfg.num_pages} pages, "
        f"built in {time.perf_counter() - t0:.1f} s; hbm {engine.stats()['hbm']}")
    resident = engine_memory()
    t0 = time.perf_counter()
    rungs = engine.warmup()
    st = engine.stats()
    log(f"engine: warmed {len(rungs)} rungs in "
        f"{time.perf_counter() - t0:.1f} s: aot_status {st['aot_status']}, "
        f"{len(st['aot_rungs'])} CUDA graphs {st['aot_rungs']}; "
        f"{memory_line(resident, st['hbm'])}")
    if st["aot_status"] != "cuda_graph" or st["aot_rungs"] != rungs \
            or rungs != cfg.rung_keys():
        raise AssertionError(f"expected every rung {cfg.rung_keys()} "
                             f"captured as a CUDA graph, got "
                             f"{st['aot_status']} {st['aot_rungs']}")
    server = make_server(engine, port=0)
    port = server.server_address[1]
    srv = threading.Thread(target=server.serve_forever, daemon=True)
    srv.start()

    rng = np.random.RandomState(SEED + 1)
    n_new = 32
    prompts = [rng.randint(0, spec.vocab_size, size=L).tolist()
               for L in (200, 37, 120, 64, 90)]
    # shares the first 128 tokens (8 whole pages) of prompts[0]
    shared = prompts[0][:128] + rng.randint(0, spec.vocab_size,
                                            size=40).tolist()
    # the main path starts here: K1 launches and page-view gathers,
    # counted through the graphs' replays
    fa.flash_attn_fwd.launches = fa.gather_pages.calls = 0
    t_start = time.perf_counter()
    results, errors = post_concurrently(port, {
        i: {"prompt": prompts[i], "max_new_tokens": n_new,
            "stream": i < 4} for i in range(5)})
    for key, prompt in (("repeat", prompts[1]), ("shared", shared)):
        got, failed = post_concurrently(port, {key: {
            "prompt": prompt, "max_new_tokens": n_new}})
        results.update(got)
        errors += failed
    wall = time.perf_counter() - t_start
    launches, gathers = fa.flash_attn_fwd.launches, fa.gather_pages.calls
    server.shutdown()
    engine.shutdown(drain=True, timeout=600)
    if errors:
        raise AssertionError(f"requests failed: {errors}")
    st = engine.stats()
    for key, (toks, _) in results.items():
        if len(toks) != n_new:
            raise AssertionError(f"request {key}: {len(toks)} tokens, "
                                 f"asked {n_new}")
    if results["repeat"][0] != results[1][0]:
        raise AssertionError("a repeated prompt returned other tokens")
    checks = {"requests": len(results), "prefix_hits": st["prefix_hits"],
              "prefills": st["prefills"], "decode_steps": st["decode_steps"],
              "page_allocs": st["page_allocs"],
              "page_frees": st["page_frees"],
              "slot_allocs": st["slot_allocs"],
              "slot_frees": st["slot_frees"], "k1_launches": launches,
              "page_gathers": gathers}
    log(f"engine: {checks}")
    if st["prefix_hits"] < 2:
        raise AssertionError("expected a full and a partial prefix hit")
    if st["page_allocs"] != st["page_frees"] \
            or st["slot_allocs"] != st["slot_frees"]:
        raise AssertionError("page/slot allocs != frees after drain")
    want = spec.num_layers * (st["prefills"] + st["decode_steps"])
    if launches != want:
        raise AssertionError(f"K1 launched {launches} times on the main "
                             f"path, expected layers x (prefills + decode "
                             f"steps) = {want}")
    # only the prefills gather page views (K and V, each layer): every
    # decode step reads the pool through its tables
    if gathers != 2 * spec.num_layers * st["prefills"]:
        raise AssertionError(f"{gathers} page gathers on the main path,"
                             f" expected 2 x layers x prefills = "
                             f"{2 * spec.num_layers * st['prefills']}: a "
                             f"decode step gathered")

    use_full_f32()
    w = lm_weights_from_numpy(weights, spec)
    for key, prompt in ((0, prompts[0]), (3, prompts[3]),
                        ("shared", shared)):
        ref = reference_greedy(w, spec, prompt, n_new)
        if ref != results[key][0]:
            raise AssertionError(f"request {key}: served tokens differ from "
                                 f"the full-recompute reference\n"
                                 f"{results[key][0]}\n{ref}")
    log("engine: served tokens == full-recompute reference for 3 requests")
    graph_kernels(engine, launches, gathers, smi)

    ttfts = [results[i][1] for i in range(4)]
    tokens = sum(len(t) for t, _ in results.values())
    decode_ms = 1e3 * monitor.snapshot()["histograms"][
        "serving_lm.decode_step_s"]["mean"]
    log(f"engine (CUDA graphs): TTFT p50 {1e3 * float(np.median(ttfts)):.1f} "
        f"ms over the 4 concurrent streams, decode {decode_ms:.2f} ms/step "
        f"(8 slots), {tokens / wall:.1f} tokens/s over {wall:.2f} s | {smi}")
    served = {"graph": {"ttft_p50_ms": 1e3 * float(np.median(ttfts)),
                        "decode_step_ms": decode_ms,
                        "tokens_per_s": tokens / wall}}
    served["eager"] = eager_engine_run(spec, weights, cfg, prompts, n_new,
                                       results, smi)
    steps = decode_step_breakdown(engine, smi)
    steps["prefill"] = prefill_rung_walls(engine, smi)
    steps["served"] = served
    return launches, steps


def graph_kernels(engine, launches, gathers, smi):
    """What one replay of the engine's decode graph and of its
    prefill:4x256 graph runs on the card, read by the profiler: the same
    kernels, name by name and launch by launch (memsets by count), as
    the eager function on the same inputs; as many K1 launches as the rung adds to
    `flash_attn_fwd.launches` on each replay (the main path's counts);
    and as many page gathers as the eager function counts, which for
    the decode step is none."""
    cfg, L = engine.config, engine.spec.num_layers
    S, m = cfg.max_slots, cfg.pages_per_seq
    rng = np.random.RandomState(SEED + 11)
    cases = {
        "decode": (engine._decode_fn, 0, (
            np.arange(S, dtype=np.int32), np.full(S, 300, np.int32),
            np.ones(S, bool),
            np.arange(1, S * m + 1, dtype=np.int32).reshape(S, m))),
        "prefill:4x256": (engine._prefill_fn, 2 * L, (
            rng.randint(0, engine.spec.vocab_size, (4, 256)).astype(
                np.int32), np.zeros(4, np.int32), np.full(4, 256, np.int32),
            np.arange(1, 4 * m + 1, dtype=np.int32).reshape(4, m)))}
    out = {}
    for key, (eager_fn, want_gathers, host) in cases.items():
        engine._dispatch(key, eager_fn, *host)      # the graph's inputs
        rung = engine._graphs._rungs[key]
        carried = {(w, a): n for w, a, n in rung.deltas}
        replay = device_kernels(rung.graph.replay, launches=True)
        args = engine._to_device(*host)
        with torch.inference_mode():
            with launch_counts.tallied() as counted:
                eager_fn(*args)
            eager = device_kernels(lambda: eager_fn(*args), launches=True)
        k1 = carried.get((fa.flash_attn_fwd, "launches"), 0)
        carried_gathers = carried.get((fa.gather_pages, "calls"), 0)
        eager_gathers = counted.get((fa.gather_pages, "calls"), 0)
        same = launches_by_name(replay) == launches_by_name(eager)
        out[key] = {"replay_kernels": sum(c for _, c in replay.values()),
                    "eager_kernels": sum(c for _, c in eager.values()),
                    "same_kernels": same, "replay_k1": k1_of(replay),
                    "carried_k1": k1, "carried_gathers": carried_gathers,
                    "eager_gathers": eager_gathers}
        log(f"graph kernels, {key}: one replay runs {out[key]}; the main "
            f"path's counts: K1 {launches}, page gathers {gathers} | {smi}")
        if not same:
            r, e = launches_by_name(replay), launches_by_name(eager)
            diff = {n: (r.get(n, 0), e.get(n, 0)) for n in set(r) | set(e)
                    if r.get(n, 0) != e.get(n, 0)}
            raise AssertionError(f"{key}: the graph's replay and the eager "
                                 f"step run other kernels (name: replay, "
                                 f"eager launches) {diff}")
        if not k1_of(replay) == k1 == L:
            raise AssertionError(f"{key}: a replay ran {k1_of(replay)} K1 "
                                 f"kernels, the rung carries {k1}, the "
                                 f"model has {L} layers")
        if not carried_gathers == eager_gathers == want_gathers:
            raise AssertionError(f"{key}: the rung carries "
                                 f"{carried_gathers} page gathers, the "
                                 f"eager step made {eager_gathers}, "
                                 f"expected {want_gathers}")
    return out


def launches_by_name(kernels):
    """{kernel name: launches} of device_kernels(..., launches=True)'s
    result, memsets counted as one name: the profiler names a graph's
    memset nodes "memset32" or "Memset (Unknown)", the same memsets
    launched eagerly "Memset (Device)"."""
    out = {}
    for name, (_, n) in kernels.items():
        name = "memset" if "memset" in name.lower() else name
        out[name] = out.get(name, 0) + n
    return out


def k1_of(kernels):
    """K1's launches in device_kernels(..., launches=True)'s result."""
    return sum(n for name, (_, n) in kernels.items()
               if "flash_decode_" in name or "flash_fwd_" in name)


def eager_engine_run(spec, weights, cfg, prompts, n_new, results, smi):
    """The five concurrent requests again, on a second engine of the same
    weights whose rungs run eagerly (its graph runner removed): the
    yardstick for the graphs' TTFT and decode step. Its tokens must equal
    the graph engine's, bit for bit."""
    engine = GenerationEngine(spec, weights, config=cfg, ready=False)
    engine._graphs = None
    resident = engine_memory()
    engine.warmup()
    log(f"engine (eager rungs): warmed; {memory_line(resident, engine._hbm)}")
    server = make_server(engine, port=0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    monitor.reset()
    t_start = time.perf_counter()
    got, errors = post_concurrently(port, {
        i: {"prompt": prompts[i], "max_new_tokens": n_new,
            "stream": i < 4} for i in range(5)})
    wall = time.perf_counter() - t_start
    server.shutdown()
    engine.shutdown(drain=True, timeout=600)
    if errors:
        raise AssertionError(f"eager engine requests failed: {errors}")
    for i in range(5):
        if got[i][0] != results[i][0]:
            raise AssertionError(f"request {i}: the eager engine's tokens "
                                 f"differ from the CUDA-graph engine's")
    ttft = 1e3 * float(np.median([got[i][1] for i in range(4)]))
    decode_ms = 1e3 * monitor.snapshot()["histograms"][
        "serving_lm.decode_step_s"]["mean"]
    tokens = sum(len(t) for t, _ in got.values())
    log(f"engine (eager rungs, the same 5 concurrent requests): TTFT p50 "
        f"{ttft:.1f} ms, decode {decode_ms:.2f} ms/step, "
        f"{tokens / wall:.1f} tokens/s over {wall:.2f} s; tokens == the "
        f"CUDA-graph engine's | {smi}")
    del engine
    torch.cuda.empty_cache()
    return {"ttft_p50_ms": ttft, "decode_step_ms": decode_ms,
            "tokens_per_s": tokens / wall}


def engine_memory():
    """(allocated, reserved) bytes of a just-built engine (weights and KV
    planes), the peak counter reset: the baseline of memory_line."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()


def memory_line(resident, hbm):
    """What an engine's warmup added on the card, beside its price."""
    a0, r0 = resident
    return (f"memory: resident {a0} B allocated / {r0} B reserved before "
            f"warmup; after it {torch.cuda.memory_allocated() - a0} B more "
            f"allocated, {torch.cuda.memory_reserved() - r0} B more "
            f"reserved, peak {torch.cuda.max_memory_allocated() - a0} B "
            f"above the resident; priced transients "
            f"{hbm['transient_bytes']} B, priced peak "
            f"{hbm['peak_hbm_bytes']} B, reserved now "
            f"{torch.cuda.memory_reserved()} B")


def graph_replay_ms(graphs, key, reps=20):
    """Device ms of one replay of an engine's captured rung (its inputs
    as the last dispatch left them), between CUDA events."""
    graph = graphs._rungs[key].graph
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def eager_and_graph_walls(eager, graph, reps):
    """Host-clock ms a call of eager() and graph(), each timed over reps
    calls after 3 warm ones, in turns eager, graph, graph, eager; the
    outputs of the two must be equal, bit for bit. Returns ({"eager":
    [ms, ms], "graph": [ms, ms]}, the graph's output)."""
    walls = {"eager": [], "graph": []}
    outs = {}
    for name in ("eager", "graph", "graph", "eager"):
        fn = eager if name == "eager" else graph
        for _ in range(3):
            outs[name] = fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        walls[name].append(1e3 * (time.perf_counter() - t0) / reps)
    if not all(np.array_equal(a, b) for a, b in zip(outs["eager"],
                                                   outs["graph"])):
        raise AssertionError("the CUDA graph's output differs from the "
                             "eager step's on the same inputs")
    return walls, outs["graph"]


def prefill_rung_walls(engine, smi, reps=10):
    """Two prefill rungs on fixed inputs: prefill:4x256 (the four
    concurrent prompts' rung) and prefill:1x64 (one short prompt), each
    row over its own real pages: the eager function's wall (inputs to
    the card, tokens back) against the rung's CUDA graph through the
    engine's dispatch, their tokens bitwise equal, beside the device
    time of the graph's replay."""
    cfg = engine.config
    m = cfg.pages_per_seq
    rng = np.random.RandomState(SEED + 9)
    out = {}
    for b, t in ((4, 256), (1, 64)):
        host = (rng.randint(0, engine.spec.vocab_size, (b, t)).astype(
                    np.int32), np.zeros(b, np.int32),
                np.full(b, t, np.int32),
                np.arange(1, b * m + 1, dtype=np.int32).reshape(b, m))

        def eager():
            with torch.inference_mode():
                return [engine._prefill_fn(
                    *engine._to_device(*host)).cpu().numpy()]

        walls, _ = eager_and_graph_walls(
            eager, lambda: [engine._dispatch_prefill(*host)], reps)
        key = f"prefill:{b}x{t}"
        device_ms = graph_replay_ms(engine._graphs, key, reps)
        out[key] = {"eager_wall_ms": walls["eager"],
                    "graph_wall_ms": walls["graph"],
                    "device_ms": device_ms}
        log(f"{key}: wall eager {walls['eager'][0]:.3f} / "
            f"{walls['eager'][1]:.3f} ms, CUDA graph {walls['graph'][0]:.3f}"
            f" / {walls['graph'][1]:.3f} ms (turns eager, graph, graph, "
            f"eager; tokens equal, bitwise), device {device_ms:.3f} ms (the "
            f"graph's replay); busy share eager "
            f"{device_ms / np.mean(walls['eager']):.3f}, graph "
            f"{device_ms / np.mean(walls['graph']):.3f} | {smi}")
    return out


# a decode step's device kernels by class, from their profiler names
DECODE_CLASSES = (("K1", ("flash_decode_", "flash_fwd_")),
                  ("index", ("index",)),
                  ("copy", ("copy",)),
                  ("cuBLAS", ("gemm", "nvjet", "xmma", "cutlass")))


def kernel_classes(kernels, classes):
    """{class: [us, launches]} of device_kernels(..., launches=True)'s
    {name: (us, launches)}; a name matching no class counts as
    "elementwise"."""
    out = {c: [0.0, 0] for c, _ in classes}
    out["elementwise"] = [0.0, 0]
    for name, (us, n) in kernels.items():
        c = next((c for c, frags in classes
                  if any(f in name for f in frags)), "elementwise")
        out[c][0] += us
        out[c][1] += n
    return out


def decode_step_breakdown(engine, smi, reps=20):
    """Where one paged decode step's time goes, 8 live slots at position
    300 over their own pages, three ways on the same inputs: the host-
    clock wall of the eager step (inputs to the card, `_decode_fn`,
    tokens back), the wall of the engine's own dispatch (its CUDA graph:
    inputs staged, one replay, tokens back), their tokens bitwise equal,
    and the device time of the step (the engine's graph replayed, and
    the eager function captured anew, between CUDA events); device /
    wall is the card's busy share. Then a profiled eager step's kernels
    by class: K1, index and copy kernels (the K/V row writes), cuBLAS
    products, the elementwise rest."""
    cfg = engine.config
    S, m = cfg.max_slots, cfg.pages_per_seq
    host = (np.arange(S, dtype=np.int32), np.full(S, 300, np.int32),
            np.ones(S, bool),
            np.arange(1, S * m + 1, dtype=np.int32).reshape(S, m))

    def eager():
        with torch.inference_mode():
            return [engine._decode_fn(
                *engine._to_device(*host)).cpu().numpy()]

    walls, _ = eager_and_graph_walls(
        eager, lambda: [engine._dispatch_decode(*host)], reps)
    eager_ms, graph_ms = (float(np.mean(walls[k]))
                          for k in ("eager", "graph"))
    graph_device_ms = graph_replay_ms(engine._graphs, "decode", reps)
    args = engine._to_device(*host)
    with torch.inference_mode():
        device_ms = time_ms(lambda: engine._decode_fn(*args), [()], reps)
        kernels = device_kernels(lambda: engine._decode_fn(*args),
                                 launches=True)
    classes = kernel_classes(kernels, DECODE_CLASSES)
    launches = sum(n for _, n in classes.values())
    shown = {c: (round(us, 1), n) for c, (us, n) in classes.items()}
    log(f"decode step: wall eager {walls['eager'][0]:.3f} / "
        f"{walls['eager'][1]:.3f} ms, CUDA graph {walls['graph'][0]:.3f} / "
        f"{walls['graph'][1]:.3f} ms (turns eager, graph, graph, eager; "
        f"tokens equal, bitwise); device {graph_device_ms:.3f} ms (the "
        f"engine's graph) / {device_ms:.3f} ms (the eager step captured "
        f"anew); busy share eager {graph_device_ms / eager_ms:.3f}, graph "
        f"{graph_device_ms / graph_ms:.3f}; profiled eager step: "
        f"{launches} kernels, "
        f"{sum(us for us, _ in classes.values()) / 1e3:.3f} ms, by class "
        f"(us, launches) {shown} | {smi}")
    return {"wall_ms": eager_ms, "graph_wall_ms": graph_ms,
            "walls_ms": walls, "device_ms": device_ms,
            "graph_device_ms": graph_device_ms, "launches": launches,
            "classes_us": {c: us for c, (us, _) in classes.items()},
            "classes_launches": {c: n for c, (_, n) in classes.items()}}


# -- phase 5: backward kernels vs plain --------------------------------------

def live_pairs(B, Tq, Tk, kv_len, causal):
    """Live (row, key) pairs of one head summed over the batch."""
    rows = np.arange(Tq)[None, :]
    lim = np.minimum(np.asarray(kv_len)[:, None], Tk)
    if causal:
        lim = np.minimum(lim, rows + 1)
    return int(np.maximum(lim, 0).sum())


def attn_bound(B, Tq, Tk, kv_len, causal, products, ins, outs, n=N_HEADS):
    """The least time for `products` T x T x D products over the live
    pairs of n heads, against `ins` q-sized inputs read, `outs` outputs
    written and the [B, n, Tq] row statistics (lse and, backward,
    delta): (ms, bound_by, ms with 3xTF32 tensor cores)."""
    pairs = live_pairs(B, Tq, Tk, kv_len, causal) * n
    elems = B * n * HEAD_DIM
    nbytes = 4 * (elems * (Tq + 2 * Tk)                 # q, k, v
                  + elems * (ins - 3) * Tq               # dO (backward)
                  + elems * sum(outs)                    # outputs
                  + B * n * Tq * (1 if ins == 3 else 2))
    flops = 2.0 * HEAD_DIM * pairs * products
    return (*bound(flops, nbytes), bound_3xtf32(flops, nbytes))


def time_queued(fn, reps=20):
    """Device ms per call of an eager call that the host enqueues more
    slowly than the card runs it (autograd's backward of a fast library
    kernel): a spin kernel holds the card while the host enqueues `reps`
    calls, so the events around the calls time their device work only.
    (Profiled device time is no substitute: the profiler drops some
    calls' kernels.) The spin lasts twice a synchronised loop of the
    same calls; a host slower than that is retried."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    spin_ms = 2e3 * (time.perf_counter() - t0) + 20.0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10**7)
    end.record()
    end.synchronize()
    cycles_per_ms = 1e7 / start.elapsed_time(end)
    for _ in range(3):
        torch.cuda._sleep(int(spin_ms * cycles_per_ms))
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        enqueue_ms = 1e3 * (time.perf_counter() - t0)
        end.record()
        end.synchronize()
        if enqueue_ms < spin_ms:
            break
        log(f"time_queued: the host took {enqueue_ms:.1f} ms to enqueue, "
            f"longer than the {spin_ms:.1f} ms spin; again")
        spin_ms *= 2
    return start.elapsed_time(end) / reps


def rel_err(got, ref):
    return float((got - ref).abs().max()) / max(1.0,
                                                float(ref.abs().max()))


def bwd_inputs(rng, B, Tq, Tk, kv_len, causal, scale, n=N_HEADS):
    dev = torch.device("cuda")
    q, k, v, do = (torch.from_numpy(rng.randn(B, n, T, HEAD_DIM)
                                    .astype(np.float32)).to(dev)
                   for T in (Tq, Tk, Tk, Tq))
    lens = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    o, lse = fa.flash_attn_fwd(q, k, v, lens, torch.zeros_like(lens),
                               causal, scale)
    delta = (do * o).sum(-1).contiguous()
    return (q, k, v, do, lse, delta, lens)


def device_kernels(fn, calls=4, launches=False):
    """{device kernel name: us per call} over `calls` profiled calls of
    fn: names the backend behind a library yardstick (its time is
    measured by events) and breaks a decode step down by kernel. Several
    calls, because the profiler now and then drops a call's device
    events; each name's time is its mean over the calls that recorded
    it. With `launches`, each value is (us, launches a call), the
    launches the most any call recorded."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(calls):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = {}
        for ev in prof.events():
            if getattr(ev, "device_type", None) == \
                    torch.autograd.DeviceType.CUDA:
                us, n = names.get(ev.name, (0.0, 0))
                names[ev.name] = (us + float(ev.time_range.elapsed_us()),
                                  n + 1)
        per_call.append(names)
    seen = {}
    for call in per_call:
        for n, got in call.items():
            seen.setdefault(n, []).append(got)
    names = {n: (round(float(np.mean([us for us, _ in got])), 1),
                 max(k for _, k in got)) for n, got in seen.items()}
    order = sorted(names.items(), key=lambda kv: -kv[1][0])
    return {n: (v if launches else v[0]) for n, v in order}


def sdpa_backward(args, scale):
    """Device ms of the backward of torch's causal SDPA (the yardstick
    of K2-K4) on a backward case's q, k, v, dO, and its kernels' names."""
    q, k, v, do = (t.clone().requires_grad_(i < 3)
                   for i, t in enumerate(args[:4]))
    out = torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale)
    grad = (lambda: torch.autograd.grad(out, (q, k, v), do,
                                        retain_graph=True))
    ms = time_queued(grad)
    names = device_kernels(grad)
    log(f"SDPA backward [{', '.join(map(str, q.shape))}] device kernels: "
        f"{names}")
    return ms, names


BWD_KERNELS = {
    # name: (call returning a tuple, which of (dq, dk, dv) it returns,
    # T x T x D products it computes, the TPU kernel it replaces)
    "flash_attn_bwd_fused": (lambda *a: fa.flash_attn_bwd_fused(*a),
                             (0, 1, 2), 5, "paddle_tpu/ops/pallas_attention.py:513"),
    "flash_attn_bwd_dq": (lambda *a: (fa.flash_attn_bwd_dq(*a),),
                          (0,), 3, "paddle_tpu/ops/pallas_attention.py:400"),
    "flash_attn_bwd_dkv": (lambda *a: fa.flash_attn_bwd_dkv(*a),
                           (1, 2), 4, "paddle_tpu/ops/pallas_attention.py:450"),
}


def backward_kernel_phase(smi):
    """K2, K3 and K4 against the plain backward at both training shapes
    (T 1024 and the short T 256), a ragged and a Tq != Tk case; all
    three timed at T 1024, K2 also at T 256, beside SDPA's backward at
    the same shapes; K1 timed at the T 1024 training shape. Tolerance:
    1e-4 of the larger of 1 and the plain gradient's largest element —
    f32 sums over up to 1024 keys (rows) in 64-wide tiles (K2 with
    3xTF32 tensor-core products) against one matmul per product."""
    rng = np.random.RandomState(SEED + 2)
    scale = 1.0 / float(np.sqrt(HEAD_DIM))
    B, T = TRAIN_B, TRAIN_T
    full = [T] * B
    cases = {
        "train": (B, T, T, full),
        # the short-context training shape, where the route is K2
        "short": (SHORT_B, SHORT_T, SHORT_T, [SHORT_T] * SHORT_B),
        "ragged": (4, 600, 600, [600, 333, 64, 1]),
        "cross": (2, 200, 700, [700, 450]),
    }
    errs = {name: 0.0 for name in BWD_KERNELS}
    for case, (b, tq, tk, kv_len) in cases.items():
        args = bwd_inputs(rng, b, tq, tk, kv_len, True, scale)
        ref = fa.flash_attn_bwd_fused_plain(*args, True, scale)
        for name, (call, idx, _, _) in BWD_KERNELS.items():
            got = call(*args, True, scale)
            torch.cuda.synchronize()
            err = max(rel_err(g, ref[i]) for g, i in zip(got, idx))
            abs_err = max(float((g - ref[i]).abs().max())
                          for g, i in zip(got, idx))
            errs[name] = max(errs[name], abs_err)
            log(f"backward {name} {case}: q [{b},{N_HEADS},{tq},"
                f"{HEAD_DIM}] k [{tk}] max_abs_err {abs_err:.3e}, "
                f"relative {err:.3e} (tol {TOL:g} relative)")
            if not np.isfinite(err) or err > TOL:
                raise AssertionError(f"{name} ({case}) disagrees with the "
                                     f"plain backward beyond {TOL:g}")
        del args, ref
    plains = {"flash_attn_bwd_fused": fa.flash_attn_bwd_fused_plain,
              "flash_attn_bwd_dq": fa.flash_attn_bwd_dq_plain,
              "flash_attn_bwd_dkv": fa.flash_attn_bwd_dkv_plain}
    timed = {}       # kernel -> [case dicts]
    # every kernel at T 1024 (K3 + K4's main path), K2 also at T 256 (its
    # own main path)
    for case, (b, t, names) in {
            "train": (B, T, tuple(BWD_KERNELS)),
            "short": (SHORT_B, SHORT_T, ("flash_attn_bwd_fused",))}.items():
        full_b = [t] * b
        sets = [bwd_inputs(rng, b, t, t, full_b, True, scale)
                for _ in range(2)]
        lib_bwd, lib_names = sdpa_backward(sets[0], scale)
        for name in names:
            call, _, products, _ = BWD_KERNELS[name]
            outs = {"flash_attn_bwd_fused": (t, t, t),
                    "flash_attn_bwd_dq": (t,),
                    "flash_attn_bwd_dkv": (t, t)}[name]
            r = {"case": case, "q": [b, N_HEADS, t, HEAD_DIM],
                 "ms": time_ms(lambda *a: call(*a, True, scale), sets,
                               reps=10),
                 "plain_ms": time_ms(lambda *a: plains[name](
                     *a, True, scale), sets, reps=4),
                 "library_ms": lib_bwd, "library_kernels": lib_names}
            r["bound_ms"], r["bound_by"], r["bound_3xtf32_ms"] = attn_bound(
                b, t, t, full_b, True, products, 4, outs)
            timed.setdefault(name, []).append(r)
            log(f"backward {name} {case} [{b},{N_HEADS},{t},{HEAD_DIM}]: "
                f"ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} "
                f"library_ms (SDPA backward) {lib_bwd:.4f} bound_ms "
                f"{r['bound_ms']:.5f} ({r['bound_by']}), 3xTF32 "
                f"{r['bound_3xtf32_ms']:.5f} | {smi}")
        if case == "train":
            k1_sets = [(s_[0], s_[1], s_[2]) for s_ in sets]
            k1_lens = sets[0][6]
            pair = sum(timed[k_][0]["ms"] for k_ in (
                "flash_attn_bwd_dq", "flash_attn_bwd_dkv"))
            fused = timed["flash_attn_bwd_fused"][0]["ms"]
            log(f"backward route at T {t} [{b},{N_HEADS},{t},{HEAD_DIM}]: "
                f"split K3 + K4 {pair:.4f} ms | fused K2 {fused:.4f} ms | "
                f"SDPA backward {lib_bwd:.4f} ms; pair / SDPA "
                f"{pair / lib_bwd:.3f}, pair / K2 {pair / fused:.3f} | {smi}")
    # the top-level numbers are each kernel's main-path shape: T 256 for
    # K2, T 1024 for K3 and K4
    results = {}
    for name, cases_ in timed.items():
        top = cases_[-1]
        results[name] = {k_: top[k_] for k_ in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "bound_3xtf32_ms")}
        results[name].update(max_abs_err=errs[name], case=top["case"],
                             cases=cases_)
    # K1 at the training shape, with the forward SDPA's kernels named
    starts = torch.zeros(B, dtype=torch.int32, device="cuda")
    k1 = {"case": "train", "q": [B, N_HEADS, T, HEAD_DIM], "kv": T}
    k1["ms"] = time_ms(lambda q, k, v: fa.flash_attn_fwd(
        q, k, v, k1_lens, starts, True, scale), k1_sets, reps=20)
    k1["plain_ms"] = time_ms(lambda q, k, v: fa.flash_attn_fwd_plain(
        q, k, v, k1_lens, starts, True, scale), k1_sets, reps=5)
    sdpa = (lambda q, k, v: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale))
    k1["library_ms"] = time_ms(sdpa, k1_sets, reps=20)
    k1["library_kernels"] = device_kernels(lambda: sdpa(*k1_sets[0]))
    k1["bound_ms"], k1["bound_by"], k1["bound_3xtf32_ms"] = attn_bound(
        B, T, T, full, True, 2, 3, (T,))
    o, lse = fa.flash_attn_fwd(*k1_sets[0], k1_lens, starts, True, scale)
    o_ref, lse_ref = fa.flash_attn_fwd_plain(*k1_sets[0], k1_lens, starts,
                                             True, scale)
    k1["max_abs_err"] = max(float((o - o_ref).abs().max()),
                            float((lse - lse_ref).abs().max()))
    if k1["max_abs_err"] > TOL:
        raise AssertionError("K1 disagrees with its plain version at the "
                             "training shape")
    log(f"kernel flash_attn_fwd train: ms {k1['ms']:.4f} plain_ms "
        f"{k1['plain_ms']:.4f} library_ms {k1['library_ms']:.4f} bound_ms "
        f"{k1['bound_ms']:.5f} ({k1['bound_by']}), 3xTF32 "
        f"{k1['bound_3xtf32_ms']:.5f}; err {k1['max_abs_err']:.3e} | {smi}")
    log(f"SDPA forward (causal, f32) device kernels: "
        f"{k1['library_kernels']}")
    return results, k1


# -- phase 6: K5 vs plain -----------------------------------------------------

def lse_case(rng, N, hid, case, smi):
    """K5 against its plain version at x [N, hid] @ w [hid, 50304], and
    against itself (two calls, bitwise), timed beside the plain version,
    logsumexp(x @ w) and the bound. Tolerance 1e-4 absolute on values
    near log(V) = 10.8: f32-accurate dot products over hid (3xTF32,
    summed a 64-wide k tile at a time) and a sum of 50304 exponentials,
    in other orders."""
    dev = torch.device("cuda")
    sets = [(torch.from_numpy(rng.randn(N, hid).astype(np.float32)).to(dev),
             torch.from_numpy((rng.randn(hid, VOCAB) * 0.02)
                              .astype(np.float32)).to(dev))
            for _ in range(2)]
    got = ce.lm_head_lse(*sets[0])
    again = ce.lm_head_lse(*sets[0])
    torch.cuda.synchronize()
    ref = ce.lm_head_lse_plain(*sets[0])
    err = float((got - ref).abs().max())
    log(f"kernel lm_head_lse: x [{N},{hid}] w [{hid},{VOCAB}] "
        f"max_abs_err {err:.3e} (tol {TOL:g}); two calls bitwise equal: "
        f"{bool(torch.equal(got, again))}")
    if not np.isfinite(err) or err > TOL:
        raise AssertionError("lm_head_lse disagrees with its plain version")
    if not torch.equal(got, again):
        raise AssertionError("lm_head_lse: two calls on the same inputs "
                             "differ (the split merge must be in order)")
    r = {"case": case, "x": [N, hid], "max_abs_err": err,
         "ms": time_ms(ce.lm_head_lse, sets, reps=6),
         "plain_ms": time_ms(ce.lm_head_lse_plain, sets, reps=3),
         "library_ms": time_ms(lambda x, w: torch.logsumexp(x @ w, dim=1),
                               sets, reps=3)}
    flops, nbytes = 2.0 * N * hid * VOCAB, 4.0 * (N * hid + hid * VOCAB + N)
    r["bound_ms"], r["bound_by"] = bound(flops, nbytes)
    r["bound_3xtf32_ms"] = bound_3xtf32(flops, nbytes)
    log(f"kernel lm_head_lse {case}: ms {r['ms']:.4f} plain_ms "
        f"{r['plain_ms']:.4f} library_ms (logsumexp(x @ w)) "
        f"{r['library_ms']:.4f} bound_ms {r['bound_ms']:.5f} "
        f"({r['bound_by']}) | {smi}")
    del sets, got, again, ref
    torch.cuda.empty_cache()
    return r


# -- phase 7/8: training ------------------------------------------------------

def build_gpt2(T):
    pt.framework.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        tok = pt.layers.data("tok", [T, 1], dtype="int64")
        nxt = pt.layers.data("nxt", [T, 1], dtype="int64")
        cost = pt.models.transformer.transformer_lm_cost(
            tok, nxt, VOCAB, hid=HID, num_layers=LAYERS, num_heads=N_HEADS,
            max_len=T)
        _, params_grads = pt.AdamOptimizer(LR).minimize(cost)
    return main, startup, cost, params_grads


def token_batch(B, T, seed):
    rng = np.random.RandomState(seed)
    return {"tok": rng.randint(0, VOCAB, (B, T, 1)).astype(np.int64),
            "nxt": rng.randint(0, VOCAB, (B, T, 1)).astype(np.int64)}


def reference_loss_and_grads(w, feed):
    """The same model as plain PyTorch: plain softmax attention over the
    full [T, T] scores, plain cross-entropy over the full [B*T, V]
    logits, gradients by torch autograd — no kernel of the port."""
    dev = w["tok_emb"].device
    tok = torch.from_numpy(feed["tok"][..., 0]).to(dev)
    nxt = torch.from_numpy(feed["nxt"]).to(dev).reshape(-1)
    B, T = tok.shape
    D = HID // N_HEADS
    causal = torch.ones(T, T, dtype=torch.bool, device=dev).tril()

    def ln(x, g, b):
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + 1e-5) * g + b

    x = w["tok_emb"][tok] + w["pos_emb"][:T]
    for i in range(LAYERS):
        p = f"block{i}"
        h = ln(x, w[f"{p}.ln1.w_0"], w[f"{p}.ln1.w_1"])
        qkv = h @ w[f"{p}.qkv.w"] + w[f"{p}.qkv.b"]
        q, k, v = (t.reshape(B, T, N_HEADS, D).transpose(1, 2)
                   for t in qkv.split(HID, dim=2))
        s = (q @ k.transpose(-1, -2)) / float(np.sqrt(D))
        a = torch.softmax(s.masked_fill(~causal, float("-inf")), -1) @ v
        x = x + a.transpose(1, 2).reshape(B, T, HID) @ w[f"{p}.proj.w"] \
            + w[f"{p}.proj.b"]
        h = ln(x, w[f"{p}.ln2.w_0"], w[f"{p}.ln2.w_1"])
        up = torch.nn.functional.gelu(h @ w[f"{p}.ffn_up.w"]
                                      + w[f"{p}.ffn_up.b"],
                                      approximate="tanh")
        x = x + up @ w[f"{p}.ffn_down.w"] + w[f"{p}.ffn_down.b"]
    x = ln(x, w["ln_f.w_0"], w["ln_f.w_1"])
    logits = x.reshape(B * T, HID) @ w["lm_head.w"]
    loss = torch.nn.functional.cross_entropy(logits, nxt)
    names = sorted(w)
    grads = torch.autograd.grad(loss, [w[n] for n in names])
    return loss.detach(), dict(zip(names, grads))


K1_DESIGN = ("Tq > 1: 3xTF32 mma.sync m16n8k8, 64 query rows x 64-key K/V "
             "tiles, cp.async 2-stage; Tq = 1 (contiguous or through the "
             "page table): f32 FMA, a cluster of 4 blocks a (row, head), "
             "the row's live keys cut by its own length into <= 4 parts "
             "of >= 32 keys, loaded in rounds of up to 3 x 32-key chunks "
             "by 16-byte cp.async into an XOR-swizzled ring, one online-"
             "softmax update per warp a round, the warps' states merged "
             "in rank order in rank 0 through distributed shared memory")
BWD_DESIGN = {
    "flash_attn_bwd_fused": "3xTF32 mma.sync m16n8k8, 8 warps, K/V resident, "
                            "Q/dO/lse/delta cp.async 2-stage",
    "flash_attn_bwd_dq": "3xTF32 mma.sync m16n8k8, 64 q rows = 4 warps, "
                         "Q/dO staged once, K/V tiles by cp.async one at a "
                         "time, 3 blocks an SM; dS as register A of dS.K",
    "flash_attn_bwd_dkv": "3xTF32 mma.sync m16n8k8, 64 keys = 4 warps, K/V "
                          "resident, Q/dO/lse/delta cp.async 2-stage; S^T, "
                          "dP^T so P^T, dS^T are register A of P^T.dO, "
                          "dS^T.Q"}

K5_DESIGN = ("3xTF32 mma.sync m16n8k8 (split_rz), 128 rows x 128-column "
             "logits tiles, 8 warps of 64 x 32, x and w in 64-deep k chunks "
             "through a 3-stage cp.async ring, a fresh fragment per 64-wide "
             "k tile summed in f32; the vocab cut into splits (row block "
             "fastest in the grid), a second kernel merging each row's "
             "splits in order")
K6_DESIGN = ("s8 wgmma m64n128k32 + TMA, warp-specialised and persistent: "
             "128 x 128 tiles taken in turn by 2 consumer warpgroups (one's "
             "epilogue under the other's products) + a TMA producer warp, "
             "6-stage mbarrier ring of 128-byte-swizzled xq and w^T "
             "(column-major weight) boxes; f32 rescale epilogue")
QUANTIZE_DESIGN = ("one warp a row held in registers (K <= 3072): absmax by "
                   "shuffles, then the round-half-even quantize; float4 in, "
                   "char4 out")
BF16_DESIGN = {
    "flash_attn_fwd_bf16": "wgmma m64n64k16 (S from shared memory; P as "
                           "register A, V MN-major), units of 256 q rows = "
                           "4 consumer warpgroups + a TMA producer warp, "
                           "K/V tiles by TMA in a 3-stage mbarrier ring, Q "
                           "double-buffered; S_j issued before "
                           "P_{j-1}.V_{j-1}, whose run hides the softmax "
                           "of S_j; a persistent grid walking the units "
                           "heaviest causal block first (all heads' when "
                           "they fit the grid, else each head's)",
    "flash_attn_bwd_fused_bf16": "K4-bf16's block (wgmma m64n64k16, 128 "
                                 "keys = 2 consumer warpgroups + a TMA "
                                 "producer warp, Q/dO in a 3-stage "
                                 "mbarrier ring) plus dQ = dS.K: dS^T to "
                                 "shared memory once, read MN-major with "
                                 "K; a cluster of ceil(Tk / 128) blocks "
                                 "sums dQ in f32 through distributed "
                                 "shared memory in rank order, dq written "
                                 "once in bf16, no f32 partials",
    "flash_attn_bwd_dq_bf16": "wgmma m64n64k16 (S, dP from shared memory; "
                              "dS as register A, K MN-major), 128 q rows = "
                              "2 consumer warpgroups + a TMA producer warp, "
                              "K/V tiles by TMA in a 4-stage mbarrier ring",
    "flash_attn_bwd_dkv_bf16": "wgmma m64n64k16 (S^T, dP^T from shared "
                               "memory; P^T, dS^T as register A, dO/Q "
                               "MN-major), 128 keys = 2 consumer "
                               "warpgroups + a TMA producer warp, Q/dO "
                               "tiles by TMA in a 3-stage mbarrier ring",
    "lm_head_lse_bf16": "wgmma m64n256k16 + TMA, warp-specialised and "
                        "persistent: units of (128 rows, vocab split), 2 "
                        "consumer warpgroups of 64 rows + a TMA producer "
                        "warp, x [128 x 64] and w [64 x 256] (row-major, "
                        "read MN-major) in a 4-stage mbarrier ring, each w "
                        "tile multicast to a 2-block cluster of adjacent "
                        "row blocks; online max / exp2 sum folded per "
                        "tile; a second kernel merging each row's splits "
                        "in order"}

ALL_KERNELS = ("flash_attn_fwd", "flash_attn_bwd_fused",
               "flash_attn_bwd_dq", "flash_attn_bwd_dkv", "lm_head_lse",
               "int8_matmul", "quantize_activations", "flash_attn_fwd_bf16",
               "flash_attn_bwd_fused_bf16", "flash_attn_bwd_dq_bf16",
               "flash_attn_bwd_dkv_bf16", "lm_head_lse_bf16")


def wrappers():
    return {"flash_attn_fwd": fa.flash_attn_fwd,
            "flash_attn_bwd_fused": fa.flash_attn_bwd_fused,
            "flash_attn_bwd_dq": fa.flash_attn_bwd_dq,
            "flash_attn_bwd_dkv": fa.flash_attn_bwd_dkv,
            "lm_head_lse": ce.lm_head_lse,
            "int8_matmul": qo.int8_matmul_rescaled,
            "quantize_activations": qo.quantize_activations,
            "flash_attn_fwd_bf16": fa.flash_attn_fwd_bf16,
            "flash_attn_bwd_fused_bf16": fa.flash_attn_bwd_fused_bf16,
            "flash_attn_bwd_dq_bf16": fa.flash_attn_bwd_dq_bf16,
            "flash_attn_bwd_dkv_bf16": fa.flash_attn_bwd_dkv_bf16,
            "lm_head_lse_bf16": ce.lm_head_lse_bf16}


def launches_of(**counts):
    """The launch counts a path expects: the named ones, every other
    kernel 0."""
    return {**dict.fromkeys(ALL_KERNELS, 0), **counts}


def zero_counts():
    for w in wrappers().values():
        w.launches = 0
    fa.flash_attn_bwd_fused.dq_partials = 0


def read_counts():
    return {name: w.launches for name, w in wrappers().items()}


def check_counts(counts, want, what):
    if counts != want:
        raise AssertionError(f"{what}: kernel launches {counts}, expected "
                             f"{want}")


# step 1's gradients against the plain recompute: 1e-3 of each
# gradient's largest element (f32 throughout, sums in other orders —
# flash tiles against full softmax, a chunked lse against one
# logsumexp); loss: 1e-4 absolute
GRAD_RTOL, LOSS_ATOL = 1e-3, 1e-4


def checked_first_step(exe, main, feed, cost, params_grads, scope, what):
    """Step 1 with every gradient fetched, its loss and gradients held
    against the plain recompute of the same weights. Returns (loss,
    |loss diff|, worst relative gradient diff, step ms, peak GiB)."""
    names = [p.name for p, _ in params_grads]
    snapshot = {n: scope.get(n).detach().clone().requires_grad_()
                for n in names}
    fetch = [cost] + [g for _, g in params_grads]
    torch.cuda.reset_peak_memory_stats()
    t_step = time.perf_counter()
    out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                  return_numpy=False)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t_step)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    loss = float(out[0][0])
    ref_loss, ref_grads = reference_loss_and_grads(snapshot, feed)
    loss_err = abs(loss - float(ref_loss))
    worst = max((float((g - ref_grads[n]).abs().max())
                 / max(float(ref_grads[n].abs().max()), 1e-30), n)
                for n, g in zip(names, out[1:]))
    log(f"{what} step 1: loss {loss:.6f} vs plain recompute "
        f"{float(ref_loss):.6f} (|diff| {loss_err:.2e}, tol {LOSS_ATOL:g});"
        f" worst gradient {worst[1]} at {worst[0]:.2e} of its largest "
        f"element (tol {GRAD_RTOL:g}) over {len(names)} parameters")
    if not np.isfinite(loss) or loss_err > LOSS_ATOL:
        raise AssertionError(f"{what}: step-1 loss differs from the plain "
                             f"recompute")
    if not worst[0] <= GRAD_RTOL:
        raise AssertionError(f"{what}: gradient of {worst[1]} differs from "
                             f"the plain recompute by {worst[0]:.3e}")
    return loss, loss_err, worst[0], step_ms, peak_gb


def training_phase(smi):
    torch.cuda.empty_cache()            # the kernel phases' graph pools
    t0 = time.perf_counter()
    main, startup, cost, params_grads = build_gpt2(TRAIN_T)
    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    n_params = sum(int(np.prod(p.shape)) for p, _ in params_grads)
    log(f"training: GPT-2-small {LAYERS} layers, H {HID}, vocab {VOCAB}, "
        f"T {TRAIN_T}, batch {TRAIN_B}, {n_params} parameters, "
        f"{len(main.global_block().ops)} ops; built and initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    feed = token_batch(TRAIN_B, TRAIN_T, SEED + 3)

    zero_counts()                       # the main path starts here
    loss, loss_err, grad_worst, step1_ms, peak_gb = checked_first_step(
        exe, main, feed, cost, params_grads, scope, "training")
    losses = [loss]
    wall = []
    for _ in range(5):
        t_step = time.perf_counter()
        loss, = exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
        wall.append(1e3 * (time.perf_counter() - t_step))
        losses.append(float(loss[0]))
    counts = read_counts()              # the main path ends here
    log(f"training: losses {[round(x, 5) for x in losses]}")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError("the loss did not fall over 5 Adam steps on a "
                             "fixed batch")
    steps = len(losses)
    route = fa.bwd_route(TRAIN_T)
    want = launches_of(
        flash_attn_fwd=LAYERS * steps, lm_head_lse=steps,
        flash_attn_bwd_fused=LAYERS * steps if route == "fused" else 0,
        flash_attn_bwd_dq=LAYERS * steps if route == "split" else 0,
        flash_attn_bwd_dkv=LAYERS * steps if route == "split" else 0)
    check_counts(counts, want, f"training T={TRAIN_T} ({steps} steps, "
                 f"route {route})")
    step_ms = float(np.mean(wall))
    tokens = TRAIN_B * TRAIN_T
    log(f"training: launches {counts} over {steps} steps (route {route}); "
        f"step wall {step_ms:.1f} ms (mean of steps 2-6, min "
        f"{min(wall):.1f}; step 1 with gradient fetch {step1_ms:.1f}), "
        f"{tokens / step_ms * 1e3:.0f} tokens/s, peak memory "
        f"{peak_gb:.1f} GiB | {smi}")
    breakdown = step_breakdown(exe, main, feed, cost, scope, step_ms, smi)
    del scope, exe
    torch.cuda.empty_cache()
    return counts, {"step_ms": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
                    "losses": losses, "loss_err": loss_err,
                    "grad_worst": grad_worst, "peak_gib": peak_gb,
                    "breakdown": breakdown}


KERNEL_NAMES = {          # profiler kernel name fragments
    "flash_attn_fwd": ("flash_fwd_", "flash_decode_"),
    "flash_attn_bwd_fused": ("bwd_fused_tc_kernel",),
    "flash_attn_bwd_dq": ("bwd_dq_kernel",),
    "flash_attn_bwd_dkv": ("bwd_dkv_kernel",),
    "lm_head_lse": ("lse_kernel", "lse_merge_kernel"),
}


def step_breakdown(exe, main, feed, cost, scope, step_ms, smi):
    """One more training step under torch.profiler: the device time of
    every kernel it ran, the share of K1-K5, and device busy / wall."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
        torch.cuda.synchronize()
    by_kernel = {name: 0.0 for name in KERNEL_NAMES}
    device_us = 0.0
    for ev in prof.events():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = float(ev.time_range.elapsed_us())
        device_us += us
        for name, frags in KERNEL_NAMES.items():
            if any(f in ev.name for f in frags):
                by_kernel[name] += us
    if device_us <= 0:
        log("step breakdown: the profiler recorded no device time; "
            "device time not measured")
        return None
    device_ms = device_us / 1e3
    shares = {n: round(us / device_us, 4) for n, us in by_kernel.items()}
    log(f"step breakdown (profiled step): device {device_ms:.1f} ms of "
        f"kernels against a {step_ms:.1f} ms unprofiled step wall (busy "
        f"share {device_ms / step_ms:.3f}); K1-K5 ms "
        f"{ {n: round(us / 1e3, 3) for n, us in by_kernel.items()} }, "
        f"share of device time {shares} | {smi}")
    return {"device_ms": device_ms, "kernel_ms": {
        n: us / 1e3 for n, us in by_kernel.items()}, "share": shares}


def short_training_phase(smi):
    """T = 256, where the backward route is the fused K2: step 1's loss
    and gradients against the plain recompute, then three timed steps
    and a profiled one."""
    main, startup, cost, params_grads = build_gpt2(SHORT_T)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    feed = token_batch(SHORT_B, SHORT_T, SEED + 5)
    zero_counts()                       # the main path starts here
    losses = [checked_first_step(exe, main, feed, cost, params_grads, scope,
                                 f"short training T {SHORT_T}")[0]]
    wall = []
    for _ in range(3):
        t_step = time.perf_counter()
        losses.append(float(exe.run(main, feed=feed, fetch_list=[cost],
                                    scope=scope)[0][0]))
        wall.append(1e3 * (time.perf_counter() - t_step))
    counts = read_counts()              # the main path ends here
    partials = fa.flash_attn_bwd_fused.dq_partials
    route = fa.bwd_route(SHORT_T)
    if route != "fused":
        raise AssertionError(f"T={SHORT_T} should take the fused route")
    steps = len(losses)
    check_counts(counts, launches_of(flash_attn_fwd=steps * LAYERS,
                                     flash_attn_bwd_fused=steps * LAYERS,
                                     lm_head_lse=steps),
                 f"training T={SHORT_T}")
    if partials != steps * LAYERS:      # the f32 K2 writes f32 partials
        raise AssertionError(f"training T={SHORT_T}: {partials} f32 dq "
                             f"partial buffers, expected {steps * LAYERS}")
    if not np.isfinite(losses).all():
        raise AssertionError("non-finite loss at T=256")
    step_ms = float(np.mean(wall))
    tokens = SHORT_B * SHORT_T
    log(f"short training: T {SHORT_T} batch {SHORT_B}, losses {losses}, "
        f"launches {counts} over {steps} steps (route {route}); step wall "
        f"{step_ms:.1f} ms (mean of steps 2-4, min {min(wall):.1f}), "
        f"{tokens / step_ms * 1e3:.0f} tokens/s | {smi}")
    breakdown = step_breakdown(exe, main, feed, cost, scope, step_ms, smi)
    del scope, exe
    torch.cuda.empty_cache()
    return counts, {"step_ms": step_ms,
                    "tokens_per_s": tokens / step_ms * 1e3,
                    "losses": losses, "breakdown": breakdown}


# -- phase 9: K6 vs plain -----------------------------------------------------

SERVE_B = 8                      # the int8 server's largest rung
# the five GPT-2-small products of one int8 dispatch at M = 8 x 1024:
# name -> (K, N, launches per dispatch)
INT8_PRODUCTS = {"qkv": (HID, 3 * HID, LAYERS), "proj": (HID, HID, LAYERS),
                 "ffn_up": (HID, 4 * HID, LAYERS),
                 "ffn_down": (4 * HID, HID, LAYERS),
                 "lm_head": (HID, VOCAB, 1)}
INT8_PER_DISPATCH = sum(n for _, _, n in INT8_PRODUCTS.values())     # 49
# The int8 model against its plain recompute, end to end: max |diff| /
# max |logit|. The two differ by ~1e-6 before any quantization (K1
# against plain attention, torch's layer norm against the plain one);
# a value that sits on a rounding boundary then quantizes one int8 step
# apart, and over 12 layers those steps can cascade to the size of the
# quantization noise itself (2.08e-2 measured on the H100 at rung 8).
# The gate is tools/check_quantize.py's band for the int8 core against
# f32 (GPT2_INT8_REL_ERR): a wrong layer, scale or layout gives O(1).
INT8_E2E_RTOL = 5e-2


def int8_operands(rng, M, K, N):
    """Asymmetric int8 operands over the whole range, -127 and 127
    included (a lane-order or k-packing fault does not cancel on them),
    the weight column-major as the port stores it on the card, and the
    epilogue's scales: ax per row, col per column."""
    x = rng.randint(-127, 128, (M, K)).astype(np.int8)
    w = rng.randint(-127, 128, (K, N)).astype(np.int8)
    x[0, :] = 127
    x[-1, ::3] = -127
    w[:, 0] = np.arange(K) % 255 - 127
    w[K // 2, :] = -127
    ax = (rng.rand(M, 1) * 0.1 + 1e-3).astype(np.float32)
    col = (rng.rand(1, N) * 1e-2 + 1e-4).astype(np.float32)
    return (torch.from_numpy(x).cuda(),
            torch.from_numpy(w).cuda().t().contiguous().t(),
            torch.from_numpy(ax).cuda(), torch.from_numpy(col).cuda())


def int8_work(M, K, N):
    """(operations, bytes) of one int8 product with the rescale: 2MKN
    integer operations; xq, wq, ax and col read once, the f32 result
    written once."""
    return 2.0 * M * K * N, float(M * K + K * N + 4 * M * N + 4 * M + 4 * N)


def int8_bound(ops, nbytes):
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def int8_plain(x, w, ax, col):
    return qo.rescale(qo.int8_matmul_plain(x, w), ax, col)


def int8_kernel_phase(smi):
    """K6 against its plain versions at the five GPT-2-small products of
    a rung-8 dispatch (M = 8192), a ragged case and the ResNet-50 int8
    fc of phase 25's rung 16 (M 16, K 2048, N 1000), the weight
    column-major: with the rescale epilogue (int8_matmul_rescaled)
    bitwise against rescale(int8_matmul_plain), with the int32 epilogue
    bitwise against int8_matmul_plain. Times: the rescaled kernel, its
    plain version and torch._int_mm on the same column-major weight (a
    yardstick only; the port never calls it), each over input sets
    larger than the 50 MB L2 (the f32 outputs alone exceed it); the int32
    kernel beside them. Then the quantize kernel."""
    rng = np.random.RandomState(SEED + 7)
    M = SERVE_B * TRAIN_T
    cases = {k: (M, K, N) for k, (K, N, _) in INT8_PRODUCTS.items()}
    cases["ragged"] = (1000, 100, 130)
    cases["resnet50_fc"] = RESNET_FC
    k6 = (qo.int8_matmul_rescaled, qo.int8_matmul_i32)
    results = {}
    for case, (m, k, n) in cases.items():
        fixes = [(w.repacks, w.k_pads) for w in k6]
        sets = [int8_operands(rng, m, k, n) for _ in range(2)]
        got = qo.int8_matmul_rescaled(*sets[0])
        acc = qo.int8_matmul_i32(*sets[0][:2])
        torch.cuda.synchronize()
        ref_acc = qo.int8_matmul_plain(*sets[0][:2])
        ref = qo.rescale(ref_acc, *sets[0][2:])
        for what, g, r, dt in (("rescaled", got, ref, torch.float32),
                               ("int32", acc, ref_acc, torch.int32)):
            if g.dtype != dt or not torch.equal(g, r):
                bad = int((g != r).sum())
                raise AssertionError(f"int8_matmul {case} ({what}) "
                                     f"[{m},{k}]@[{k},{n}]: {bad} results "
                                     f"differ from the plain version")
        del got, acc, ref, ref_acc
        big = m * n > 10**8           # the lm head: 1.65 GB outputs
        reps = 4 if big else 20
        r = {"case": case, "M": m, "K": k, "N": n, "max_abs_err": 0.0,
             "ms": time_ms(qo.int8_matmul_rescaled, sets, reps=reps),
             "plain_ms": time_ms(int8_plain, sets, reps=2 if big else 6),
             "i32_ms": time_ms(lambda x, w, ax, col: qo.int8_matmul_i32(
                 x, w), sets, reps=reps),
             # cuBLASLt's int8 GEMM takes K and N in multiples of 8
             "library_ms": (time_ms(lambda x, w, ax, col: torch._int_mm(
                 x, w), sets, reps=reps)
                            if k % 8 == 0 and n % 8 == 0 and m > 16
                            else None)}
        r["bound_ms"], r["bound_by"] = int8_bound(*int8_work(m, k, n))
        lib = (f"{r['library_ms']:.4f}" if r["library_ms"] is not None
               else "n/a")
        log(f"kernel int8_matmul {case}: [{m},{k}] @ [{k},{n}] (w "
            f"column-major) bitwise == plain, rescaled and int32; ms "
            f"{r['ms']:.4f} (int32 epilogue {r['i32_ms']:.4f}) plain_ms "
            f"{r['plain_ms']:.4f} library_ms (torch._int_mm, column-major "
            f"w) {lib} bound_ms {r['bound_ms']:.5f} ({r['bound_by']}) | "
            f"{smi}")
        results[case] = r
        del sets
        torch.cuda.empty_cache()
        # the column-major weight is read as it is; only a K that is not
        # a multiple of 16 (the ragged 100) is padded
        for w, (repacks, pads) in zip(k6, fixes):
            if w.repacks != repacks or (k % 16 == 0 and w.k_pads != pads):
                raise AssertionError(f"{w.__name__} {case}: "
                                     f"{w.repacks - repacks} repacks, "
                                     f"{w.k_pads - pads} K paddings")
    # one dispatch's worth: 12 x the four block products + the lm head
    total = {key: sum(results[c][key] * INT8_PRODUCTS[c][2]
                      for c in INT8_PRODUCTS)
             for key in ("ms", "plain_ms", "library_ms", "i32_ms")}
    ops = sum(int8_work(M, K, N)[0] * n for K, N, n in INT8_PRODUCTS.values())
    nbytes = sum(int8_work(M, K, N)[1] * n
                 for K, N, n in INT8_PRODUCTS.values())
    total["bound_ms"], total["bound_by"] = int8_bound(ops, nbytes)
    log(f"kernel int8_matmul per rung-8 dispatch ({INT8_PER_DISPATCH} "
        f"launches): ms {total['ms']:.4f} (int32 epilogue "
        f"{total['i32_ms']:.4f}) plain_ms {total['plain_ms']:.4f} "
        f"library_ms (torch._int_mm, column-major w) "
        f"{total['library_ms']:.4f} bound_ms {total['bound_ms']:.5f} "
        f"({total['bound_by']}) | {smi}")
    quantize = quantize_kernel_phase(rng, smi)
    return total, list(results.values()), quantize


def quantize_inputs(rng, M, K):
    """A dispatch's activations at K (layer-norm-like magnitudes), with a
    wide row, a narrow one, a row of zeros and a row of exact halves (max
    127 * 2^-3: ax = 2^-3, so x / ax = k + 1/2 and round half to even
    decides)."""
    x = rng.randn(M, K).astype(np.float32)
    x[0] *= 40.0
    x[1] *= 1e-3
    x[2] = 0.0
    x[3] = ((np.arange(K) % 253) - 126 + 0.5) * 0.125
    x[3, 0] = 127 * 0.125
    return torch.from_numpy(x).cuda()


def quantize_kernel_phase(rng, smi):
    """The activation quantize kernel against quantize_activations_plain,
    bit for bit, at the dispatch's two activation widths (K 768: qkv,
    proj, ffn_up, lm head; K 3072: ffn_down) and at the ResNet-50 int8
    fc's input (M 16, K 2048), dynamic and static scales; timed per
    shape, the GPT-2 widths summed over a dispatch (37 x K 768, 12 x
    K 3072), beside its bytes bound (f32 in, int8 out) and the plain
    version."""
    M = SERVE_B * TRAIN_T
    per_dispatch = {HID: 3 * LAYERS + 1, 4 * HID: LAYERS}
    shapes = [(M, K) for K in per_dispatch] + [RESNET_FC[:2]]
    static = torch.tensor([0.0125], device="cuda")
    results = {}
    for m, K in shapes:
        sets = [(quantize_inputs(rng, m, K),) for _ in range(3)]
        for scale in (None, static):
            xq, ax = qo.quantize_activations(sets[0][0], scale)
            torch.cuda.synchronize()
            ref_q, ref_ax = qo.quantize_activations_plain(sets[0][0], scale)
            if not (torch.equal(xq, ref_q) and torch.equal(ax, ref_ax)):
                raise AssertionError(
                    f"quantize_activations [{m},{K}] "
                    f"{'static' if scale is not None else 'dynamic'}: "
                    f"{int((xq != ref_q).sum())} xq and "
                    f"{int((ax != ref_ax).sum())} ax differ from the "
                    "plain version")
            if scale is None and (float(ax[3, 0]) != 0.125 or float(
                    ax[2, 0]) != torch.finfo(torch.float32).tiny):
                raise AssertionError("the tie row's scale is not 2^-3, or "
                                     "the zero row's not tiny")
        ms = time_ms(qo.quantize_activations, sets, reps=20)
        plain_ms = time_ms(qo.quantize_activations_plain, sets, reps=6)
        bound_ms = 5.0 * m * K / PEAK_HBM_BYTES * 1e3
        results[m, K] = (per_dispatch[K] if m == M else 0, ms, plain_ms,
                         bound_ms)
        log(f"kernel quantize_activations [{m},{K}]: bitwise == plain "
            f"(dynamic and static; zero row, exact halves); ms {ms:.4f} "
            f"plain_ms {plain_ms:.4f} bound_ms {bound_ms:.5f} (bytes) | "
            f"{smi}")
        del sets
    total = {"max_abs_err": 0.0, "library_ms": None, "bound_by": "bytes",
             "cases": [{"M": m, "K": K, "per_dispatch": c, "ms": ms,
                        "plain_ms": p, "bound_ms": b, "path": (
                            "serving_int8" if m == M
                            else "resnet50_serving_int8")}
                       for (m, K), (c, ms, p, b) in results.items()]}
    for i, key in enumerate(("ms", "plain_ms", "bound_ms")):
        total[key] = sum(v[0] * v[1 + i] for v in results.values())
    log(f"kernel quantize_activations per rung-8 dispatch "
        f"({INT8_PER_DISPATCH} launches): ms {total['ms']:.4f} plain_ms "
        f"{total['plain_ms']:.4f} bound_ms {total['bound_ms']:.5f} (bytes) "
        f"| {smi}")
    return total


# -- phase 10: int8 one-shot serving -----------------------------------------

def build_gpt2_lm():
    """GPT-2-small's inference program: logits and their argmax."""
    pt.framework.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        tok = pt.layers.data("tokens", [TRAIN_T], dtype="int64")
        logits = pt.models.transformer.transformer_lm(
            tok, VOCAB, hid=HID, num_layers=LAYERS, num_heads=N_HEADS,
            max_len=TRAIN_T)
        ids = pt.layers.argmax(logits, axis=-1)
    return main, startup, logits, ids


def post_infer(port, tokens):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("POST", "/v1/infer",
                 json.dumps({"feeds": {"tokens": tokens.tolist()}}),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    if resp.status != 200:
        raise AssertionError(f"/v1/infer -> {resp.status}: {body[:300]!r}")
    return np.asarray(json.loads(body)["outputs"][0], np.int64)


def int8_reference_logits(scope, tokens):
    """The int8 model as plain PyTorch on the card: the int8 x int8 ->
    int32 products by int8_matmul_plain between the plain quantize and
    rescale, plain softmax attention over the full [T, T] scores, plain
    layer norm and gelu — no kernel of the port."""
    w = {n: scope.get(n) for n in scope.keys() if not n.startswith("__")}
    B, T_ = tokens.shape
    D = HID // N_HEADS
    causal = torch.ones(T_, T_, dtype=torch.bool,
                        device=tokens.device).tril()

    def ln(x, g, b):
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + 1e-5) * g + b

    def qmm(x, name):
        xq, ax = qo.quantize_activations_plain(x.reshape(-1, x.shape[-1]))
        out = int8_plain(xq, w[name], ax, w[name + "@QSCALE"].reshape(1, -1))
        return out.reshape(x.shape[:-1] + (-1,))

    x = (w["tok_emb"][tokens].float() * w["tok_emb@QSCALE"][tokens]
         + w["pos_emb"][:T_])
    for i in range(LAYERS):
        p = f"block{i}"
        h = ln(x, w[f"{p}.ln1.w_0"], w[f"{p}.ln1.w_1"])
        qkv = qmm(h, f"{p}.qkv.w") + w[f"{p}.qkv.b"]
        q, k, v = (t.reshape(B, T_, N_HEADS, D).transpose(1, 2)
                   for t in qkv.split(HID, dim=2))
        s = (q @ k.transpose(-1, -2)) / float(np.sqrt(D))
        a = torch.softmax(s.masked_fill(~causal, float("-inf")), -1) @ v
        del q, k, v, s, qkv
        x = x + qmm(a.transpose(1, 2).reshape(B, T_, HID),
                    f"{p}.proj.w") + w[f"{p}.proj.b"]
        h = ln(x, w[f"{p}.ln2.w_0"], w[f"{p}.ln2.w_1"])
        up = torch.nn.functional.gelu(qmm(h, f"{p}.ffn_up.w")
                                      + w[f"{p}.ffn_up.b"],
                                      approximate="tanh")
        x = x + qmm(up, f"{p}.ffn_down.w") + w[f"{p}.ffn_down.b"]
    return qmm(ln(x, w["ln_f.w_0"], w["ln_f.w_1"]), "lm_head.w")


def check_quant_muls_bitwise(exe, prog, scope, feed):
    """Every quant_mul of one rung-8 run (the quantize kernel, then K6
    with its rescale epilogue): its output Out against the plain
    recompute from its own fetched input X (quantize_activations_plain,
    int8_matmul_plain, rescale), bit for bit."""
    muls = [op for op in prog.global_block().ops if op.type == "quant_mul"]
    names = [n for op in muls for n in (op.input("X")[0],
                                        op.output("Out")[0])]
    vals = exe.run(prog, feed=feed, fetch_list=names, scope=scope,
                   return_numpy=False)
    shapes = set()
    for i, op in enumerate(muls):
        x, out = vals[2 * i], vals[2 * i + 1]
        wname = op.input("Y")[0]
        x2 = x.reshape(-1, x.shape[-1])
        xq, ax = qo.quantize_activations_plain(x2)
        ref = int8_plain(xq, scope.get(wname), ax,
                         scope.get(op.input("YScale")[0]).reshape(1, -1))
        if not torch.equal(out.reshape(ref.shape), ref):
            raise AssertionError(f"quant_mul on {wname}: the kernels' output "
                                 f"differs from the plain recompute of its "
                                 f"input")
        shapes.add((tuple(x2.shape), tuple(scope.get(wname).shape)))
        vals[2 * i] = vals[2 * i + 1] = None
    return len(muls), sorted(shapes)


def dispatch_breakdown(what, exe, prog, scope, feed, fetch, wall_ms, smi):
    """One rung-8 dispatch under torch.profiler: device time of K6 (its
    rescale epilogue included), the quantize kernel, K1, cuBLAS's matmuls
    (kernel names with "gemm": the f32 program's products), an eager
    rescale (record_function around quant_ops.rescale, which the card's
    int8 path no longer calls: it should read 0) and the rest."""
    from torch.profiler import ProfilerActivity, profile, record_function
    real = qo.rescale

    def marked(*a, **kw):
        with record_function("int8/rescale"):
            return real(*a, **kw)
    try:
        qo.rescale = marked
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
            torch.cuda.synchronize()
    finally:
        qo.rescale = real
    names = {"int8_matmul": "int8_matmul_kernel",
             "quantize": "quantize_rows",
             "flash_attn_fwd": "flash_fwd_"}
    parts = dict.fromkeys([*names, "cublas_gemm", "rescale"], 0.0)
    device_us = 0.0
    for ev in prof.events():
        is_mark = ev.name.startswith("int8/")
        if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            if is_mark:
                continue             # the annotation's own device range
            us = float(ev.time_range.elapsed_us())
            device_us += us
            part = next((k for k, frag in names.items() if frag in ev.name),
                        "cublas_gemm" if "gemm" in ev.name.lower() else None)
            if part:
                parts[part] += us
        elif is_mark:
            parts["rescale"] += float(getattr(ev, "device_time_total", 0.0)
                                      or 0.0)
    if device_us <= 0:
        log(f"{what} dispatch breakdown: the profiler recorded no device "
            "time; device time not measured")
        return None
    parts = {k: v / 1e3 for k, v in parts.items()}
    device_ms = device_us / 1e3
    parts["rest"] = device_ms - sum(parts.values())
    log(f"{what} dispatch breakdown (profiled rung-8 dispatch): device "
        f"{device_ms:.2f} ms of kernels against a {wall_ms:.2f} ms "
        f"unprofiled wall (busy share {device_ms / wall_ms:.3f}); ms "
        f"{ {k: round(v, 3) for k, v in parts.items()} } | {smi}")
    return {"device_ms": device_ms, "ms": parts, "busy": device_ms / wall_ms,
            "share": {k: v / device_ms for k, v in parts.items()}}


def timed_dispatch(exe, prog, scope, feed, fetch, reps=3):
    """Host-clock wall of the engine's dispatch at rung 8 (tokens in,
    ids back as numpy, so the card has finished), after one warm run."""
    exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
        walls.append(1e3 * (time.perf_counter() - t0))
    return float(np.mean(walls)), min(walls)


def scope_bytes(scope):
    return sum(v.numel() * v.element_size() for v in scope.vars.values()
               if isinstance(v, torch.Tensor))


def int8_serving_phase(smi):
    """GPT-2-small quantized by the port (quantize_inference_model) and
    served one-shot: save_inference_model -> quantize -> load ->
    InferenceEngine.from_program behind make_server (the code of `serve
    --model_dir`), eight /v1/infer requests from four client threads."""
    import tempfile
    torch.cuda.empty_cache()
    flags.set_flag("metrics", True)     # quant.fallback_ops is counted
    t0 = time.perf_counter()
    main, startup, logits, ids = build_gpt2_lm()
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_int8_")
    src, out = os.path.join(tmp, "f32"), os.path.join(tmp, "int8")
    # fetch [ids]: 50304 logits a position would make each reply GBs; the
    # logits var stays in the pruned program for the checks below
    pt.io.save_inference_model(src, ["tokens"], [ids], exe,
                               main_program=main, scope=scope)
    del scope
    _, report = quant.quantize_inference_model(src, out)
    fallback0 = monitor.snapshot()["counters"].get("quant.fallback_ops", 0)
    qscope = pt.Scope()
    prog, feeds, fetch = pt.io.load_inference_model(out, exe, scope=qscope)
    fallbacks = monitor.snapshot()["counters"].get("quant.fallback_ops",
                                                   0) - fallback0
    log(f"int8 serving: quantized {report['quantized_ops']} ops "
        f"({report['quantized_weights']} weights, {report['dequant_ops']} "
        f"dequant-at-boundary), bytes {report['bytes_before']} -> "
        f"{report['bytes_after']}, fallback ops at load {fallbacks}; built, "
        f"saved, quantized and loaded in {time.perf_counter() - t0:.1f} s")
    if report["quantized_ops"] != 4 * LAYERS + 2 or fallbacks != 0:
        raise AssertionError(f"expected {4 * LAYERS + 2} quantized ops "
                             "(4 muls a block, the lm head, tok_emb's "
                             "lookup) and no fallback")
    # the int8 matmul weights column-major on the card (K6's layout), the
    # bytes on the card those of the saved arrays
    dot_weights = {op.input("Y")[0] for op in prog.global_block().ops
                   if op.type == "quant_mul"}
    row_major = sorted(n for n in dot_weights
                       if not qo.is_column_major(qscope.get(n)))
    with np.load(os.path.join(out, "params.npz")) as saved:
        saved_bytes = sum(saved[n].nbytes for n in saved.files)
    loaded_bytes = scope_bytes(qscope)
    log(f"int8 serving: {len(dot_weights)} int8 matmul weights on the card, "
        f"{len(dot_weights) - len(row_major)} column-major; scope bytes "
        f"{loaded_bytes} (saved arrays {saved_bytes})")
    if row_major or len(dot_weights) != 4 * LAYERS + 1 or \
            loaded_bytes != saved_bytes:
        raise AssertionError(f"int8 weights not column-major on the card "
                             f"({row_major}) or bytes changed")
    engine = InferenceEngine.from_program(
        prog, feeds, fetch, executor=exe, scope=qscope,
        config=EngineConfig(max_batch_size=SERVE_B, buckets=(1, 2, 4, 8),
                            batch_timeout_ms=20))
    t0 = time.perf_counter()
    rungs = engine.warmup()
    st = engine.stats()
    log(f"int8 serving: warmed rungs {rungs} in "
        f"{time.perf_counter() - t0:.1f} s: aot_status {st['aot_status']}, "
        f"CUDA graphs of buckets {st['aot_buckets']}; memory reserved "
        f"{torch.cuda.memory_reserved()} B")
    if st["aot_status"] != "cuda_graph" or st["aot_buckets"] != [1, 2, 4, 8]:
        raise AssertionError("expected a CUDA graph for every bucket rung")
    server = make_server(engine, port=0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()

    rng = np.random.RandomState(SEED + 5)
    reqs = [rng.randint(0, VOCAB, (r, TRAIN_T)).astype(np.int64)
            for r in rng.randint(1, 4, 8)]
    replies, errors = {}, []

    def client(idx):
        for i in idx:
            try:
                replies[i] = post_infer(port, reqs[i])
            except Exception as e:       # re-raised below
                errors.append((i, e))

    before = engine.stats()
    k6 = qo.int8_matmul_rescaled
    zero_counts()                       # the main path starts here
    k6.repacks = k6.k_pads = 0
    t_start = time.perf_counter()
    threads = [threading.Thread(target=client, args=((c, c + 4),))
               for c in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t_start
    counts = read_counts()              # the main path ends here
    fixes = (k6.repacks, k6.k_pads)
    server.shutdown()
    engine.shutdown(drain=True, timeout=600)
    if errors:
        raise AssertionError(f"/v1/infer requests failed: {errors}")
    st = engine.stats()
    batches = st["batches"] - before["batches"]
    done = st["completed"] - before["completed"]
    log(f"int8 serving: {done} requests ({sum(len(r) for r in reqs)} rows) "
        f"in {batches} dispatches over {wall:.2f} s, launches {counts}; K6 "
        f"weight repacks {fixes[0]}, K paddings {fixes[1]}")
    if done != len(reqs) or not batches < done:
        raise AssertionError("the requests did not co-batch (expected a "
                             "dispatch with more than one request)")
    check_counts(counts, launches_of(
        int8_matmul=INT8_PER_DISPATCH * batches,
        quantize_activations=INT8_PER_DISPATCH * batches,
        flash_attn_fwd=LAYERS * batches), f"int8 serving ({batches} "
                                          f"dispatches)")
    if fixes != (0, 0):
        raise AssertionError("the serving path repacked a weight or padded "
                             "K")
    counts = {k: n for k, n in counts.items() if n}

    # replies == Executor.run of the same rows
    for i, x in enumerate(reqs):
        mine, = exe.run(prog, feed={"tokens": x}, fetch_list=fetch,
                        scope=qscope)
        if not np.array_equal(replies[i], mine):
            raise AssertionError(f"request {i}: reply ids differ from "
                                 "Executor.run on the same rows")
    log("int8 serving: every reply's ids == Executor.run on the same rows")

    feed = {"tokens": np.random.RandomState(SEED + 6).randint(
        0, VOCAB, (SERVE_B, TRAIN_T)).astype(np.int64)}
    n_muls, shapes = check_quant_muls_bitwise(exe, prog, qscope, feed)
    log(f"int8 serving: {n_muls} quant_mul outputs bitwise == the plain "
        f"recompute from their inputs, at {shapes}")

    got_ids, got_logits = exe.run(prog, feed=feed,
                                  fetch_list=[fetch[0], logits.name],
                                  scope=qscope, return_numpy=False)
    with torch.inference_mode():
        ref = int8_reference_logits(
            qscope, torch.from_numpy(feed["tokens"]).cuda())
    diff = (got_logits - ref).abs()
    max_d, mean_d = float(diff.max()), float(diff.mean())
    rel = max_d / float(ref.abs().max())
    del diff
    top2 = ref.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > 2 * max_d
    agree = bool((got_ids[sure] == ref.argmax(-1)[sure]).all())
    log(f"int8 serving: logits vs the plain full recompute: max |diff| "
        f"{max_d:.4e} (mean {mean_d:.4e}), / max |logit| {rel:.4e} (gate "
        f"{INT8_E2E_RTOL:g}); ids equal at all {int(sure.sum())} of "
        f"{sure.numel()} positions whose top-2 margin exceeds 2 x max "
        f"|diff|: {agree}")
    if not np.isfinite(rel) or rel > INT8_E2E_RTOL or not agree:
        raise AssertionError("the int8 model disagrees with its plain full "
                             "recompute")
    del ref, top2, sure

    # timings: the rung-8 dispatch of the int8 and the f32 programs
    tokens = SERVE_B * TRAIN_T
    torch.cuda.reset_peak_memory_stats()
    int8_ms, int8_min = timed_dispatch(exe, prog, qscope, feed, fetch)
    int8_peak = torch.cuda.max_memory_allocated() / 2**30
    breakdown = dispatch_breakdown("int8", exe, prog, qscope, feed, fetch,
                                   int8_ms, smi)
    # the same rung-8 dispatch through the engine's CUDA graph against
    # Executor.run, in turns; replies bitwise equal
    walls, _ = eager_and_graph_walls(
        lambda: exe.run(prog, feed=feed, fetch_list=fetch, scope=qscope),
        lambda: engine._dispatch([feed["tokens"]]), reps=5)
    graph_device_ms = graph_replay_ms(
        engine._graphs, (((SERVE_B, TRAIN_T), "<i8"),), reps=5)
    log(f"int8 serving: rung-8 dispatch wall eager (Executor.run) "
        f"{walls['eager'][0]:.2f} / {walls['eager'][1]:.2f} ms, CUDA graph "
        f"{walls['graph'][0]:.2f} / {walls['graph'][1]:.2f} ms (turns eager, "
        f"graph, graph, eager; ids equal, bitwise), device "
        f"{graph_device_ms:.2f} ms (the graph's replay); busy share eager "
        f"{graph_device_ms / np.mean(walls['eager']):.3f}, graph "
        f"{graph_device_ms / np.mean(walls['graph']):.3f}; "
        f"{tokens / np.mean(walls['graph']) * 1e3:.0f} tokens/s "
        f"through the graph | {smi}")
    int8_bytes = scope_bytes(qscope)
    if int8_bytes != saved_bytes:
        raise AssertionError(f"scope bytes {int8_bytes} after serving, "
                             f"{saved_bytes} saved")
    del engine, qscope
    torch.cuda.empty_cache()
    fscope = pt.Scope()
    fprog, _, ffetch = pt.io.load_inference_model(src, exe, scope=fscope)
    f32_ids, f32_logits = exe.run(fprog, feed=feed,
                                  fetch_list=[ffetch[0], logits.name],
                                  scope=fscope, return_numpy=False)
    vs_f32 = (float((got_logits - f32_logits).abs().max())
              / float(f32_logits.abs().max()))
    top1 = float((got_ids == f32_ids).float().mean())
    del got_logits, f32_logits
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    f32_ms, f32_min = timed_dispatch(exe, fprog, fscope, feed, ffetch)
    f32_peak = torch.cuda.max_memory_allocated() / 2**30
    f32_breakdown = dispatch_breakdown("f32", exe, fprog, fscope, feed,
                                       ffetch, f32_ms, smi)
    f32_bytes = scope_bytes(fscope)
    log(f"int8 serving vs the f32 model (printed, not gated: random "
        f"weights have near-tied top-1 margins): max |int8 - f32| / max "
        f"|f32| {vs_f32:.4e}, top-1 agreement {top1:.4f}")
    log(f"int8 serving: rung-8 dispatch wall int8 {int8_ms:.2f} ms (min "
        f"{int8_min:.2f}, {tokens / int8_ms * 1e3:.0f} tokens/s, peak "
        f"{int8_peak:.2f} GiB, weights {int8_bytes} B) vs f32 "
        f"{f32_ms:.2f} ms (min {f32_min:.2f}, {tokens / f32_ms * 1e3:.0f} "
        f"tokens/s, peak {f32_peak:.2f} GiB, weights {f32_bytes} B) | {smi}")
    del fscope
    shutil.rmtree(tmp)
    torch.cuda.empty_cache()
    return counts, {"dispatches": batches, "requests": done,
                    "logit_rel_err": rel, "vs_f32_rel": vs_f32,
                    "int8_ms": int8_ms,
                    "int8_eager_walls_ms": walls["eager"],
                    "int8_graph_walls_ms": walls["graph"],
                    "int8_graph_device_ms": graph_device_ms,
                    "f32_ms": f32_ms, "int8_tokens_per_s":
                        tokens / int8_ms * 1e3,
                    "f32_tokens_per_s": tokens / f32_ms * 1e3,
                    "int8_peak_gib": int8_peak, "f32_peak_gib": f32_peak,
                    "int8_weight_bytes": int8_bytes,
                    "f32_weight_bytes": f32_bytes, "top1_vs_f32": top1,
                    "breakdown": breakdown, "f32_breakdown": f32_breakdown}


# -- phase 11: the bf16 (amp) kernels vs plain --------------------------------

# bf16 outputs within 1e-2 of the largest |plain| element, two bf16 ulps:
# kernel and plain version sum f32 products of the same bf16 operands in
# other orders and round once; f32 outputs (LSE) within TOL absolute
BF16_REL = 1e-2


def bound_bf16(flops, nbytes):
    """(ms, what bounds it): bf16 tensor-core operations at the dense
    bf16 peak against bytes at the HBM peak."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def attn_bound_bf16(B, Tq, Tk, kv_len, causal, products, ins, outs,
                    n=N_HEADS):
    """attn_bound's work with bf16 operands: `products` T x T x D
    products over the live pairs of n heads at the bf16 peak, against
    `ins` q-sized bf16 inputs, the bf16 outputs `outs` (lengths) and the
    f32 row statistics."""
    pairs = live_pairs(B, Tq, Tk, kv_len, causal) * n
    elems = B * n * HEAD_DIM
    nbytes = (2 * (elems * (Tq + 2 * Tk) + elems * (ins - 3) * Tq
                   + elems * sum(outs))
              + 4 * B * n * Tq * (1 if ins == 3 else 2))
    return bound_bf16(2.0 * HEAD_DIM * pairs * products, nbytes)


def bf16_err(got, ref):
    """(max |got - ref|, that over max |ref|) in f32."""
    diff = float((got.float() - ref.float()).abs().max())
    return diff, diff / max(float(ref.float().abs().max()), 1e-30)


def bf16_attn_inputs(rng, B, Tq, Tk, kv_len, causal, scale, n=N_HEADS):
    """bf16 q/k/v head views of packed [B, T, 3 * n * 64] planes, as the
    qkv fc writes them (q from a plane of its own when Tq != Tk), dO a
    head view of a [B, Tq, n * 64] plane, and the forward's LSE and
    delta (f32). Returns the backward's arguments and the forward's O."""
    dev, H = torch.device("cuda"), n * HEAD_DIM

    def plane(T, width):
        return torch.from_numpy(rng.randn(B, T, width).astype(np.float32)
                                ).to(dev, torch.bfloat16)
    kv = plane(Tk, 3 * H)
    qp = kv if Tq == Tk else plane(Tq, 3 * H)
    q, k, v = (fa._heads(t, n) for t in
               (qp[..., :H], kv[..., H:2 * H], kv[..., 2 * H:]))
    do = fa._heads(plane(Tq, H), n)
    lens = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    o, lse = fa.flash_attn_fwd_bf16(q, k, v, lens, torch.zeros_like(lens),
                                    causal, scale)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    return (q, k, v, do, lse, delta, lens), o


BF16_ATTN = {
    # name: (the TPU kernel it replaces, T x T x D products it computes)
    "flash_attn_fwd_bf16": ("paddle_tpu/ops/pallas_attention.py:212", 2),
    "flash_attn_bwd_fused_bf16": ("paddle_tpu/ops/pallas_attention.py:513",
                                  5),
    "flash_attn_bwd_dq_bf16": ("paddle_tpu/ops/pallas_attention.py:400", 3),
    "flash_attn_bwd_dkv_bf16": ("paddle_tpu/ops/pallas_attention.py:450",
                                4),
}


def bf16_kernel_phase(smi):
    """K1-, K3- and K4-bf16 against their plain bf16 versions at the
    training shape [8, 12, 1024, 64] (views of the packed planes), a
    ragged kv_len case and a Tq != Tk case, and K1-bf16 also at the amp
    batch step's [32, 12, 1024, 64]; K5-bf16 at x [8192, 768] and
    [32768, 768] @ w [768, 50304]. Each timed by CUDA-graph replay over two input sets
    (more than the L2 holds) beside its bf16 bound, its plain version
    and one library call: bf16 SDPA forward / backward (kernels named by
    profiler), logsumexp(mm(x, w) with f32 output)."""
    rng = np.random.RandomState(SEED + 6)
    scale = 1.0 / float(np.sqrt(HEAD_DIM))
    B, T = TRAIN_B, TRAIN_T
    cases = {"train": (B, T, T, [T] * B),
             "ragged": (4, 600, 600, [600, 333, 64, 1]),
             "cross": (2, 200, 700, [700, 450])}
    errs = {name: [0.0, 0.0] for name in BF16_ATTN if "fused" not in name}
    for case, (b, tq, tk, kv_len) in cases.items():
        args, o = bf16_attn_inputs(rng, b, tq, tk, kv_len, True, scale)
        q, k, v, do, lse, delta, lens = args
        starts = torch.zeros_like(lens)
        o_ref, lse_ref = fa.flash_attn_fwd_plain(q, k, v, lens, starts,
                                                 True, scale)
        ref = fa.flash_attn_bwd_fused_plain(*args, True, scale)
        dq = fa.flash_attn_bwd_dq_bf16(*args, True, scale)
        dk, dv = fa.flash_attn_bwd_dkv_bf16(*args, True, scale)
        torch.cuda.synchronize()
        lse_err = float((lse - lse_ref).abs().max())
        got = {"flash_attn_fwd_bf16": [(o, o_ref)],
               "flash_attn_bwd_dq_bf16": [(dq, ref[0])],
               "flash_attn_bwd_dkv_bf16": [(dk, ref[1]), (dv, ref[2])]}
        for name, pairs in got.items():
            e = [bf16_err(g, r) for g, r in pairs]
            ab, rel = max(x[0] for x in e), max(x[1] for x in e)
            errs[name] = [max(errs[name][0], ab), max(errs[name][1], rel)]
            log(f"bf16 {name} {case}: q [{b},{N_HEADS},{tq},{HEAD_DIM}] k "
                f"[{tk}] max_abs_err {ab:.3e}, {rel:.3e} of max |plain| "
                f"(tol {BF16_REL:g})" + (f"; LSE {lse_err:.3e} (tol "
                                         f"{TOL:g})" if "fwd" in name
                                         else ""))
            if not np.isfinite(rel) or rel > BF16_REL:
                raise AssertionError(f"{name} ({case}) disagrees with its "
                                     f"plain bf16 version beyond "
                                     f"{BF16_REL:g}")
        if not lse_err <= TOL:
            raise AssertionError(f"K1-bf16 ({case}) LSE disagrees with the "
                                 "plain version")
        del args, o, ref, dq, dk, dv
    full = [T] * B
    sets = [bf16_attn_inputs(rng, B, T, T, full, True, scale)[0]
            for _ in range(2)]
    starts = torch.zeros_like(sets[0][6])
    fwd_sets = [s_[:3] for s_ in sets]
    lens = sets[0][6]
    results = {}
    sdpa = (lambda q, k, v: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale))
    fwd_kernels = device_kernels(lambda: sdpa(*fwd_sets[0]))
    lib_bwd, lib_names = sdpa_backward(sets[0], scale)
    log(f"SDPA forward (causal, bf16) device kernels: {fwd_kernels}; "
        f"SDPA backward: {lib_bwd:.4f} ms of device work by queued CUDA "
        f"events, {sum(lib_names.values()) / 1e3:.4f} ms of profiled "
        f"kernels")
    timed = {
        "flash_attn_fwd_bf16": (
            lambda q, k, v: fa.flash_attn_fwd_bf16(q, k, v, lens, starts,
                                                   True, scale),
            lambda q, k, v: fa.flash_attn_fwd_plain(q, k, v, lens, starts,
                                                    True, scale),
            fwd_sets, time_ms(sdpa, fwd_sets, reps=20), fwd_kernels,
            (3, (T,))),
        "flash_attn_bwd_dq_bf16": (
            lambda *a: fa.flash_attn_bwd_dq_bf16(*a, True, scale),
            lambda *a: fa.flash_attn_bwd_dq_plain(*a, True, scale),
            sets, lib_bwd, lib_names, (4, (T,))),
        "flash_attn_bwd_dkv_bf16": (
            lambda *a: fa.flash_attn_bwd_dkv_bf16(*a, True, scale),
            lambda *a: fa.flash_attn_bwd_dkv_plain(*a, True, scale),
            sets, lib_bwd, lib_names, (4, (T, T))),
    }
    for name, (call, plain, sets_, lib_ms, lib_k, (ins, outs)) in \
            timed.items():
        replaces, products = BF16_ATTN[name]
        r = {"case": "train", "q": [B, N_HEADS, T, HEAD_DIM],
             "ms": time_ms(call, sets_, reps=20),
             "plain_ms": time_ms(plain, sets_, reps=3),
             "library_ms": lib_ms, "library_kernels": lib_k,
             "max_abs_err": errs[name][0], "max_rel_err": errs[name][1],
             "replaces": replaces}
        r["bound_ms"], r["bound_by"] = attn_bound_bf16(
            B, T, T, full, True, products, ins, outs)
        results[name] = r
        log(f"bf16 {name} train [{B},{N_HEADS},{T},{HEAD_DIM}]: ms "
            f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms "
            f"{lib_ms:.4f} bound_ms {r['bound_ms']:.5f} ({r['bound_by']}) "
            f"| {smi}")
    del sets, fwd_sets
    torch.cuda.empty_cache()
    results["flash_attn_fwd_bf16"]["batch"] = bf16_fwd_batch_case(
        rng, scale, smi)
    results["flash_attn_bwd_fused_bf16"] = fused_bf16_phase(rng, scale, smi)
    r = lse_bf16_case(rng, TRAIN_B * TRAIN_T, "train", smi)
    r["batch"] = lse_bf16_case(rng, AMP_BATCHES[0] * TRAIN_T, "batch",
                               smi)
    results["lm_head_lse_bf16"] = r
    return results


def bf16_fwd_batch_case(rng, scale, smi):
    """K1-bf16 at the amp batch step's shape [32, 12, 1024, 64] causal:
    384 heads, more than the SMs, so its persistent grid takes each
    head's units side by side (the train case's 96 heads fit the grid and
    go heaviest unit first). Held to the plain version (1e-2 of its
    largest element, LSE within TOL) and timed beside it, cuDNN's forward
    and the bound."""
    B, T = AMP_BATCHES[0], TRAIN_T
    full = [T] * B
    sets = [bf16_attn_inputs(rng, B, T, T, full, True, scale)
            for _ in range(2)]
    (q, k, v, _, lse, _, lens), o = sets[0]
    starts = torch.zeros_like(lens)
    o_ref, lse_ref = fa.flash_attn_fwd_plain(q, k, v, lens, starts, True,
                                             scale)
    ab, rel = bf16_err(o, o_ref)
    lse_err = float((lse - lse_ref).abs().max())
    log(f"bf16 flash_attn_fwd_bf16 batch: q [{B},{N_HEADS},{T},{HEAD_DIM}] "
        f"max_abs_err {ab:.3e}, {rel:.3e} of max |plain| (tol "
        f"{BF16_REL:g}); LSE {lse_err:.3e} (tol {TOL:g})")
    if not np.isfinite(rel) or rel > BF16_REL or not lse_err <= TOL:
        raise AssertionError("flash_attn_fwd_bf16 (batch) disagrees with "
                             "its plain bf16 version")
    del o, o_ref, lse_ref
    fwd_sets = [s_[0][:3] for s_ in sets]
    del sets
    r = {"case": "batch", "q": [B, N_HEADS, T, HEAD_DIM],
         "max_abs_err": ab, "max_rel_err": rel, "lse_err": lse_err,
         "ms": time_ms(lambda q, k, v: fa.flash_attn_fwd_bf16(
             q, k, v, lens, starts, True, scale), fwd_sets, reps=20),
         "plain_ms": time_ms(lambda q, k, v: fa.flash_attn_fwd_plain(
             q, k, v, lens, starts, True, scale), fwd_sets, reps=3),
         "library_ms": time_ms(
             lambda q, k, v: torch.nn.functional.scaled_dot_product_attention(
                 q, k, v, is_causal=True, scale=scale), fwd_sets, reps=20)}
    r["bound_ms"], r["bound_by"] = attn_bound_bf16(B, T, T, full, True, 2,
                                                   3, (T,))
    log(f"bf16 flash_attn_fwd_bf16 batch [{B},{N_HEADS},{T},{HEAD_DIM}]: ms "
        f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms "
        f"{r['library_ms']:.4f} bound_ms {r['bound_ms']:.5f} "
        f"({r['bound_by']}) | {smi}")
    del fwd_sets
    torch.cuda.empty_cache()
    return r


def lse_bf16_case(rng, N, case, smi, hid=HID):
    """K5-bf16 at x [N, hid] @ w [hid, 50304] (N 8192 for the B 8 step,
    32768 for the amp batch steps; hid 768, 1024 for GPT-2-medium):
    within TOL of its plain version, the same bits in two calls, timed
    beside the plain version, logsumexp(mm(x, w) with f32 output) and
    the bound."""
    dev = torch.device("cuda")
    lse_sets = [(torch.from_numpy(rng.randn(N, hid).astype(np.float32))
                 .to(dev, torch.bfloat16),
                 torch.from_numpy((rng.randn(hid, VOCAB) * 0.02)
                                  .astype(np.float32)).to(dev, torch.bfloat16))
                for _ in range(2)]
    got = ce.lm_head_lse_bf16(*lse_sets[0])
    again = ce.lm_head_lse_bf16(*lse_sets[0])
    torch.cuda.synchronize()
    ref = ce.lm_head_lse_plain(*lse_sets[0])
    err = float((got - ref).abs().max())
    log(f"bf16 lm_head_lse_bf16: x [{N},{hid}] w [{hid},{VOCAB}] "
        f"max_abs_err {err:.3e} (tol {TOL:g}); two calls bitwise equal: "
        f"{bool(torch.equal(got, again))}")
    if not np.isfinite(err) or err > TOL:
        raise AssertionError(f"lm_head_lse_bf16 (N {N}) disagrees with its "
                             "plain version")
    if not torch.equal(got, again):
        raise AssertionError(f"lm_head_lse_bf16 (N {N}): two calls on the "
                             "same inputs differ (the split merge must be "
                             "in order)")
    del got, again, ref
    r = {"case": case, "x": [N, hid], "max_abs_err": err,
         "ms": time_ms(ce.lm_head_lse_bf16, lse_sets, reps=10),
         "plain_ms": time_ms(ce.lm_head_lse_plain, lse_sets, reps=3),
         "library_ms": time_ms(lambda x, w: torch.logsumexp(
             torch.mm(x, w, out_dtype=torch.float32), dim=1), lse_sets,
             reps=5),
         "replaces": "paddle_tpu/ops/chunked_ce.py:90"}
    r["bound_ms"], r["bound_by"] = bound_bf16(
        2.0 * N * hid * VOCAB, 2.0 * (N * hid + hid * VOCAB) + 4.0 * N)
    log(f"bf16 lm_head_lse_bf16 N {N}: ms {r['ms']:.4f} plain_ms "
        f"{r['plain_ms']:.4f} library_ms (logsumexp(mm(x, w, f32 out))) "
        f"{r['library_ms']:.4f} bound_ms {r['bound_ms']:.5f} "
        f"({r['bound_by']}) | {smi}")
    del lse_sets
    torch.cuda.empty_cache()
    return r


def fused_bf16_phase(rng, scale, smi):
    """K2-bf16 against the plain bf16 backward at its main-path shape
    [32, 12, 256, 64] (the amp T 256 step), a ragged kv_len case and a
    Tq > Tk case, all views of packed planes (Tk <= 256: the fused
    route), and against itself (two calls, bitwise: dq is summed on chip
    in a fixed order); timed at the main-path shape beside its bf16
    bound, the plain version and cuDNN's SDPA backward kernels on the
    same inputs, in the same run."""
    name = "flash_attn_bwd_fused_bf16"
    B, T = SHORT_B, SHORT_T
    cases = {"short": (B, T, T, [T] * B),
             "ragged": (4, 200, 200, [200, 150, 64, 1]),
             "cross": (2, 300, 190, [190, 77])}
    worst = [0.0, 0.0]
    for case, (b, tq, tk, kv_len) in cases.items():
        args, _ = bf16_attn_inputs(rng, b, tq, tk, kv_len, True, scale)
        ref = fa.flash_attn_bwd_fused_plain(*args, True, scale)
        got = fa.flash_attn_bwd_fused_bf16(*args, True, scale)
        torch.cuda.synchronize()
        if any(g.dtype != torch.bfloat16 for g in got):
            raise AssertionError(f"{name} ({case}): gradients not bf16")
        e = [bf16_err(g, r) for g, r in zip(got, ref)]
        ab, rel = max(x[0] for x in e), max(x[1] for x in e)
        worst = [max(worst[0], ab), max(worst[1], rel)]
        log(f"bf16 {name} {case}: q [{b},{N_HEADS},{tq},{HEAD_DIM}] k "
            f"[{tk}] max_abs_err {ab:.3e}, {rel:.3e} of max |plain| (dq "
            f"{e[0][1]:.3e}, dk {e[1][1]:.3e}, dv {e[2][1]:.3e}; tol "
            f"{BF16_REL:g})")
        if not np.isfinite(rel) or rel > BF16_REL:
            raise AssertionError(f"{name} ({case}) disagrees with its plain "
                                 f"bf16 version beyond {BF16_REL:g}")
        del args, ref, got
    full = [T] * B
    sets = [bf16_attn_inputs(rng, B, T, T, full, True, scale)[0]
            for _ in range(2)]
    got = fa.flash_attn_bwd_fused_bf16(*sets[0], True, scale)
    again = fa.flash_attn_bwd_fused_bf16(*sets[0], True, scale)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    log(f"bf16 {name} short: two calls bitwise equal: {same}")
    if not same:
        raise AssertionError(f"{name}: two calls on the same inputs differ "
                             "(dq must be summed in a fixed order)")
    del got, again
    lib_ms, lib_names = sdpa_backward(sets[0], scale)
    replaces, products = BF16_ATTN[name]
    r = {"case": "short", "q": [B, N_HEADS, T, HEAD_DIM],
         "ms": time_ms(lambda *a: fa.flash_attn_bwd_fused_bf16(
             *a, True, scale), sets, reps=20),
         "plain_ms": time_ms(lambda *a: fa.flash_attn_bwd_fused_plain(
             *a, True, scale), sets, reps=3),
         "library_ms": lib_ms, "library_kernels": lib_names,
         "max_abs_err": worst[0],
         "max_rel_err": worst[1], "replaces": replaces}
    r["bound_ms"], r["bound_by"] = attn_bound_bf16(
        B, T, T, full, True, products, 4, (T, T, T))
    log(f"bf16 {name} short [{B},{N_HEADS},{T},{HEAD_DIM}]: ms "
        f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms (cuDNN "
        f"SDPA backward) {r['library_ms']:.4f} bound_ms "
        f"{r['bound_ms']:.5f} ({r['bound_by']}) | {smi}")
    del sets
    torch.cuda.empty_cache()
    return r


# -- phase 12-14: amp training ------------------------------------------------

class PlainAttention(torch.autograd.Function):
    """Causal attention over [B, n, T, D] bf16 heads through the plain
    bf16 versions of K1 (forward) and K3 + K4 (backward): no kernel."""

    @staticmethod
    def forward(ctx, q, k, v):
        lens = torch.full((q.shape[0],), q.shape[2], dtype=torch.int32,
                          device=q.device)
        o, lse = fa.flash_attn_fwd_plain(q, k, v, lens,
                                         torch.zeros_like(lens), True)
        ctx.save_for_backward(q, k, v, o, lse, lens)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, lens = ctx.saved_tensors
        delta = (do.float() * o.float()).sum(-1)
        return fa.flash_attn_bwd_fused_plain(q, k, v, do, lse, delta, lens,
                                             True)


def amp_reference_loss_and_grads(w, feed):
    """The amp model as plain PyTorch on the card, with the reference's
    role casts written out: compute-role products on bf16 operands (the
    f32 masters cast), follow-role adds in bf16 once an operand is bf16
    (block 0's residual add turns the f32 embeddings bf16), layer norm's
    statistics in f32 and its output in its input's dtype, attention
    through the plain bf16 K1 / K3 + K4 (PlainAttention), the
    cross-entropy from f32 logits of the bf16 head; gradients by torch
    autograd through the casts, so the masters' are f32."""
    bf = torch.bfloat16
    dev = w["tok_emb"].device
    tok = torch.from_numpy(feed["tok"][..., 0]).to(dev)
    nxt = torch.from_numpy(feed["nxt"]).to(dev).reshape(-1)
    B, T = tok.shape

    def ln(x, g, b):
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        return ((xf - mu) / torch.sqrt(var + 1e-5) * g + b).to(x.dtype)

    def fc(x, name):
        return (torch.matmul(x.to(bf), w[f"{name}.w"].to(bf))
                + w[f"{name}.b"].to(bf))

    x = w["tok_emb"][tok] + w["pos_emb"][:T]
    for i in range(LAYERS):
        p = f"block{i}"
        qkv = fc(ln(x, w[f"{p}.ln1.w_0"], w[f"{p}.ln1.w_1"]), f"{p}.qkv")
        q, k, v = (fa._heads(t, N_HEADS) for t in qkv.split(HID, dim=2))
        a = fa._merge(PlainAttention.apply(q, k, v))
        x = x.to(bf) + fc(a, f"{p}.proj")
        h = ln(x, w[f"{p}.ln2.w_0"], w[f"{p}.ln2.w_1"])
        up = torch.nn.functional.gelu(fc(h, f"{p}.ffn_up"),
                                      approximate="tanh")
        x = x + fc(up, f"{p}.ffn_down")
    x = ln(x, w["ln_f.w_0"], w["ln_f.w_1"])
    logits = (x.reshape(B * T, HID).float()
              @ w["lm_head.w"].to(bf).float())
    loss = torch.nn.functional.cross_entropy(logits, nxt)
    names = sorted(w)
    grads = torch.autograd.grad(loss, [w[n] for n in names])
    return loss.detach(), dict(zip(names, grads))


# step 1 under amp against the plain amp recompute: loss within 1e-5
# relative (the forward's f32 sums in other orders), each gradient within
# 2e-2 of its largest element (bf16 activations rounded in other places:
# flash tiles against one softmax, the chunked cross-entropy backward's
# bf16 d against autograd's f32 logits gradient); against the f32 step,
# the loss within 2e-2 relative
AMP_LOSS_RTOL, AMP_GRAD_RTOL, AMP_VS_F32_RTOL = 1e-5, 2e-2, 2e-2
AMP_KERNELS = {"flash_attn_fwd_bf16": ("flash_fwd_bf16_kernel",),
               "flash_attn_bwd_fused_bf16": ("bwd_fused_bf16_kernel",),
               "flash_attn_bwd_dq_bf16": ("bwd_dq_bf16_kernel",),
               "flash_attn_bwd_dkv_bf16": ("bwd_dkv_bf16_kernel",),
               "lm_head_lse_bf16": ("lse_bf16_kernel",
                                    "lse_bf16_merge_kernel")}
# cuBLAS's bf16 products (Hopper cuBLAS names its kernels nvjet_* or
# sm90_xmma_gemm_*) and the dtype conversions / copies, by kernel name
GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass")
CAST_NAMES = ("copy_kernel",)


def amp_step_breakdown(what, exe, main, feed, cost, scope, step_ms, smi):
    """One more amp step under torch.profiler: its device time split
    into cuBLAS's bf16 products, the bf16 kernels, casts (and
    copies), Adam (the adam ops' kernels, marked by record_function
    around the op's lowering) and the other elementwise kernels; device
    busy / wall."""
    from torch.profiler import ProfilerActivity, profile, record_function
    adam = op_registry._REGISTRY["adam"]

    def marked(ctx, ins, attrs):
        with record_function("amp/adam"):
            return adam.lowering(ctx, ins, attrs)
    op_registry._REGISTRY["adam"] = adam._replace(lowering=marked)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
            torch.cuda.synchronize()
    finally:
        op_registry._REGISTRY["adam"] = adam
    parts = {"kernels": 0.0, "cublas_bf16_products": 0.0, "casts": 0.0,
             "other": 0.0}
    per_kernel = dict.fromkeys(AMP_KERNELS, 0.0)
    top, adam_us, device_us = {}, 0.0, 0.0
    for ev in prof.events():
        if ev.name == "amp/adam":
            if getattr(ev, "device_type", None) != \
                    torch.autograd.DeviceType.CUDA:
                adam_us += float(getattr(ev, "device_time_total", 0.0)
                                 or 0.0)
            continue
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = float(ev.time_range.elapsed_us())
        device_us += us
        top[ev.name[:200]] = top.get(ev.name[:200], 0.0) + us
        kname = next((k for k, frags in AMP_KERNELS.items()
                      if any(f in ev.name for f in frags)), None)
        if kname:
            per_kernel[kname] += us
            parts["kernels"] += us
        elif any(f in ev.name.lower() for f in GEMM_NAMES):
            parts["cublas_bf16_products"] += us
        elif any(f in ev.name for f in CAST_NAMES):
            parts["casts"] += us
        else:
            parts["other"] += us
    if device_us <= 0:
        log(f"{what} step breakdown: the profiler recorded no device "
            "time; device time not measured")
        return None
    ms = {k: v / 1e3 for k, v in parts.items()}
    ms["adam"] = adam_us / 1e3
    ms["elementwise"] = ms.pop("other") - ms["adam"]
    device_ms = device_us / 1e3
    top = sorted(top.items(), key=lambda kv: -kv[1])[:12]
    log(f"{what} step breakdown (profiled step): device {device_ms:.1f} ms "
        f"of kernels against a {step_ms:.1f} ms unprofiled step wall (busy "
        f"share {device_ms / step_ms:.3f}); ms "
        f"{ {k: round(v, 3) for k, v in ms.items()} }; the bf16 kernels ms "
        f"{ {k: round(v / 1e3, 3) for k, v in per_kernel.items()} } | {smi}")
    log(f"{what} step: largest device kernels (us) "
        f"{[(n, round(us, 1)) for n, us in top]}")
    return {"device_ms": device_ms, "ms": ms,
            "kernel_ms": {k: v / 1e3 for k, v in per_kernel.items()},
            "share": {k: v / device_ms for k, v in ms.items()},
            "busy": device_ms / step_ms}


def float_state_dtypes(scope):
    return {str(t.dtype) for t in scope.vars.values()
            if isinstance(t, torch.Tensor) and t.is_floating_point()}


def amp_training_phase(smi, f32_loss, T, B, feed_seed, timed_steps):
    """The f32 training phases' model, weights and token batch (T, B,
    feed_seed) under bf16 amp: step 1's loss and gradients against the
    plain amp recompute and, loosely, the f32 step 1 (f32_loss); f32
    masters, moments and gradients; `timed_steps` more Adam steps;
    launches of the bf16 kernels of T's backward route only; a profiled
    step."""
    torch.cuda.empty_cache()
    main, startup, cost, params_grads = build_gpt2(T)
    amp.enable(main)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    feed = token_batch(B, T, feed_seed)
    names = [p.name for p, _ in params_grads]
    snapshot = {n: scope.get(n).detach().clone().requires_grad_()
                for n in names}
    what = f"amp training T {T} B {B}"

    zero_counts()                       # the main path starts here
    torch.cuda.reset_peak_memory_stats()
    t_step = time.perf_counter()
    out = exe.run(main, feed=feed, fetch_list=[cost] + [
        g for _, g in params_grads], scope=scope, return_numpy=False)
    torch.cuda.synchronize()
    step1_ms = 1e3 * (time.perf_counter() - t_step)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    loss = float(out[0][0])
    grads = dict(zip(names, out[1:]))
    if {str(g.dtype) for g in grads.values()} != {"torch.float32"} or \
            float_state_dtypes(scope) != {"torch.float32"}:
        raise AssertionError(f"{what}: a gradient, master weight or Adam "
                             "moment is not float32")
    ref_loss, ref_grads = amp_reference_loss_and_grads(snapshot, feed)
    del snapshot
    loss_rel = abs(loss - float(ref_loss)) / abs(float(ref_loss))
    worst = max((float((g - ref_grads[n]).abs().max())
                 / max(float(ref_grads[n].abs().max()), 1e-30), n)
                for n, g in grads.items())
    vs_f32 = abs(loss - f32_loss) / abs(f32_loss)
    log(f"{what} step 1: loss {loss:.6f} vs plain amp recompute "
        f"{float(ref_loss):.6f} ({loss_rel:.2e} relative, tol "
        f"{AMP_LOSS_RTOL:g}); worst gradient {worst[1]} at {worst[0]:.2e} "
        f"of its largest element (tol {AMP_GRAD_RTOL:g}) over {len(names)} "
        f"parameters; vs the f32 step-1 loss {f32_loss:.6f}: {vs_f32:.2e} "
        f"relative (tol {AMP_VS_F32_RTOL:g})")
    if not np.isfinite(loss) or loss_rel > AMP_LOSS_RTOL:
        raise AssertionError(f"{what}: step-1 loss differs from the plain "
                             "amp recompute")
    if not worst[0] <= AMP_GRAD_RTOL:
        raise AssertionError(f"{what}: gradient of {worst[1]} differs from "
                             f"the plain amp recompute by {worst[0]:.3e}")
    if not vs_f32 <= AMP_VS_F32_RTOL:
        raise AssertionError(f"{what}: step-1 loss is not within 2e-2 of "
                             "f32's")
    del ref_grads, out
    losses, wall = [loss], []
    for _ in range(timed_steps):
        t_step = time.perf_counter()
        losses.append(float(exe.run(main, feed=feed, fetch_list=[cost],
                                    scope=scope)[0][0]))
        wall.append(1e3 * (time.perf_counter() - t_step))
    counts = read_counts()              # the main path ends here
    partials = fa.flash_attn_bwd_fused.dq_partials
    steps = len(losses)
    route = fa.bwd_route(T)
    log(f"{what}: losses {[round(x, 5) for x in losses]}; f32 dq partial "
        f"buffers allocated: {partials}")
    if partials:                        # the bf16 K2 sums dq on chip
        raise AssertionError(f"{what}: the bf16 path allocated {partials} "
                             "f32 dq partial buffers")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"{what}: the loss did not fall over "
                             f"{timed_steps} Adam steps on a fixed batch")
    split = LAYERS * steps if route == "split" else 0
    check_counts(counts, launches_of(
        flash_attn_fwd_bf16=LAYERS * steps,
        flash_attn_bwd_fused_bf16=LAYERS * steps - split,
        flash_attn_bwd_dq_bf16=split, flash_attn_bwd_dkv_bf16=split,
        lm_head_lse_bf16=steps), f"{what} ({steps} steps, route {route})")
    if float_state_dtypes(scope) != {"torch.float32"}:
        raise AssertionError(f"{what}: master weights or moments left "
                             "float32")
    step_ms = float(np.mean(wall))
    tokens = B * T
    log(f"{what}: launches {counts} over {steps} steps (route {route}); "
        f"step wall {step_ms:.1f} ms (mean of steps 2-{steps}, min "
        f"{min(wall):.1f}; step 1 with gradient fetch {step1_ms:.1f}), "
        f"{tokens / step_ms * 1e3:.0f} tokens/s, peak memory "
        f"{peak_gb:.1f} GiB | {smi}")
    breakdown = amp_step_breakdown(what, exe, main, feed, cost, scope,
                                   step_ms, smi)
    del scope, exe
    torch.cuda.empty_cache()
    return counts, {"T": T, "batch": B, "route": route,
                    "dq_partials": partials, "step_ms": step_ms,
                    "tokens_per_s": tokens / step_ms * 1e3,
                    "losses": losses, "loss_rel": loss_rel,
                    "grad_worst": worst[0], "vs_f32_rel": vs_f32,
                    "peak_gib": peak_gb, "breakdown": breakdown}


AMP_BATCHES = (32, 24, 16)   # bench.py's headline batch first


def amp_batch_phase(smi):
    """The amp program at the reference's headline batch (bench.py's
    bench_transformer_mfu, B 32, T 1024), or the largest of AMP_BATCHES
    that fits on the card: three timed steps and a profiled one (no
    recompute fits beside it)."""
    for B in AMP_BATCHES:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        main, startup, cost, _ = build_gpt2(TRAIN_T)
        amp.enable(main)
        exe, scope = pt.Executor(), pt.Scope()
        exe.run(startup, scope=scope)
        feed = token_batch(B, TRAIN_T, SEED + 7)
        try:
            exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
            torch.cuda.synchronize()
            wall, losses = [], []
            for _ in range(3):
                t_step = time.perf_counter()
                losses.append(float(exe.run(main, feed=feed,
                                            fetch_list=[cost],
                                            scope=scope)[0][0]))
                wall.append(1e3 * (time.perf_counter() - t_step))
        except torch.cuda.OutOfMemoryError as e:
            log(f"amp batch {B}: out of memory ({str(e)[:120]}); trying a "
                f"smaller batch")
            del scope, exe
            continue
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        if not np.isfinite(losses).all():
            raise AssertionError(f"amp batch {B}: non-finite loss")
        step_ms = float(np.mean(wall))
        tokens = B * TRAIN_T
        log(f"amp training B {B} T {TRAIN_T}: step wall {step_ms:.1f} ms "
            f"(mean of 3 after a warm step, min {min(wall):.1f}), "
            f"{tokens / step_ms * 1e3:.0f} tokens/s, peak memory "
            f"{peak_gb:.1f} GiB | {smi}")
        breakdown = amp_step_breakdown(f"amp training B {B} T {TRAIN_T}",
                                       exe, main, feed, cost, scope,
                                       step_ms, smi)
        del scope, exe
        torch.cuda.empty_cache()
        return {"batch": B, "step_ms": step_ms,
                "tokens_per_s": tokens / step_ms * 1e3, "peak_gib": peak_gb,
                "breakdown": breakdown}
    raise AssertionError(f"amp: none of the batches {AMP_BATCHES} fits")


# -- phases 15-19: GPT-2-medium ------------------------------------------------

# bench.py's bench_gpt2_medium_mfu: vocab 50304, H 1024, 24 layers, 16
# heads (D 64), T 1024, B 32, bf16 amp, the scan-stacked block
# (transformer_stack) with remat on
MED_HID, MED_LAYERS, MED_HEADS, MED_B = 1024, 24, 16, 32
MED_SPEC_ARGS = (VOCAB, MED_HID, MED_LAYERS, MED_HEADS, TRAIN_T)
MED_LEAVES = T._LEAVES
# the f32 checks' batch (phase 15's f32 attention kernels, phase 17)
MED_F32_B = 4
MED_AMP_CHECK_B, MED_MEM_B = 4, 8


def medium_kernel_phase(smi):
    """GPT-2-medium's kernel shapes: K5 at x [8192, 1024] and K5-bf16 at
    [32768, 1024] @ w [1024, 50304]; both K5 kernels at H 1000, whose
    last 64-deep k chunk is ragged; K1-, K3- and K4-bf16 at [32, 16,
    1024, 64] causal and the f32 K1, K3, K4 at [4, 16, 1024, 64]. Each
    held to its plain version and timed beside the plain version, its
    library yardstick and its bound."""
    rng = np.random.RandomState(SEED + 15)
    out = {"lm_head_lse": lse_case(rng, TRAIN_B * TRAIN_T, MED_HID,
                                   "gpt2_medium", smi),
           "lm_head_lse_bf16": lse_bf16_case(rng, MED_B * TRAIN_T,
                                             "gpt2_medium", smi,
                                             hid=MED_HID)}
    dev = torch.device("cuda")
    for dtype, fn in ((torch.float32, ce.lm_head_lse),
                      (torch.bfloat16, ce.lm_head_lse_bf16)):
        x = torch.from_numpy(rng.randn(2048, 1000).astype(np.float32)).to(
            dev, dtype)
        w = torch.from_numpy((rng.randn(1000, VOCAB) * 0.02).astype(
            np.float32)).to(dev, dtype)
        err = float((fn(x, w) - ce.lm_head_lse_plain(x, w)).abs().max())
        log(f"kernel {fn.__name__} ragged k: x [2048,1000] w [1000,{VOCAB}]"
            f" max_abs_err {err:.3e} (tol {TOL:g})")
        if not err <= TOL:
            raise AssertionError(f"{fn.__name__} at H 1000 disagrees with "
                                 "its plain version")
        out[fn.__name__]["ragged_h1000_err"] = err
        del x, w
    scale = 1.0 / float(np.sqrt(HEAD_DIM))
    out.update(medium_attn_bf16(rng, scale, smi))
    out.update(medium_attn_f32(rng, scale, smi))
    torch.cuda.empty_cache()
    return out


def medium_attn_bf16(rng, scale, smi):
    """K1-, K3- and K4-bf16 at [32, 16, 1024, 64] causal: each within
    BF16_REL of its plain bf16 version (LSE within TOL), then timed
    beside the plain version, cuDNN's SDPA forward / backward and the
    bound."""
    B, n, T_ = MED_B, MED_HEADS, TRAIN_T
    full = [T_] * B
    sets = [bf16_attn_inputs(rng, B, T_, T_, full, True, scale, n=n)
            for _ in range(2)]
    (q, k, v, do, lse, delta, lens), o = sets[0]
    args = sets[0][0]
    starts = torch.zeros_like(lens)
    o_ref, lse_ref = fa.flash_attn_fwd_plain(q, k, v, lens, starts, True,
                                             scale)
    lse_err = float((lse - lse_ref).abs().max())
    errs = {"flash_attn_fwd_bf16": bf16_err(o, o_ref)}
    del o_ref, lse_ref
    ref = fa.flash_attn_bwd_fused_plain(*args, True, scale)
    dq = fa.flash_attn_bwd_dq_bf16(*args, True, scale)
    dk, dv = fa.flash_attn_bwd_dkv_bf16(*args, True, scale)
    torch.cuda.synchronize()
    errs["flash_attn_bwd_dq_bf16"] = bf16_err(dq, ref[0])
    e_k, e_v = bf16_err(dk, ref[1]), bf16_err(dv, ref[2])
    errs["flash_attn_bwd_dkv_bf16"] = (max(e_k[0], e_v[0]),
                                       max(e_k[1], e_v[1]))
    del ref, dq, dk, dv
    for name, (ab, rel) in errs.items():
        log(f"bf16 {name} gpt2_medium: q [{B},{n},{T_},{HEAD_DIM}] "
            f"max_abs_err {ab:.3e}, {rel:.3e} of max |plain| (tol "
            f"{BF16_REL:g})" + (f"; LSE {lse_err:.3e} (tol {TOL:g})"
                                if "fwd" in name else ""))
        if not np.isfinite(rel) or rel > BF16_REL:
            raise AssertionError(f"{name} (gpt2_medium) disagrees with its "
                                 f"plain bf16 version beyond {BF16_REL:g}")
    if not lse_err <= TOL:
        raise AssertionError("K1-bf16 (gpt2_medium) LSE disagrees with the "
                             "plain version")
    bwd_sets = [s_[0] for s_ in sets]
    fwd_sets = [a[:3] for a in bwd_sets]
    del sets, o
    sdpa = (lambda q, k, v: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale))
    lib_bwd, lib_names = sdpa_backward(bwd_sets[0], scale)
    timed = {
        "flash_attn_fwd_bf16": (
            lambda q, k, v: fa.flash_attn_fwd_bf16(q, k, v, lens, starts,
                                                   True, scale),
            lambda q, k, v: fa.flash_attn_fwd_plain(q, k, v, lens, starts,
                                                    True, scale),
            fwd_sets, time_ms(sdpa, fwd_sets, reps=10),
            device_kernels(lambda: sdpa(*fwd_sets[0])), (3, (T_,))),
        "flash_attn_bwd_dq_bf16": (
            lambda *a: fa.flash_attn_bwd_dq_bf16(*a, True, scale),
            lambda *a: fa.flash_attn_bwd_dq_plain(*a, True, scale),
            bwd_sets, lib_bwd, lib_names, (4, (T_,))),
        "flash_attn_bwd_dkv_bf16": (
            lambda *a: fa.flash_attn_bwd_dkv_bf16(*a, True, scale),
            lambda *a: fa.flash_attn_bwd_dkv_plain(*a, True, scale),
            bwd_sets, lib_bwd, lib_names, (4, (T_, T_))),
    }
    results = {}
    for name, (call, plain, sets_, lib_ms, lib_k, (ins, outs)) in \
            timed.items():
        _, products = BF16_ATTN[name]
        r = {"case": "gpt2_medium", "q": [B, n, T_, HEAD_DIM],
             "ms": time_ms(call, sets_, reps=10),
             "plain_ms": time_ms(plain, sets_, reps=2),
             "library_ms": lib_ms, "library_kernels": lib_k,
             "max_abs_err": errs[name][0], "max_rel_err": errs[name][1]}
        r["bound_ms"], r["bound_by"] = attn_bound_bf16(
            B, T_, T_, full, True, products, ins, outs, n=n)
        results[name] = r
        log(f"bf16 {name} gpt2_medium [{B},{n},{T_},{HEAD_DIM}]: ms "
            f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms "
            f"{lib_ms:.4f} bound_ms {r['bound_ms']:.5f} ({r['bound_by']}) "
            f"| {smi}")
    del bwd_sets, fwd_sets
    torch.cuda.empty_cache()
    return results


MED_F32_KERNELS = {
    # name: (call, which of (dq, dk, dv) it returns, T x T x D products,
    # outputs' lengths)
    "flash_attn_bwd_dq": (lambda *a: (fa.flash_attn_bwd_dq(*a),), (0,), 3,
                          (TRAIN_T,)),
    "flash_attn_bwd_dkv": (lambda *a: fa.flash_attn_bwd_dkv(*a), (1, 2), 4,
                           (TRAIN_T, TRAIN_T)),
}


def medium_attn_f32(rng, scale, smi):
    """The f32 K1, K3 and K4 at [4, 16, 1024, 64] causal (phase 17's
    shapes): within TOL (relative to the larger of 1 and the plain
    output's largest element) of the plain versions, timed beside the
    plain versions, torch's SDPA forward / backward and the bounds."""
    B, n, T_ = MED_F32_B, MED_HEADS, TRAIN_T
    full = [T_] * B
    sets = [bwd_inputs(rng, B, T_, T_, full, True, scale, n=n)
            for _ in range(2)]
    q, k, v, do, lse, delta, lens = sets[0]
    starts = torch.zeros_like(lens)
    o, lse_k = fa.flash_attn_fwd(q, k, v, lens, starts, True, scale)
    o_ref, lse_ref = fa.flash_attn_fwd_plain(q, k, v, lens, starts, True,
                                             scale)
    errs = {"flash_attn_fwd": max(float((o - o_ref).abs().max()),
                                  float((lse_k - lse_ref).abs().max()))}
    ref = fa.flash_attn_bwd_fused_plain(*sets[0], True, scale)
    for name, (call, idx, _, _) in MED_F32_KERNELS.items():
        got = call(*sets[0], True, scale)
        errs[name] = max(rel_err(g, ref[i]) for g, i in zip(got, idx))
    torch.cuda.synchronize()
    del o, o_ref, lse_k, lse_ref, ref
    for name, err in errs.items():
        log(f"kernel {name} gpt2_medium: q [{B},{n},{T_},{HEAD_DIM}] "
            f"max err {err:.3e} (tol {TOL:g})")
        if not np.isfinite(err) or err > TOL:
            raise AssertionError(f"{name} (gpt2_medium) disagrees with its "
                                 "plain version")
    lib_bwd, lib_names = sdpa_backward(sets[0], scale)
    fwd_sets = [s_[:3] for s_ in sets]
    sdpa = (lambda q, k, v: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale))
    results = {"flash_attn_fwd": {
        "ms": time_ms(lambda q, k, v: fa.flash_attn_fwd(
            q, k, v, lens, starts, True, scale), fwd_sets, reps=20),
        "plain_ms": time_ms(lambda q, k, v: fa.flash_attn_fwd_plain(
            q, k, v, lens, starts, True, scale), fwd_sets, reps=4),
        "library_ms": time_ms(sdpa, fwd_sets, reps=20)}}
    results["flash_attn_fwd"].update(zip(
        ("bound_ms", "bound_by", "bound_3xtf32_ms"),
        attn_bound(B, T_, T_, full, True, 2, 3, (T_,), n=n)))
    plains = {"flash_attn_bwd_dq": fa.flash_attn_bwd_dq_plain,
              "flash_attn_bwd_dkv": fa.flash_attn_bwd_dkv_plain}
    for name, (call, _, products, outs) in MED_F32_KERNELS.items():
        r = {"ms": time_ms(lambda *a: call(*a, True, scale), sets, reps=10),
             "plain_ms": time_ms(lambda *a: plains[name](*a, True, scale),
                                 sets, reps=4),
             "library_ms": lib_bwd, "library_kernels": lib_names}
        r.update(zip(("bound_ms", "bound_by", "bound_3xtf32_ms"),
                     attn_bound(B, T_, T_, full, True, products, 4, outs,
                                n=n)))
        results[name] = r
    for name, r in results.items():
        r.update(case="gpt2_medium", q=[B, n, T_, HEAD_DIM],
                 max_abs_err=errs[name])
        log(f"kernel {name} gpt2_medium [{B},{n},{T_},{HEAD_DIM}]: ms "
            f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms "
            f"{r['library_ms']:.4f} bound_ms {r['bound_ms']:.5f} "
            f"({r['bound_by']}), 3xTF32 {r['bound_3xtf32_ms']:.5f} | {smi}")
    del sets, fwd_sets
    torch.cuda.empty_cache()
    return results


def build_gpt2_medium(B):
    """bench.py's _mfu_bench program at GPT-2-medium: tokens drawn by
    uniform_random, floor and cast inside the program, the stacked
    transformer_lm_cost, Adam(1e-4). Returns (main, startup, cost,
    params_grads, tok, nxt)."""
    pt.framework.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        lf = pt.layers.uniform_random([B, TRAIN_T, 1], min=1.0,
                                      max=float(VOCAB) - 0.01)
        tok = pt.layers.cast(pt.layers.floor(lf), "int64")
        nxt = pt.layers.cast(pt.layers.floor(pt.layers.uniform_random(
            [B, TRAIN_T, 1], min=1.0, max=float(VOCAB) - 0.01)), "int64")
        cost = pt.models.transformer.transformer_lm_cost(
            tok, nxt, VOCAB, hid=MED_HID, num_layers=MED_LAYERS,
            num_heads=MED_HEADS, max_len=TRAIN_T, stacked=True)
        _, params_grads = pt.AdamOptimizer(LR).minimize(cost)
    return main, startup, cost, params_grads, tok, nxt


def stacked_reference_loss_and_grads(w, tok, nxt, bf16):
    """The stacked GPT-2-medium as plain PyTorch on the card, from the
    same weights `w` (f32 leaves) and tokens: attention through plain
    softmax over the full [T, T] scores (f32) or the plain bf16 K1 / K3
    + K4 versions (PlainAttention, bf16); with `bf16`, the amp role
    casts written out (the embeddings' sum and every stacked leaf cast
    to bf16 at the stack, layer norm's statistics in f32 and its output
    in its input's dtype, the head's product on bf16 operands with f32
    output). Loss by cross-entropy over the full [B*T, V] logits;
    gradients by torch autograd."""
    dt = torch.bfloat16 if bf16 else torch.float32
    B, T_ = tok.shape
    n, H = MED_HEADS, MED_HID
    D = H // n
    causal = torch.ones(T_, T_, dtype=torch.bool, device=tok.device).tril()

    def ln(x, g, b):
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        return ((xf - mu) / torch.sqrt(var + 1e-5) * g + b).to(x.dtype)

    def attention(q, k, v):
        q, k, v = (fa._heads(t, n) for t in (q, k, v))
        if bf16:
            return fa._merge(PlainAttention.apply(q, k, v))
        s = (q @ k.transpose(-1, -2)) / float(np.sqrt(D))
        return fa._merge(torch.softmax(
            s.masked_fill(~causal, float("-inf")), -1) @ v)

    x = (w["tok_emb"][tok] + w["pos_emb"][:T_]).to(dt)
    layers = zip(*(w[f"stack.{leaf}"].to(dt).unbind(0)
                   for leaf in MED_LEAVES))
    for (ln1g, ln1b, wqkv, bqkv, wproj, bproj, ln2g, ln2b, wup, bup,
         wdown, bdown) in layers:
        h = ln(x, ln1g, ln1b)
        qkv = (h @ wqkv + bqkv).view(B, T_, n, 3, D)
        q, k, v = (qkv[:, :, :, m].reshape(B, T_, H) for m in range(3))
        x = x + attention(q, k, v) @ wproj + bproj
        h = ln(x, ln2g, ln2b)
        up = torch.nn.functional.gelu(h @ wup + bup, approximate="tanh")
        x = x + up @ wdown + bdown
    x = ln(x, w["ln_f.w_0"], w["ln_f.w_1"])
    logits = x.reshape(B * T_, H).float() @ w["lm_head.w"].to(dt).float()
    loss = torch.nn.functional.cross_entropy(logits, nxt.reshape(-1))
    names = sorted(w)
    grads = torch.autograd.grad(loss, [w[n_] for n_ in names])
    return loss.detach(), dict(zip(names, grads))


def medium_checked_step(exe, main, cost, params_grads, tok, nxt, scope,
                        bf16, what, smi):
    """One step with every gradient and the drawn tokens fetched, its
    loss and gradients held against the plain (amp) recompute of the
    weights before the step: loss within 1e-5 relative (amp) or 1e-4
    absolute (f32), gradients within 2e-2 (amp) or 1e-3 (f32) of their
    largest element. Returns (loss, loss error, worst gradient error,
    step ms, peak GiB)."""
    names = [p.name for p, _ in params_grads]
    snapshot = {n_: scope.get(n_).detach().clone().requires_grad_()
                for n_ in names}
    torch.cuda.reset_peak_memory_stats()
    t_step = time.perf_counter()
    out = exe.run(main, fetch_list=[cost, tok, nxt]
                  + [g for _, g in params_grads], scope=scope,
                  return_numpy=False)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t_step)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    loss = float(out[0][0])
    grads = dict(zip(names, out[3:]))
    if {str(g.dtype) for g in grads.values()} != {"torch.float32"} or \
            float_state_dtypes(scope) != {"torch.float32"}:
        raise AssertionError(f"{what}: a gradient, master weight or Adam "
                             "moment is not float32")
    ref_loss, ref_grads = stacked_reference_loss_and_grads(
        snapshot, out[1][..., 0], out[2], bf16)
    del snapshot, out
    loss_err = (abs(loss - float(ref_loss)) / abs(float(ref_loss)) if bf16
                else abs(loss - float(ref_loss)))
    worst = max((float((g - ref_grads[n_]).abs().max())
                 / max(float(ref_grads[n_].abs().max()), 1e-30), n_)
                for n_, g in grads.items())
    loss_tol, grad_tol = ((AMP_LOSS_RTOL, AMP_GRAD_RTOL) if bf16
                          else (LOSS_ATOL, GRAD_RTOL))
    log(f"{what} step 1: loss {loss:.6f} vs plain recompute "
        f"{float(ref_loss):.6f} ({loss_err:.2e} "
        f"{'relative' if bf16 else 'absolute'}, tol {loss_tol:g}); worst "
        f"gradient {worst[1]} at {worst[0]:.2e} of its largest element "
        f"(tol {grad_tol:g}) over {len(names)} parameters; step {step_ms:.0f}"
        f" ms with the fetches, peak {peak_gb:.2f} GiB | {smi}")
    if not np.isfinite(loss) or loss_err > loss_tol:
        raise AssertionError(f"{what}: step-1 loss differs from the plain "
                             "recompute")
    if not worst[0] <= grad_tol:
        raise AssertionError(f"{what}: gradient of {worst[1]} differs from "
                             f"the plain recompute by {worst[0]:.3e}")
    return loss, loss_err, worst[0], step_ms, peak_gb


def medium_launches(steps, remat, bf16):
    """The kernel launches of `steps` GPT-2-medium training steps at T
    1024 (route K3 + K4): K1 once a layer a step, twice with remat (the
    backward's recompute), K3 and K4 once a layer, K5 once."""
    sfx = "_bf16" if bf16 else ""
    return launches_of(**{
        f"flash_attn_fwd{sfx}": MED_LAYERS * steps * (2 if remat else 1),
        f"flash_attn_bwd_dq{sfx}": MED_LAYERS * steps,
        f"flash_attn_bwd_dkv{sfx}": MED_LAYERS * steps,
        f"lm_head_lse{sfx}": steps})


def medium_program(B, bf16, remat):
    """A fresh GPT-2-medium program at batch B, initialised by the
    port's startup (its generator, seeded 0), remat set."""
    torch.cuda.empty_cache()
    flags.set_flag("remat", remat)
    main, startup, cost, params_grads, tok, nxt = build_gpt2_medium(B)
    if bf16:
        amp.enable(main)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    return main, cost, params_grads, tok, nxt, exe, scope


def medium_amp_phase(smi):
    """Phase 16: amp GPT-2-medium training as bench.py's
    bench_gpt2_medium_mfu builds it (stacked, remat on, T 1024): step 1
    at B 4 against the plain amp recompute; B 32 (one warm-up step and
    three timed steps, a profiled step); then B 8 with remat on and off,
    one step each, for their peak memory. Launches per step checked.
    Returns (the path's launch counts, the trained B 32 weights as
    numpy, the results)."""
    res = {}
    main, cost, params_grads, tok, nxt, exe, scope = medium_program(
        MED_AMP_CHECK_B, True, True)
    n_params = sum(int(np.prod(p.shape)) for p, _ in params_grads)
    log(f"gpt2-medium: {MED_LAYERS} layers, H {MED_HID}, {MED_HEADS} heads, "
        f"vocab {VOCAB}, T {TRAIN_T}, {n_params} parameters, "
        f"{len(main.global_block().ops)} ops (one transformer_stack)")
    zero_counts()                       # the main path starts here
    loss, loss_rel, worst, _, _ = medium_checked_step(
        exe, main, cost, params_grads, tok, nxt, scope, True,
        f"gpt2-medium amp B {MED_AMP_CHECK_B}", smi)
    res["check"] = {"batch": MED_AMP_CHECK_B, "loss": loss,
                    "loss_rel": loss_rel, "grad_worst": worst}
    del main, scope, exe
    main, cost, _, _, _, exe, scope = medium_program(MED_B, True, True)
    torch.cuda.reset_peak_memory_stats()
    losses = [float(exe.run(main, fetch_list=[cost], scope=scope)[0][0])]
    torch.cuda.synchronize()
    wall = []
    for _ in range(3):
        t_step = time.perf_counter()
        losses.append(float(exe.run(main, fetch_list=[cost],
                                    scope=scope)[0][0]))
        wall.append(1e3 * (time.perf_counter() - t_step))
    counts = read_counts()              # the main path ends here
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    check_counts(counts, medium_launches(5, True, True),
                 "gpt2-medium amp (B 4 + 4 steps at B 32, remat)")
    if not np.isfinite(losses).all():
        raise AssertionError("gpt2-medium amp B 32: non-finite loss")
    step_ms = float(np.mean(wall))
    tokens = MED_B * TRAIN_T
    flops = 3 * (24 * MED_HID ** 2 * MED_LAYERS
                 + 4 * TRAIN_T * MED_HID * MED_LAYERS * 0.5
                 + 2 * MED_HID * VOCAB) * tokens
    log(f"gpt2-medium amp B {MED_B} T {TRAIN_T} (remat): losses "
        f"{[round(x, 5) for x in losses]}; step wall {step_ms:.1f} ms (mean "
        f"of 3 after a warm step, min {min(wall):.1f}), "
        f"{tokens / step_ms * 1e3:.0f} tokens/s, "
        f"{flops / step_ms / 1e9:.1f} TFLOP/s by bench.py's formula, peak "
        f"memory {peak_gb:.2f} GiB | {smi}")
    breakdown = amp_step_breakdown(f"gpt2-medium amp B {MED_B}", exe, main,
                                   {}, cost, scope, step_ms, smi)
    res["batch"] = {"batch": MED_B, "step_ms": step_ms,
                    "step_walls_ms": wall, "losses": losses,
                    "tokens_per_s": tokens / step_ms * 1e3,
                    "model_tflops": flops / step_ms / 1e9,
                    "peak_gib": peak_gb, "breakdown": breakdown}
    names = LMSpec(*MED_SPEC_ARGS).weight_specs()
    weights = {n_: scope.get(n_).detach().cpu().numpy() for n_ in names}
    del main, scope, exe
    res["memory_B8"] = {}
    for remat in (True, False):
        main, cost, _, _, _, exe, scope = medium_program(MED_MEM_B, True,
                                                         remat)
        exe.run(main, fetch_list=[cost], scope=scope)   # Adam's moments
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t_step = time.perf_counter()
        loss = float(exe.run(main, fetch_list=[cost], scope=scope)[0][0])
        ms = 1e3 * (time.perf_counter() - t_step)
        one = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        check_counts(one, medium_launches(1, remat, True),
                     f"gpt2-medium amp B {MED_MEM_B} remat {remat}")
        if not np.isfinite(loss):
            raise AssertionError(f"gpt2-medium amp B {MED_MEM_B} remat "
                                 f"{remat}: non-finite loss")
        log(f"gpt2-medium amp B {MED_MEM_B} remat {'on' if remat else 'off'}"
            f": peak memory {peak:.2f} GiB over a step, step wall "
            f"{ms:.1f} ms, K1-bf16 {one['flash_attn_fwd_bf16']} launches | "
            f"{smi}")
        res["memory_B8"]["remat_on" if remat else "remat_off"] = {
            "peak_gib": peak, "step_ms": ms}
        del main, scope, exe
    flags.set_flag("remat", False)
    torch.cuda.empty_cache()
    return counts, weights, res


def medium_f32_phase(smi):
    """Phase 17: f32 GPT-2-medium training (TF32 off), T 1024, B 4, remat
    on, two steps; step 1's loss and gradients against the plain f32
    recompute. Puts the f32 K1, K3, K4 and K5 at H 1024 on a main
    path."""
    main, cost, params_grads, tok, nxt, exe, scope = medium_program(
        MED_F32_B, False, True)
    zero_counts()                       # the main path starts here
    loss, loss_err, worst, step1_ms, peak_gb = medium_checked_step(
        exe, main, cost, params_grads, tok, nxt, scope, False,
        f"gpt2-medium f32 B {MED_F32_B}", smi)
    t_step = time.perf_counter()
    loss2 = float(exe.run(main, fetch_list=[cost], scope=scope)[0][0])
    step_ms = 1e3 * (time.perf_counter() - t_step)
    counts = read_counts()              # the main path ends here
    check_counts(counts, medium_launches(2, True, False),
                 f"gpt2-medium f32 B {MED_F32_B} (2 steps, remat)")
    if not np.isfinite(loss2):
        raise AssertionError("gpt2-medium f32: non-finite loss")
    log(f"gpt2-medium f32 B {MED_F32_B} (remat): losses {loss:.5f}, "
        f"{loss2:.5f}; step 2 wall {step_ms:.1f} ms, "
        f"{MED_F32_B * TRAIN_T / step_ms * 1e3:.0f} tokens/s, step-1 peak "
        f"{peak_gb:.2f} GiB | {smi}")
    flags.set_flag("remat", False)
    del main, scope, exe
    torch.cuda.empty_cache()
    return counts, {"batch": MED_F32_B, "losses": [loss, loss2],
                    "loss_err": loss_err, "grad_worst": worst,
                    "step_ms": step_ms, "peak_gib": peak_gb}


def medium_generation_phase(weights, smi):
    """Phase 18: the trained amp weights served by the LM engine (default
    paged cache and prefix cache, every rung a CUDA graph) and generated
    from by transformer_lm_generate in a program sharing a scope of the
    same weights. Greedy tokens of three prompts against a plain
    full-recompute forward on the card."""
    spec = LMSpec(*MED_SPEC_ARGS)
    t0 = time.perf_counter()
    engine = GenerationEngine(spec, weights, ready=False)
    rungs = engine.warmup()
    st = engine.stats()
    log(f"gpt2-medium engine: {spec.to_meta()}, {len(rungs)} rungs warmed "
        f"in {time.perf_counter() - t0:.1f} s, aot_status "
        f"{st['aot_status']}; {memory_line(engine_memory(), st['hbm'])}")
    if st["aot_status"] != "cuda_graph" or st["aot_rungs"] != rungs:
        raise AssertionError("gpt2-medium engine: not every rung captured "
                             "as a CUDA graph")
    rng = np.random.RandomState(SEED + 18)
    n_new = 16
    prompts = [rng.randint(0, VOCAB, size=n_).tolist()
               for n_ in (150, 23, 64)]
    zero_counts()                       # the main path starts here
    t_start = time.perf_counter()
    streams = [engine.submit(np.asarray(p), max_new_tokens=n_new)
               for p in prompts]
    served = [s_.result(600)[0].tolist() for s_ in streams]
    wall = time.perf_counter() - t_start
    engine_k1 = fa.flash_attn_fwd.launches
    engine.shutdown(drain=True, timeout=600)
    st = engine.stats()
    want = MED_LAYERS * (st["prefills"] + st["decode_steps"])
    if engine_k1 != want:
        raise AssertionError(f"gpt2-medium engine: K1 launched {engine_k1} "
                             f"times, expected {want}")
    del engine
    torch.cuda.empty_cache()

    # the same prompts through transformer_lm_generate (right-padded)
    pt.framework.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    Tp = max(len(p) for p in prompts)
    with pt.program_guard(main, startup):
        prompt = pt.layers.data("prompt", [Tp], dtype="int64")
        plen = pt.layers.data("plen", [1], dtype="int64")
        ids, lens = pt.models.transformer.transformer_lm_generate(
            prompt, plen, VOCAB, hid=MED_HID, num_layers=MED_LAYERS,
            num_heads=MED_HEADS, max_len=TRAIN_T, max_new=n_new,
            adopt_pos_emb=False)
    scope = scope_from_numpy(weights)
    batch = np.zeros((len(prompts), Tp), np.int64)
    for b, p in enumerate(prompts):
        batch[b, :len(p)] = p
    before = fa.flash_attn_fwd.launches
    got_ids, got_lens = pt.Executor().run(
        main, feed={"prompt": batch,
                    "plen": np.asarray([[len(p)] for p in prompts])},
        fetch_list=[ids, lens], scope=scope)
    program_k1 = fa.flash_attn_fwd.launches - before
    counts = read_counts()              # the main path ends here
    if program_k1 != MED_LAYERS * n_new:
        raise AssertionError(f"transformer_lm_generate: K1 launched "
                             f"{program_k1} times, expected layers x "
                             f"(1 prefill + {n_new - 1} steps)")
    check_counts(counts, launches_of(flash_attn_fwd=engine_k1 + program_k1),
                 "gpt2-medium generation")
    w = lm_weights_from_numpy(weights, spec)
    for b, p in enumerate(prompts):
        ref = reference_greedy(w, spec, p, n_new)
        if served[b] != ref or got_ids[b].tolist() != ref \
                or int(got_lens[b]) != n_new:
            raise AssertionError(
                f"gpt2-medium prompt {b}: tokens differ from the plain "
                f"full recompute\nengine    {served[b]}\nprogram   "
                f"{got_ids[b].tolist()}\nreference {ref}")
    tokens = len(prompts) * n_new
    log(f"gpt2-medium generation: engine and transformer_lm_generate "
        f"tokens == the plain full recompute for {len(prompts)} prompts "
        f"({n_new} new each); engine {tokens / wall:.1f} tokens/s over "
        f"{wall:.2f} s (3 streams), K1 launches engine {engine_k1}, "
        f"program {program_k1} | {smi}")
    del scope, w
    torch.cuda.empty_cache()
    return counts, {"prompts": len(prompts), "new_tokens": n_new,
                    "engine_tokens_per_s": tokens / wall,
                    "engine_k1": engine_k1, "program_k1": program_k1}


def build_gpt2_medium_lm():
    """GPT-2-medium's stacked inference program: logits and argmax."""
    pt.framework.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        tok = pt.layers.data("tokens", [TRAIN_T], dtype="int64")
        logits = pt.models.transformer.transformer_lm(
            tok, VOCAB, hid=MED_HID, num_layers=MED_LAYERS,
            num_heads=MED_HEADS, max_len=TRAIN_T, stacked=True)
        ids = pt.layers.argmax(logits, axis=-1)
    return main, logits, ids


def int8_stack_reference_logits(scope, tokens):
    """The int8 stacked model as plain PyTorch on the card: each layer's
    planes dequantized (wq * scale), plain softmax attention over the
    full [T, T] scores, plain layer norm and gelu, the head by the plain
    quantize, int8_matmul_plain and rescale; no kernel of the port."""
    w = {n_: scope.get(n_) for n_ in scope.keys() if not n_.startswith("__")}
    B, T_ = tokens.shape
    n, H = MED_HEADS, MED_HID
    D = H // n
    causal = torch.ones(T_, T_, dtype=torch.bool,
                        device=tokens.device).tril()

    def ln(x, g, b):
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + 1e-5) * g + b

    def leaf(name, l):
        p = w[f"stack.{name}"][l]
        scale = w.get(f"stack.{name}@QSCALE")
        return p.float() * scale[l] if scale is not None else p

    x = (w["tok_emb"][tokens].float() * w["tok_emb@QSCALE"][tokens]
         + w["pos_emb"][:T_])
    for l in range(MED_LAYERS):
        g = {name: leaf(name, l) for name in MED_LEAVES}
        h = ln(x, g["Ln1G"], g["Ln1B"])
        qkv = (h @ g["Wqkv"] + g["Bqkv"]).view(B, T_, n, 3, D)
        q, k, v = (qkv[:, :, :, m].transpose(1, 2) for m in range(3))
        s = (q @ k.transpose(-1, -2)) / float(np.sqrt(D))
        a = torch.softmax(s.masked_fill(~causal, float("-inf")), -1) @ v
        del q, k, v, s, qkv
        x = x + a.transpose(1, 2).reshape(B, T_, H) @ g["Wproj"] + g["Bproj"]
        h = ln(x, g["Ln2G"], g["Ln2B"])
        up = torch.nn.functional.gelu(h @ g["Wup"] + g["Bup"],
                                      approximate="tanh")
        x = x + up @ g["Wdown"] + g["Bdown"]
    h = ln(x, w["ln_f.w_0"], w["ln_f.w_1"]).reshape(B * T_, H)
    xq, ax = qo.quantize_activations_plain(h)
    out = int8_plain(xq, w["lm_head.w"], ax,
                     w["lm_head.w@QSCALE"].reshape(1, -1))
    return out.reshape(B, T_, -1)


def medium_int8_phase(weights, smi):
    """Phase 19: the stacked GPT-2-medium transformer_lm + argmax with the
    trained weights, quantized by the port (quant_transformer_stack over
    four int8 planes, quant_mul for the head, quant_lookup_table) and
    served one-shot by InferenceEngine.from_program at rungs 1-8, each a
    CUDA graph, behind the HTTP server. A dispatch: one K6 launch and one
    activation quantize (the head), 24 K1, no repack. Reply ids ==
    Executor.run; logits and ids against the plain recompute over the
    dequantized weights (phase 10's gates)."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    main, logits, ids = build_gpt2_medium_lm()
    scope = scope_from_numpy(weights)
    pruned = pt.io._prune_for_inference(main, ["tokens"], [ids.name])
    prog, qscope, report = quant.quantize_program(pruned, scope)
    del scope
    torch.cuda.empty_cache()
    types = [op.type for op in prog.global_block().ops]
    log(f"gpt2-medium int8: quantized {report['quantized_ops']} ops "
        f"({types.count('quant_transformer_stack')} quant_transformer_stack,"
        f" {types.count('quant_mul')} quant_mul), bytes "
        f"{report['bytes_before']} -> {report['bytes_after']} in "
        f"{time.perf_counter() - t0:.1f} s")
    if (types.count("quant_transformer_stack"), types.count("quant_mul"),
            types.count("quant_lookup_table")) != (1, 1, 1):
        raise AssertionError("expected the stack, the head and the "
                             "embedding quantized")
    exe = pt.Executor()
    engine = InferenceEngine.from_program(
        prog, ["tokens"], [ids.name], executor=exe, scope=qscope,
        config=EngineConfig(max_batch_size=SERVE_B, buckets=(1, 2, 4, 8),
                            batch_timeout_ms=20))
    rungs = engine.warmup()
    st = engine.stats()
    if st["aot_status"] != "cuda_graph" or st["aot_buckets"] != [1, 2, 4, 8]:
        raise AssertionError("gpt2-medium int8: expected a CUDA graph for "
                             "every bucket rung")
    server = make_server(engine, port=0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    rng = np.random.RandomState(SEED + 19)
    reqs = [rng.randint(0, VOCAB, (r, TRAIN_T)).astype(np.int64)
            for r in (1, 3, 2, 2)]
    replies, errors = {}, []

    def client(i):
        try:
            replies[i] = post_infer(port, reqs[i])
        except Exception as e:           # re-raised below
            errors.append((i, e))

    before = engine.stats()
    k6 = qo.int8_matmul_rescaled
    zero_counts()                       # the main path starts here
    k6.repacks = k6.k_pads = 0
    t_start = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(reqs))]
    for t_ in threads:
        t_.start()
    for t_ in threads:
        t_.join(600)
    wall = time.perf_counter() - t_start
    counts = read_counts()              # the main path ends here
    fixes = (k6.repacks, k6.k_pads)
    server.shutdown()
    engine.shutdown(drain=True, timeout=600)
    if errors:
        raise AssertionError(f"gpt2-medium int8 requests failed: {errors}")
    batches = engine.stats()["batches"] - before["batches"]
    check_counts(counts, launches_of(
        int8_matmul=batches, quantize_activations=batches,
        flash_attn_fwd=MED_LAYERS * batches),
        f"gpt2-medium int8 serving ({batches} dispatches)")
    if fixes != (0, 0):
        raise AssertionError("gpt2-medium int8: a weight repacked or K "
                             "padded")
    for i, x in enumerate(reqs):
        mine, = exe.run(prog, feed={"tokens": x}, fetch_list=[ids.name],
                        scope=qscope)
        if not np.array_equal(replies[i], mine):
            raise AssertionError(f"gpt2-medium int8 request {i}: reply ids "
                                 "differ from Executor.run")
    feed = {"tokens": np.random.RandomState(SEED + 20).randint(
        0, VOCAB, (4, TRAIN_T)).astype(np.int64)}
    got_ids, got_logits = exe.run(prog, feed=feed,
                                  fetch_list=[ids.name, logits.name],
                                  scope=qscope, return_numpy=False)
    with torch.inference_mode():
        ref = int8_stack_reference_logits(
            qscope, torch.from_numpy(feed["tokens"]).cuda())
    max_d = float((got_logits - ref).abs().max())
    rel = max_d / float(ref.abs().max())
    top2 = ref.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > 2 * max_d
    agree = bool((got_ids[sure] == ref.argmax(-1)[sure]).all())
    exact = float((got_ids == ref.argmax(-1)).float().mean())
    log(f"gpt2-medium int8 serving: {len(reqs)} requests "
        f"({sum(len(r) for r in reqs)} rows) in {batches} dispatches over "
        f"{wall:.2f} s, launches { {k: n_ for k, n_ in counts.items() if n_} }"
        f"; replies == Executor.run; logits vs the plain recompute over the "
        f"dequantized weights: max |diff| {max_d:.4e}, / max |logit| "
        f"{rel:.4e} (gate {INT8_E2E_RTOL:g}); ids equal at all "
        f"{int(sure.sum())} of {sure.numel()} positions whose top-2 margin "
        f"exceeds 2 x max |diff|: {agree} (equal at {exact:.4f} of all) | "
        f"{smi}")
    if not np.isfinite(rel) or rel > INT8_E2E_RTOL or not agree:
        raise AssertionError("gpt2-medium int8 disagrees with its plain "
                             "recompute")
    del ref, top2, sure, got_logits
    walls, _ = eager_and_graph_walls(
        lambda: exe.run(prog, feed={"tokens": feed["tokens"][:1].repeat(
            SERVE_B, 0)}, fetch_list=[ids.name], scope=qscope),
        lambda: engine._dispatch([feed["tokens"][:1].repeat(SERVE_B, 0)]),
        reps=3)
    graph_ms = float(np.mean(walls["graph"]))
    log(f"gpt2-medium int8: rung-8 dispatch wall eager "
        f"{float(np.mean(walls['eager'])):.2f} ms, CUDA graph "
        f"{graph_ms:.2f} ms, {SERVE_B * TRAIN_T / graph_ms * 1e3:.0f} "
        f"tokens/s through the graph; weights {scope_bytes(qscope)} B | "
        f"{smi}")
    del engine, qscope
    torch.cuda.empty_cache()
    return {k: n_ for k, n_ in counts.items() if n_}, {
        "dispatches": batches, "logit_rel_err": rel,
        "ids_equal_share": exact, "graph_dispatch_ms": graph_ms,
        "eager_dispatch_ms": float(np.mean(walls["eager"])),
        "weight_bytes_int8": report["bytes_after"],
        "weight_bytes_f32": report["bytes_before"]}


# -- phases 20-21: the trainer and the optimizer suite ------------------------

TRAINER_BATCHES, TRAINER_PASSES = 3, 2
TRAINER_LR_STEPS, TRAINER_LR_RATE, TRAINER_CLIP = 2, 0.7, 1.0
TRAINER_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "smoke_trainer_ckpt")
SKIP_POKE = "tok_emb_beta2_pow_0"   # a Beta2Pow of 2.0: sqrt(1 - b2^t) NaN


def build_trainer_gpt2():
    """Phase 7's GPT-2-small with the reference's training recipe: Adam
    over an exponentially decayed LR, global-norm gradient clipping."""
    pt.framework.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        tok = pt.layers.data("tok", [TRAIN_T, 1], dtype="int64")
        nxt = pt.layers.data("nxt", [TRAIN_T, 1], dtype="int64")
        cost = pt.models.transformer.transformer_lm_cost(
            tok, nxt, VOCAB, hid=HID, num_layers=LAYERS, num_heads=N_HEADS,
            max_len=TRAIN_T)
        pt.clip.set_gradient_clip(
            pt.clip.GradientClipByGlobalNorm(TRAINER_CLIP))
        try:
            lr = pt.learning_rate_decay.exponential_decay(
                LR, TRAINER_LR_STEPS, TRAINER_LR_RATE)
            pt.AdamOptimizer(lr).minimize(cost)
        finally:
            pt.clip.set_gradient_clip(None)
    return main, startup, cost


def trainer_reader():
    """A deterministic reader of numpy token examples, batched."""
    rng = np.random.RandomState(SEED + 7)
    n = TRAIN_B * TRAINER_BATCHES
    tok = rng.randint(0, VOCAB, (n, TRAIN_T, 1)).astype(np.int64)
    nxt = rng.randint(0, VOCAB, (n, TRAIN_T, 1)).astype(np.int64)
    return pt.reader.batch(lambda: zip(tok, nxt), TRAIN_B)


class TrainerRun:
    """One Trainer of the phase with an event handler that logs every
    step's loss, wall (BeginIteration to EndIteration) and the kernel
    launches the step made, and can request preemption or poke the
    scope."""

    def __init__(self, checkpoint_dir=None, **kw):
        main, startup, cost = build_trainer_gpt2()
        self.trainer = pt.Trainer(cost, main_program=main,
                                  startup_program=startup,
                                  checkpoint_dir=checkpoint_dir,
                                  feed_workers=1, **kw)
        self.losses, self.walls, self.counts = [], [], []
        self.preempt_after = None
        self.on_begin = self.on_skip = None

    def handler(self, ev):
        kind = type(ev).__name__
        if kind == "BeginIteration":
            torch.cuda.synchronize()
            self._t0, self._c0 = time.perf_counter(), read_counts()
            if self.on_begin is not None:
                self.on_begin(ev)
        elif kind == "EndIteration":
            self.walls.append(1e3 * (time.perf_counter() - self._t0))
            c1 = read_counts()
            self.counts.append({k: c1[k] - self._c0[k] for k in c1})
            self.losses.append(((ev.pass_id, ev.batch_id), float(ev.cost)))
            if (ev.pass_id, ev.batch_id) == self.preempt_after:
                self.trainer.request_preemption()
        elif kind == "IterationSkipped" and self.on_skip is not None:
            self.on_skip(ev)

    def train(self, passes=TRAINER_PASSES):
        self.trainer.train(trainer_reader(), passes, ["tok", "nxt"],
                           self.handler)
        return self

    def state(self):
        """Every persistable, as device clones."""
        block = self.trainer.main_program.global_block()
        return {n: self.trainer.scope.get(n).clone()
                for n, v in block.vars.items() if v.persistable}


def same_bits(a, b):
    """Names of the tensors that differ (or are missing) between two
    {name: tensor} dicts."""
    return sorted(n for n in set(a) | set(b)
                  if n not in a or n not in b or not torch.equal(a[n], b[n]))


def histogram_sum(name):
    h = monitor.snapshot()["histograms"].get(name)
    return (h["count"], h["sum"]) if h else (0, 0.0)


def device_time(fn):
    """(device ms, kernels) of one profiled call of fn."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [ev for ev in prof.events() if getattr(ev, "device_type", None)
               == torch.autograd.DeviceType.CUDA]
    return (sum(float(ev.time_range.elapsed_us()) for ev in kernels) / 1e3,
            len(kernels))


def bare_steps(run, reps=3):
    """The trainer's program and scope stepped by a bare Executor.run
    (batch 0, on the card): launches of one step, wall of each (numpy
    fetch, so synchronised), peak memory and one profiled step's device
    time and kernel count, with the guard off and on."""
    t = run.trainer
    feed = {k: torch.from_numpy(v).cuda()
            for k, v in t._feeder(["tok", "nxt"]).feed(
                next(iter(trainer_reader()()))).items()}
    out = {}
    for guard in (False, True):
        flags.set_flag("check_nan_inf", guard)
        walls = []
        for i in range(reps):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            c0 = read_counts()
            t0 = time.perf_counter()
            t.exe.run(t.main_program, feed=feed, fetch_list=[t.cost],
                      scope=t.scope)
            walls.append(1e3 * (time.perf_counter() - t0))
            c1 = read_counts()
        out[guard] = {"walls": walls,
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "counts": {k: c1[k] - c0[k] for k in c1}}
        out[guard]["device_ms"], out[guard]["kernels"] = device_time(
            lambda: t.exe.run(t.main_program, feed=feed, fetch_list=[t.cost],
                              scope=t.scope))
    flags.set_flag("check_nan_inf", False)
    return out


def trainer_phase(smi):
    """Phase 20: GPT-2-small f32 (TF32 off) trained by the port's Trainer
    at full width, T 1024, B 8, 2 passes of 3 batches through
    reader.batch and a one-worker DeviceFeeder; Adam over an
    exponentially decayed LR under a global-norm clip.

    A: uninterrupted (the main path: K1, K3, K4, K5). B: checkpointing,
    preempted after (pass 1, batch 0). C: a fresh Trainer resumes B at
    (1, 1) and finishes: its losses and final state == A's bitwise. D: a
    transient fault at step 2, retried: == A bitwise. E: skip_batch with
    the guard on; the update of (0, 1) turned non-finite (a Beta2Pow
    poked to 2.0): IterationSkipped, every persistable bitwise its
    pre-step value, training goes on. Each trainer step's launches ==
    a bare Executor.run step's; the trainer's step wall beside the bare
    step's; checkpoint bytes and seconds; peak memory guard off / on;
    the feed counters."""
    torch.cuda.empty_cache()
    monitor.set_enabled(True)
    monitor.reset()
    shutil.rmtree(TRAINER_DIR, ignore_errors=True)
    for suffix in (".old", ".tmp"):
        shutil.rmtree(TRAINER_DIR + suffix, ignore_errors=True)
    n_steps = TRAINER_PASSES * TRAINER_BATCHES

    zero_counts()                       # the main path starts here
    a = TrainerRun().train()
    counts = read_counts()              # the main path ends here
    route = fa.bwd_route(TRAIN_T)
    step_want = launches_of(
        flash_attn_fwd=LAYERS, lm_head_lse=1,
        flash_attn_bwd_fused=LAYERS if route == "fused" else 0,
        flash_attn_bwd_dq=LAYERS if route == "split" else 0,
        flash_attn_bwd_dkv=LAYERS if route == "split" else 0)
    check_counts(counts, {k: v * n_steps for k, v in step_want.items()},
                 f"trainer run A ({n_steps} steps, route {route})")
    losses = [l for _, l in a.losses]
    # each batch's loss falls from pass 0 to pass 1
    if not np.isfinite(losses).all() or not all(
            l1 < l0 for l0, l1 in zip(losses[:TRAINER_BATCHES],
                                      losses[TRAINER_BATCHES:])):
        raise AssertionError(f"trainer run A: losses {losses}")
    a_state, a_losses, a_walls = a.state(), a.losses, a.walls
    feed_stats = pt.reader.feed_stats()
    log(f"trainer A: losses {[round(x, 5) for x in losses]}, "
        f"global step {a.trainer.global_step}, launches {counts} | {smi}")

    bare = bare_steps(a)
    for guard, b in bare.items():
        check_counts(b["counts"], step_want,
                     f"bare Executor.run step (guard {guard})")
    for i, c in enumerate(a.counts):
        check_counts(c, step_want, f"trainer step {i}")
    trainer_ms = float(np.mean(a_walls[1:]))
    bare_ms = float(np.mean(bare[False]["walls"]))
    guard_ms = float(np.mean(bare[True]["walls"]))
    log(f"trainer step wall {trainer_ms:.1f} ms (mean of steps 2-{n_steps}; "
        f"all {[round(w, 1) for w in a_walls]}) against a bare "
        f"Executor.run step {bare_ms:.1f} ms "
        f"({[round(w, 1) for w in bare[False]['walls']]}), guard on "
        f"{guard_ms:.1f} ms ({[round(w, 1) for w in bare[True]['walls']]});"
        f" profiled step device {bare[False]['device_ms']:.1f} ms in "
        f"{bare[False]['kernels']} kernels, guard on "
        f"{bare[True]['device_ms']:.1f} ms in {bare[True]['kernels']}; peak "
        f"memory guard off {bare[False]['peak_gib']:.2f} GiB, on "
        f"{bare[True]['peak_gib']:.2f} GiB; the same launches a step "
        f"{step_want} | {smi}")
    log(f"trainer feed (one worker, prefetch 2): {feed_stats} | {smi}")
    del a
    torch.cuda.empty_cache()

    # B: preempted after (1, 0); C: resumes in a fresh Trainer
    b = TrainerRun(TRAINER_DIR)
    b.preempt_after = (1, 0)
    try:
        b.train()
        raise AssertionError("trainer run B was not preempted")
    except pt.resilience.PreemptionShutdown as e:
        log(f"trainer B: {e} | {smi}")
    meta = pt.io.read_checkpoint_meta(TRAINER_DIR)
    ckpt_bytes = sum(os.path.getsize(os.path.join(TRAINER_DIR, f))
                     for f in os.listdir(TRAINER_DIR))
    b_losses = b.losses
    del b
    torch.cuda.empty_cache()
    c = TrainerRun(TRAINER_DIR)
    pos = (c.trainer.global_step, c.trainer._start_pass,
           c.trainer._start_batch)
    if pos != (4, 1, 1) or meta["extra"] != {"pass_id": 1, "batch_id": 1}:
        raise AssertionError(f"trainer resume position {pos}, meta {meta}")
    c.train()
    resumed = b_losses + c.losses
    diff = same_bits(c.state(), a_state)
    if resumed != a_losses:
        raise AssertionError(f"trainer resume: losses {resumed} != run A's "
                             f"{a_losses}")
    if diff:
        raise AssertionError(f"trainer resume: {len(diff)} persistables "
                             f"differ from run A's, e.g. {diff[:5]}")
    saves, save_s = histogram_sum("io.checkpoint_save_s")
    loads, load_s = histogram_sum("io.checkpoint_load_s")
    log(f"trainer resume (B preempted after (1, 0), C from disk at (1, 1)) "
        f"== A bitwise: {n_steps} losses and {len(a_state)} persistables; "
        f"checkpoint {ckpt_bytes} bytes; {saves} saves {save_s:.2f} s "
        f"({save_s / max(saves, 1):.2f} s each), {loads} load "
        f"{load_s:.2f} s (io.checkpoint_save_s / io.checkpoint_load_s) "
        f"| {smi}")
    del c
    torch.cuda.empty_cache()
    shutil.rmtree(TRAINER_DIR, ignore_errors=True)

    # D: a transient fault at step 2, retried
    flags.set_flag("faults", "step:2:RuntimeError")
    pt.resilience.faults.reset()
    try:
        d = TrainerRun(retry_policy=pt.resilience.RetryPolicy(
            max_attempts=3, backoff_base_s=0.001)).train()
    finally:
        flags.set_flag("faults", "")
        pt.resilience.faults.reset()
    retries = monitor.snapshot()["counters"].get("resilience.step_retries")
    d_diff = same_bits(d.state(), a_state)
    if d.losses != a_losses or d_diff or retries != 1:
        raise AssertionError(f"trainer transient retry: retries {retries}, "
                             f"losses {d.losses}, differing {d_diff[:5]}")
    log(f"trainer D: a transient fault at step 2 retried once "
        f"(resilience.step_retries {retries}); trajectory == A bitwise | "
        f"{smi}")
    del d, a_state
    torch.cuda.empty_cache()

    # E: skip_batch, the guard on; the update of (0, 1) turns non-finite
    e = TrainerRun(anomaly_policy=pt.resilience.AnomalyPolicy("skip_batch"))
    seen = {}
    scope = e.trainer.scope
    kept = float(scope.get(SKIP_POKE)[0])

    def poke(ev):
        if (ev.pass_id, ev.batch_id) == (0, 1):
            scope.get(SKIP_POKE).fill_(2.0)
            seen["before"] = e.state()
            seen["objects"] = {n: (v, v._version)
                               for n, v in scope.vars.items()
                               if isinstance(v, torch.Tensor)}

    def skipped(ev):
        seen["skipped"] = (ev.pass_id, ev.batch_id)
        seen["diff"] = same_bits(e.state(), seen["before"])
        seen["moved"] = sorted(n for n, (v, ver) in seen["objects"].items()
                               if scope.get(n) is not v or v._version != ver)
        scope.get(SKIP_POKE).fill_(kept)

    e.on_begin, e.on_skip = poke, skipped
    e.train(passes=1)
    trips = monitor.snapshot()["counters"].get("executor.nan_guard_trips")
    e_losses = [l for _, l in e.losses]
    if (seen.get("skipped") != (0, 1) or seen["diff"] or seen["moved"]
            or trips != 1 or len(e_losses) != TRAINER_BATCHES - 1
            or not np.isfinite(e_losses).all()):
        raise AssertionError(f"trainer skip: {seen.get('skipped')}, trips "
                             f"{trips}, differing {seen.get('diff')}, "
                             f"written {seen.get('moved')}, losses "
                             f"{e_losses}")
    log(f"trainer E (skip_batch, guard on): the update of (0, 1) turned "
        f"non-finite, the guard tripped, IterationSkipped; "
        f"{len(seen['before'])} persistables bitwise their pre-step "
        f"values, none written in place; then losses {e_losses}; "
        f"guard-on step walls {[round(w, 1) for w in e.walls]} ms | {smi}")
    del e, scope, seen
    monitor.set_enabled(False)
    torch.cuda.empty_cache()
    return counts, {
        "losses": losses, "trainer_step_ms": trainer_ms,
        "trainer_step_walls": a_walls, "bare_step_ms": bare_ms,
        "bare_step_guard_ms": guard_ms,
        "bare_step_walls": bare[False]["walls"],
        "bare_step_guard_walls": bare[True]["walls"],
        "device_ms_guard_off": bare[False]["device_ms"],
        "device_ms_guard_on": bare[True]["device_ms"],
        "kernels_guard_off": bare[False]["kernels"],
        "kernels_guard_on": bare[True]["kernels"],
        "peak_gib_guard_off": bare[False]["peak_gib"],
        "peak_gib_guard_on": bare[True]["peak_gib"],
        "checkpoint_bytes": ckpt_bytes, "checkpoint_saves": saves,
        "checkpoint_save_s": save_s, "checkpoint_loads": loads,
        "checkpoint_load_s": load_s, "feed": feed_stats}


SUITE_SHAPE = (768, 3072)        # a GPT-2-small ffn_up weight
# card vs CPU on the same inputs, of each output's largest element: the
# same float32 operations in the same order, but nvcc may contract a
# multiply and an add into one FMA (one rounding instead of two) and
# powf may differ by an ulp, so not bitwise
SUITE_RTOL = 1e-6


def suite_cases():
    rng = np.random.RandomState(SEED + 8)

    def u(lo, hi):
        return rng.uniform(lo, hi, SUITE_SHAPE).astype(np.float32)

    p, g = u(-1, 1), u(-1, 1)
    base = {"Param": p, "Grad": g,
            "LearningRate": np.asarray([0.1], np.float32)}
    i64 = lambda v: np.asarray([v], np.int64)  # noqa: E731
    sums = {"Sum1": u(-1, 1), "Sum2": u(-1, 1), "Sum3": u(-1, 1)}
    return {
        "sgd": ("sgd", base, {}),
        "adam": ("adam", {**base, "Moment1": u(-0.1, 0.1),
                          "Moment2": u(0, 0.1),
                          "Beta1Pow": np.asarray([0.729], np.float32),
                          "Beta2Pow": np.asarray([0.997], np.float32)}, {}),
        "momentum": ("momentum", {**base, "Velocity": u(-1, 1)},
                     {"mu": 0.9}),
        "momentum_nesterov": ("momentum", {**base, "Velocity": u(-1, 1)},
                              {"mu": 0.9, "use_nesterov": True}),
        "adagrad": ("adagrad", {**base, "Moment": u(0, 0.5)}, {}),
        "decayed_adagrad": ("decayed_adagrad", {**base, "Moment": u(0, 0.5)},
                            {}),
        "adadelta": ("adadelta", {"Param": p, "Grad": g,
                                  "AvgSquaredGrad": u(0, 0.5),
                                  "AvgSquaredUpdate": u(0, 0.5)}, {}),
        "adamax": ("adamax", {**base, "Moment": u(-0.1, 0.1),
                              "InfNorm": u(0, 0.5),
                              "Beta1Pow": np.asarray([0.81], np.float32)},
                   {}),
        "rmsprop": ("rmsprop", {**base, "MeanSquare": u(0, 0.5),
                                "Moment": u(-0.1, 0.1)}, {"momentum": 0.5}),
        "ftrl": ("ftrl", {**base, "SquaredAccumulator": u(0.1, 0.5),
                          "LinearAccumulator": u(-0.1, 0.1)},
                 {"l1": 0.1, "l2": 0.1}),
        "ftrl_power": ("ftrl", {**base, "SquaredAccumulator": u(0.1, 0.5),
                                "LinearAccumulator": u(-0.1, 0.1)},
                       {"l1": 0.1, "l2": 0.1, "lr_power": -0.3}),
        "proximal_gd": ("proximal_gd", base, {"l1": 0.05, "l2": 0.05}),
        "proximal_adagrad": ("proximal_adagrad",
                             {**base, "Moment": u(0, 0.5)},
                             {"l1": 0.05, "l2": 0.05}),
        "gen_pruning_mask": ("gen_pruning_mask", {"Param": p},
                             {"sparsity_ratio": 0.6}),
        "average_accumulates": (
            "average_accumulates",
            {"Param": p, **sums, "NumAccumulates": i64(3),
             "OldNumAccumulates": i64(2), "NumUpdates": i64(9)},
            {"average_window": 0.5, "min_average_window": 2,
             "max_average_window": 4}),
        "average_apply": ("average_apply",
                          {"Param": p, **sums, "NumAccumulates": i64(3),
                           "OldNumAccumulates": i64(4)}, {}),
    }


def run_update_op(op_type, ins, attrs, device, in_place):
    ctx = types.SimpleNamespace(in_place=in_place, op=None,
                                device=torch.device(device))
    tins = {k: [torch.from_numpy(v.copy()).to(device)]
            for k, v in ins.items()}
    out = op_registry.get_op(op_type).lowering(ctx, tins, dict(attrs))
    return {k: v[0].detach().cpu() for k, v in out.items()}


def optimizer_suite_phase(smi):
    """Phase 21: every update op once at a GPT-2 parameter's shape
    [768, 3072] on the card, held to the same op on the CPU (SUITE_RTOL
    of each output's largest element); on the card, the guard's
    new-tensor mode == the in-place mode bitwise."""
    worst = {}
    for name, (op_type, ins, attrs) in suite_cases().items():
        cpu = run_update_op(op_type, ins, attrs, "cpu", True)
        card = run_update_op(op_type, ins, attrs, "cuda", True)
        fresh = run_update_op(op_type, ins, attrs, "cuda", False)
        err = 0.0
        for slot, ref in cpu.items():
            if not torch.equal(card[slot], fresh[slot]):
                raise AssertionError(f"{name}: {slot} differs between the "
                                     "in-place and new-tensor modes")
            scale = max(float(ref.abs().max()), 1e-30)
            err = max(err, float((card[slot].double() - ref.double())
                                 .abs().max()) / scale)
        worst[name] = err
        if not err <= SUITE_RTOL:
            raise AssertionError(f"{name} on the card differs from the CPU "
                                 f"by {err:.3e} of its largest element "
                                 f"(tolerance {SUITE_RTOL:g})")
    log(f"optimizer suite at {list(SUITE_SHAPE)}: card vs CPU, worst "
        f"relative difference per op "
        f"{ {k: float(f'{v:.3g}') for k, v in worst.items()} } "
        f"(tolerance {SUITE_RTOL:g}) | {smi}")
    return worst


# -- phases 22-25: ResNet-50, the image model --------------------------------

# bench.py's ResNet-50 programs at full width (224 x 224, 1000 classes,
# MomentumOptimizer(0.1, 0.9), bf16 amp). bench.py trains B 1024 on the
# TPU; RESNET_B is the largest of 1024, 512, 256 and 128 that fits on
# one H100 (tools/resnet_probe.py: B 512 runs out of memory).
RESNET_HW, RESNET_CLASSES = 224, 1000
RESNET_B = 256
RESNET_WARM, RESNET_TIMED = 3, 10
RESNET_CHECK_B = 4                # R2: the card against the port on the CPU
RESNET_TOL = 1e-4
RESNET_BUCKETS = (1, 2, 4, 8, 16)
RESNET_AGREE_IMAGES = 256
RESNET_INT8_DISPATCHES = 10       # R4: rung-16 dispatches timed and counted
# R4's int8 fc at rung 16: M, K (ResNet-50's 2048 features), N
RESNET_FC = (RESNET_BUCKETS[-1], 2048, RESNET_CLASSES)


def resnet_train_program(B, source, use_amp):
    """bench.py's training program: `source` "random" draws the images
    and labels inside the program (bench_resnet50), "uint8" feeds uint8
    images cast and scaled in the program (bench_resnet50_hostfed),
    "data" feeds float32 images."""
    pt.framework.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        shape = [3, RESNET_HW, RESNET_HW]
        if source == "random":
            img = pt.layers.uniform_random([B] + shape, min=0.0, max=1.0)
            lf = pt.layers.uniform_random([B, 1], min=0.0,
                                          max=RESNET_CLASSES - 0.01)
            label = pt.layers.cast(pt.layers.floor(lf), "int64")
        elif source == "uint8":
            raw = pt.layers.data("img_u8", shape, dtype="uint8")
            img = pt.layers.scale(pt.layers.cast(raw, "float32"),
                                  scale=1.0 / 255.0)
            label = pt.layers.data("label", [1], dtype="int64")
        else:
            img = pt.layers.data("img", shape)
            label = pt.layers.data("label", [1], dtype="int64")
        probs = pt.models.resnet.resnet50(img, class_dim=RESNET_CLASSES)
        cost = pt.layers.mean(pt.layers.cross_entropy(probs, label))
        pt.MomentumOptimizer(learning_rate=0.1, momentum=0.9).minimize(cost)
    if use_amp:
        amp.enable(main)
    return main, startup, cost


def resnet_feed(B, seed):
    rng = np.random.RandomState(seed)
    return {"img": rng.rand(B, 3, RESNET_HW, RESNET_HW).astype(np.float32),
            "label": rng.randint(0, RESNET_CLASSES, (B, 1)).astype(np.int64)}


def tensors_of(scope):
    return {k: v.clone() for k, v in scope.vars.items()
            if isinstance(v, torch.Tensor)}


def scope_of(tensors, device):
    scope = pt.Scope()
    for k, v in tensors.items():
        scope.set(k, (v.cuda() if device == "cuda" else v.cpu()).clone())
    return scope


def median_lo_hi(values):
    return float(np.median(values)), float(min(values)), float(max(values))


CONV_CLASSES = (("conv_wgrad", ("wgrad",)), ("conv_dgrad", ("dgrad",)),
                ("conv_fprop", ("fprop", "fwd", "convolve", "conv2d",
                                "implicit_gemm", "implicit_sgemm")),
                ("conv_layout", ("nchwtonhwc", "nhwctonchw")))


def resnet_step_breakdown(what, exe, main, feed, cost, scope, step_ms, smi):
    """One more step under torch.profiler: its device time split into
    cuDNN's convolutions (forward, data gradient, weight gradient, layout
    transforms and other cuDNN kernels, by kernel name), GEMM kernels
    (cuDNN runs 1 x 1 convolutions as GEMMs; the fc's cuBLAS product is
    ~0.01 ms of them), casts, Momentum (the momentum ops' kernels,
    marked by record_function around the op's lowering) and the rest
    (batch norm, relu, pooling and the other elementwise kernels); busy
    share = device time / the unprofiled step wall; the 12 largest
    kernels by name."""
    from torch.profiler import ProfilerActivity, profile, record_function
    momentum = op_registry._REGISTRY["momentum"]

    def marked(ctx, ins, attrs):
        with record_function("resnet/momentum"):
            return momentum.lowering(ctx, ins, attrs)
    op_registry._REGISTRY["momentum"] = momentum._replace(lowering=marked)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
            torch.cuda.synchronize()
    finally:
        op_registry._REGISTRY["momentum"] = momentum
    parts = dict.fromkeys([c for c, _ in CONV_CLASSES] + [
        "cudnn_other", "gemm", "casts", "other"], 0.0)
    top, momentum_us, device_us = {}, 0.0, 0.0
    for ev in prof.events():
        cuda = getattr(ev, "device_type", None) == \
            torch.autograd.DeviceType.CUDA
        if ev.name == "resnet/momentum":
            if not cuda:
                momentum_us += float(getattr(ev, "device_time_total", 0.0)
                                     or 0.0)
            continue
        if not cuda:
            continue
        us = float(ev.time_range.elapsed_us())
        device_us += us
        top[ev.name[:120]] = top.get(ev.name[:120], 0.0) + us
        low = ev.name.lower()
        cls = next((c for c, frags in CONV_CLASSES
                    if any(f in low for f in frags)), None)
        if cls is None and "cudnn" in low:
            cls = "cudnn_other"
        if cls is None and any(f in low for f in GEMM_NAMES):
            cls = "gemm"
        if cls is None and any(f in ev.name for f in CAST_NAMES):
            cls = "casts"
        parts[cls or "other"] += us
    if device_us <= 0:
        log(f"{what} breakdown: the profiler recorded no device time; "
            "device time not measured")
        return None
    ms = {k: v / 1e3 for k, v in parts.items()}
    ms["momentum"] = momentum_us / 1e3
    ms["bn_and_elementwise"] = ms.pop("other") - ms["momentum"]
    device_ms = device_us / 1e3
    top = sorted(top.items(), key=lambda kv: -kv[1])[:12]
    log(f"{what} breakdown (profiled step): device {device_ms:.1f} ms of "
        f"kernels against a {step_ms:.1f} ms unprofiled step wall (busy "
        f"share {device_ms / step_ms:.3f}); ms "
        f"{ {k: round(v, 2) for k, v in ms.items()} } | {smi}")
    log(f"{what}: largest device kernels (ms) "
        f"{[(n, round(us / 1e3, 2)) for n, us in top]}")
    return {"device_ms": device_ms, "ms": ms,
            "share": {k: v / device_ms for k, v in ms.items()},
            "busy": device_ms / step_ms,
            "top_kernels_ms": [(n, us / 1e3) for n, us in top]}


def resnet_train_phase(smi):
    """Phase 22 (R1): bench.py's bench_resnet50 program exactly (in-graph
    uniform_random images and labels, Momentum(0.1, 0.9), amp) at 224 x
    224, 1000 classes, B RESNET_B: RESNET_WARM warm-up steps, then
    RESNET_TIMED timed steps (each ends in the loss's fetch, so the card
    has finished): images/s median, low and high, peak memory, and a
    profiled step's device time by class beside the step wall. Returns
    the trained scope's persistables (phase 25 serves them)."""
    torch.cuda.empty_cache()
    main, startup, cost = resnet_train_program(RESNET_B, "random", True)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    for _ in range(RESNET_WARM):
        exe.run(main, fetch_list=[cost], scope=scope)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, losses = [], []
    zero_counts()                       # the main path starts here
    for _ in range(RESNET_TIMED):
        t0 = time.perf_counter()
        losses.append(float(exe.run(main, fetch_list=[cost],
                                    scope=scope)[0][0]))
        walls.append(1e3 * (time.perf_counter() - t0))
    counts = read_counts()              # the main path ends here
    check_counts(counts, launches_of(), "R1")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if not np.isfinite(losses).all():
        raise AssertionError(f"ResNet-50 amp training: non-finite loss "
                             f"{losses}")
    ips = median_lo_hi([RESNET_B / w * 1e3 for w in walls])
    step_ms = float(np.median(walls))
    log(f"ResNet-50 amp training B {RESNET_B} at {RESNET_HW} x {RESNET_HW}: "
        f"{ips[0]:.1f} images/s median of {RESNET_TIMED} steps after "
        f"{RESNET_WARM} warm-up (low {ips[1]:.1f}, high {ips[2]:.1f}), "
        f"step wall {step_ms:.1f} ms, peak memory {peak_gib:.2f} GiB, "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f} | {smi}")
    breakdown = resnet_step_breakdown(
        f"ResNet-50 amp training B {RESNET_B}", exe, main, {}, cost, scope,
        step_ms, smi)
    weights = {n: scope.get(n) for n, v in main.global_block().vars.items()
               if v.persistable and scope.has(n)
               and "velocity" not in n}
    del scope, exe
    torch.cuda.empty_cache()
    return counts, weights, {"batch": RESNET_B, "images_per_s": ips[0],
                     "images_per_s_lo": ips[1], "images_per_s_hi": ips[2],
                     "step_ms": step_ms, "peak_gib": peak_gib,
                     "losses": losses, "breakdown": breakdown}


def resnet_stem_case(smi):
    """The stem conv (7 x 7 / 2, 3 -> 64, pad 3) at the training batch:
    the space-to-depth rewrite against the direct conv in f32 on the card
    (tests/test_conv_s2d.py's tolerances: rtol 1e-4, atol 1e-5 of the
    largest |output|; the filter gradient rtol 1e-3), then each timed
    forward + backward in bf16 between CUDA events."""
    from paddle_tpu_torch.ops import nn_ops
    rng = np.random.RandomState(SEED + 22)
    x = torch.from_numpy(rng.randn(RESNET_B, 3, RESNET_HW, RESNET_HW)
                         .astype(np.float32)).cuda()
    w = torch.from_numpy(rng.randn(64, 3, 7, 7).astype(np.float32)).cuda()
    attrs = {"strides": [2, 2], "paddings": [3, 3], "dilations": [1, 1],
             "groups": 1}
    conv = op_registry.get_op("conv2d").lowering

    def run(x, w, s2d):
        prev = flags.get("conv_s2d_stem")
        flags.set_flag("conv_s2d_stem", s2d)
        try:
            return conv(None, {"Input": [x], "Filter": [w]},
                        attrs)["Output"][0]
        finally:
            flags.set_flag("conv_s2d_stem", prev)
    assert nn_ops._s2d_eligible(x, w, (2, 2), (3, 3), (1, 1), 1)
    outs, grads = {}, {}
    for s2d in (False, True):
        wl = w.clone().requires_grad_(True)
        y = run(x, wl, s2d)
        g, = torch.autograd.grad(y.square().mean(), wl)
        outs[s2d], grads[s2d] = y.detach(), g
    scale = float(outs[False].abs().max())
    err = float((outs[True] - outs[False]).abs().max())
    gscale = float(grads[False].abs().max())
    gerr = float((grads[True] - grads[False]).abs().max())
    if not (torch.allclose(outs[True], outs[False], rtol=1e-4,
                           atol=1e-5 * max(scale, 1.0))
            and torch.allclose(grads[True], grads[False], rtol=1e-3,
                               atol=1e-5 * max(gscale, 1.0))):
        raise AssertionError(f"stem: s2d differs from the direct conv: "
                             f"output {err:.3e} of {scale:.3e}, filter "
                             f"gradient {gerr:.3e} of {gscale:.3e}")
    xb, wb = x.bfloat16(), w.bfloat16().requires_grad_(True)
    times = {}
    for s2d in (False, True, True, False):
        def step():
            y = run(xb, wb, s2d)
            torch.autograd.grad(y, wb, torch.ones_like(y))
        for _ in range(2):
            step()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(10):
            step()
        end.record()
        end.synchronize()
        times.setdefault("s2d" if s2d else "direct", []).append(
            start.elapsed_time(end) / 10)
    faster = min(times, key=lambda k: min(times[k]))
    log(f"stem 7x7/2 at B {RESNET_B}: s2d vs direct f32 output error "
        f"{err:.3e} (max |y| {scale:.3e}), filter gradient {gerr:.3e}; "
        f"bf16 forward + backward ms direct {times['direct']}, s2d "
        f"{times['s2d']} (turns direct, s2d, s2d, direct): {faster} is "
        f"faster; the default stays s2d (the reference's) | {smi}")
    return {"max_abs_err": err, "grad_max_abs_err": gerr,
            "bf16_fwd_bwd_ms": times, "faster": faster}


# R2's free-running tolerance for the parameters whose gradient passes
# through every residual block: a relu input within f32 rounding of 0
# takes the other side on the card, and its element's gradient (up to
# ~1e-2 of the tensor's largest) moves the stem's filter gradient by a
# few percent; each op on identical inputs is held to RESNET_TOL
RESNET_DEEP_TOL = 5e-2


def resnet_parity_phase(smi):
    """Phase 23 (R2): ResNet-50 f32 (TF32 off) at 224 x 224, 1000
    classes, B RESNET_CHECK_B, from one scope (the port's startup on the
    CPU): one forward and one Momentum step on the card and on the CPU.
    Run free: the loss, the fc weight and the running mean and variance
    of the first and the last batch norm within RESNET_TOL (relative;
    of each array's largest element), the updated stem filter and first
    batch-norm scale within RESNET_DEEP_TOL. Op by op: every op of the
    step (forward, grad, momentum) on the card on the CPU's values of
    its inputs within RESNET_TOL of each output's largest element. Then
    two identical two-step runs from one scope, f32 and amp, on the
    card: bitwise-equal losses, parameters and running stats. Then the
    stem rewrite (R2's last part)."""
    main, startup, cost = resnet_train_program(RESNET_CHECK_B, "data",
                                               False)
    cpu_scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=cpu_scope)
    init = tensors_of(cpu_scope)
    feed = resnet_feed(RESNET_CHECK_B, SEED + 23)
    block = main.global_block()
    names = [n for n, v in block.vars.items()
             if not v.persistable and n not in feed]
    losses, scopes = {}, {}
    for dev in ("cpu", "cuda"):
        scope = scope_of(init, dev)
        exe = pt.Executor(pt.CPUPlace() if dev == "cpu" else None)
        out = exe.run(main, feed=feed, fetch_list=[cost] + (
            names if dev == "cpu" else []), scope=scope, return_numpy=False)
        losses[dev] = float(out[0][0])
        if dev == "cpu":
            values = dict(zip(names, out[1:]))
        scopes[dev] = scope
    loss_err = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    tols = {"conv2d_0.w_0": RESNET_DEEP_TOL,
            "batch_norm_0.w_0": RESNET_DEEP_TOL, "fc_0.w_0": RESNET_TOL,
            "batch_norm_0.mean_0": RESNET_TOL,
            "batch_norm_0.var_0": RESNET_TOL,
            "batch_norm_52.mean_0": RESNET_TOL,
            "batch_norm_52.var_0": RESNET_TOL}
    errs = {}
    for n in tols:
        ref = scopes["cpu"].get(n)
        got = scopes["cuda"].get(n).cpu()
        if torch.equal(ref, init[n]):
            raise AssertionError(f"R2: {n} was not updated by the step")
        errs[n] = float((got - ref).abs().max()) / float(ref.abs().max())
    log(f"ResNet-50 f32 B {RESNET_CHECK_B} one Momentum step run free, card "
        f"vs the port on the CPU: loss {losses['cuda']:.6f} vs "
        f"{losses['cpu']:.6f} (relative {loss_err:.2e}); updated state, "
        f"error / largest element "
        f"{ {k: float(f'{v:.3g}') for k, v in errs.items()} } (tolerance "
        f"{RESNET_TOL:g}; stem filter and first scale {RESNET_DEEP_TOL:g}) "
        f"| {smi}")
    if not loss_err <= RESNET_TOL or any(e > tols[n]
                                         for n, e in errs.items()):
        raise AssertionError(f"R2: the card differs from the CPU: loss "
                             f"{loss_err:.3e}, state {errs}")
    for n, t in scopes["cpu"].vars.items():
        if isinstance(t, torch.Tensor) and block._find_var(n) is not None:
            values[n] = t
    values.update({k: torch.from_numpy(v) for k, v in feed.items()})
    op_errs = {n: float((got.double() - ref.double()).abs().max())
               / max(float(ref.double().abs().max()), 1e-30)
               for n, (got, ref) in lower_ops_on(main, exe.device, init,
                                                 values).items()}
    worst = max(op_errs, key=op_errs.get)
    log(f"ResNet-50 f32 B {RESNET_CHECK_B} op by op on the card, on the "
        f"CPU's inputs: {len(op_errs)} outputs of {len(block.ops)} ops, "
        f"worst {op_errs[worst]:.3e} of the largest element ({worst}; "
        f"tolerance {RESNET_TOL:g}) | {smi}")
    if op_errs[worst] > RESNET_TOL:
        bad = sorted((e, n) for n, e in op_errs.items()
                     if e > RESNET_TOL)[-5:]
        raise AssertionError(f"R2: ops on the card differ from the CPU: "
                             f"{bad}")
    del scopes, values
    same = {}
    for use_amp in (False, True):
        main2, _, cost2 = resnet_train_program(RESNET_CHECK_B, "data",
                                               use_amp)
        exe = pt.Executor()
        runs = []
        for _ in range(2):
            scope = scope_of(init, "cuda")
            ls = [exe.run(main2, feed=resnet_feed(RESNET_CHECK_B, s),
                          fetch_list=[cost2], scope=scope)[0]
                  for s in (SEED + 24, SEED + 25)]
            runs.append((ls, tensors_of(scope)))
        diff = same_bits(runs[0][1], runs[1][1])
        if diff or not all(np.array_equal(a, b) for a, b in
                           zip(runs[0][0], runs[1][0])):
            what = "amp" if use_amp else "f32"
            raise AssertionError(f"R2: two identical {what} runs differ: "
                                 f"losses {runs[0][0]} vs "
                                 f"{runs[1][0]}, tensors {diff[:5]}")
        same["amp" if use_amp else "f32"] = len(runs[0][1])
    log(f"ResNet-50 B {RESNET_CHECK_B}: two identical two-step runs on the "
        f"card are bitwise equal (losses, and every scope tensor: {same}) "
        f"| {smi}")
    stem = resnet_stem_case(smi)
    return {"loss_card": losses["cuda"], "loss_cpu": losses["cpu"],
            "loss_rel_err": loss_err, "state_rel_err": errs,
            "tolerance": RESNET_TOL, "deep_tolerance": RESNET_DEEP_TOL,
            "op_by_op_worst": op_errs[worst], "op_by_op_outputs":
            len(op_errs), "bitwise_runs": same, "stem": stem}


def resnet_hostfed_phase(smi, r1):
    """Phase 24 (R3): bench.py's bench_resnet50_hostfed program (uint8
    images on the wire, cast and scaled in the program, labels int64) at
    B RESNET_B through the DeviceFeeder with the port's defaults (one
    convert worker, prefetch 2) over a pool of three host batches:
    images/s over RESNET_TIMED steps after RESNET_WARM, against phase
    22's, and the feeder's counters."""
    from paddle_tpu_torch.reader import DeviceFeeder
    torch.cuda.empty_cache()
    main, startup, cost = resnet_train_program(RESNET_B, "uint8", True)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(SEED + 26)
    pool = [{"img_u8": rng.randint(0, 256, (RESNET_B, 3, RESNET_HW,
                                            RESNET_HW), dtype=np.uint8),
             "label": rng.randint(0, RESNET_CLASSES, (RESNET_B, 1))
             .astype(np.int64)} for _ in range(3)]

    def reader():
        i = 0
        while True:
            yield pool[i % len(pool)]
            i += 1

    feeder = DeviceFeeder(reader, main, exe)
    it = iter(feeder)
    first = next(it)
    if first["img_u8"].dtype != torch.uint8 or \
            first["img_u8"].device != exe.device:
        raise AssertionError(f"R3: the feed reached the program as "
                             f"{first['img_u8'].dtype} on "
                             f"{first['img_u8'].device}")
    exe.run(main, feed=first, fetch_list=[cost], scope=scope)
    for _ in range(RESNET_WARM - 1):
        exe.run(main, feed=next(it), fetch_list=[cost], scope=scope)
    walls, losses = [], []
    zero_counts()                       # the main path starts here
    for _ in range(RESNET_TIMED):
        t0 = time.perf_counter()
        losses.append(float(exe.run(main, feed=next(it), fetch_list=[cost],
                                    scope=scope)[0][0]))
        walls.append(1e3 * (time.perf_counter() - t0))
    counts = read_counts()              # the main path ends here
    check_counts(counts, launches_of(), "R3")
    it.close()
    stats = feeder.stats()
    if not np.isfinite(losses).all():
        raise AssertionError(f"R3: non-finite loss {losses}")
    ips = median_lo_hi([RESNET_B / w * 1e3 for w in walls])
    log(f"ResNet-50 host-fed amp training B {RESNET_B} (uint8 over the "
        f"DeviceFeeder, defaults): {ips[0]:.1f} images/s median (low "
        f"{ips[1]:.1f}, high {ips[2]:.1f}) against {r1['images_per_s']:.1f}"
        f" in-graph ({ips[0] / r1['images_per_s']:.3f}); feed {stats} | "
        f"{smi}")
    del scope, exe, feeder
    torch.cuda.empty_cache()
    return counts, {"images_per_s": ips[0], "images_per_s_lo": ips[1],
                    "images_per_s_hi": ips[2],
                    "vs_in_graph": ips[0] / r1["images_per_s"],
                    "feed": stats}


def resnet_infer_program():
    """bench.py's bench_resnet50_inference program: the image feed and
    ResNet-50; returns (main, its clone(for_test=True), probs)."""
    pt.framework.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        img = pt.layers.data("img", [3, RESNET_HW, RESNET_HW])
        probs = pt.models.resnet.resnet50(img, class_dim=RESNET_CLASSES)
    return main, main.clone(for_test=True), probs


def running_stats(scope):
    return {n: t.clone() for n, t in scope.vars.items()
            if ".mean_" in n or ".var_" in n}


def program_weight_bytes(program, scope):
    return sum(scope.get(n).numel() * scope.get(n).element_size()
               for n, v in program.global_block().vars.items()
               if v.persistable and scope.has(n))


def resnet_serving_phase(weights, smi):
    """Phase 25 (R4): the clone(for_test=True) inference program over
    phase 22's trained weights, f32 (TF32 off). In-process fed (bench.py's
    inprocess_fed_img_per_sec): a numpy batch fed every step, 20 steps a
    window with the probabilities fetched on the last, median of 3
    windows, at B 1 and 16. The one-shot engine (from_program, rungs 1,
    2, 4, 8, 16 captured as CUDA graphs by warmup): each rung's dispatch
    wall against its graph replay's device time, each rung's output
    against the eager Executor.run of the same batch, and the running
    stats unchanged after serving. int8: the pruned program quantized by
    the port (quant_conv2d x 53, quant_mul for the fc): the rung-16
    dispatch wall of a one-rung engine against f32's, the dequantize's
    share of a profiled int8 dispatch's device time, weight bytes, and
    top-1 agreement with f32 on RESNET_AGREE_IMAGES seeded images."""
    from torch.profiler import ProfilerActivity, profile, record_function
    main, test, probs = resnet_infer_program()
    scope = pt.Scope()
    for n, t in weights.items():
        if test.global_block()._find_var(n) is not None:
            scope.set(n, t)
    exe = pt.Executor()
    before = running_stats(scope)
    rng = np.random.RandomState(SEED + 27)
    fed = {}
    for bs in (1, 16):
        x = rng.rand(bs, 3, RESNET_HW, RESNET_HW).astype(np.float32)
        exe.run(test, feed={"img": x}, fetch_list=[probs], scope=scope)
        exe.run(test, feed={"img": x}, fetch_list=[], scope=scope)
        rates = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(19):
                exe.run(test, feed={"img": x}, fetch_list=[], scope=scope)
            exe.run(test, feed={"img": x}, fetch_list=[probs], scope=scope)
            rates.append(bs * 20 / (time.perf_counter() - t0))
        fed[bs] = float(np.median(rates))
    log(f"ResNet-50 f32 in-process fed inference: images/s "
        f"{ {k: round(v, 1) for k, v in fed.items()} } (B 1, 16) | {smi}")

    engine = InferenceEngine.from_program(
        main, ["img"], [probs], executor=exe, scope=scope,
        config=EngineConfig(buckets=RESNET_BUCKETS, batch_timeout_ms=0),
        start=False)
    if list(engine.warmup()) != list(RESNET_BUCKETS):
        raise AssertionError("R4: the engine's rungs are not "
                             f"{RESNET_BUCKETS}")
    rungs = {}
    for b in RESNET_BUCKETS:
        x = rng.rand(b, 3, RESNET_HW, RESNET_HW).astype(np.float32)
        for _ in range(2):
            out = engine._dispatch([x])[0]
        walls = []
        for _ in range(10):
            t0 = time.perf_counter()
            engine._dispatch([x])
            walls.append(1e3 * (time.perf_counter() - t0))
        key = (((b, 3, RESNET_HW, RESNET_HW), "<f4"),)
        device_ms = graph_replay_ms(engine._graphs, key)
        eager, = exe.run(test, feed={"img": x}, fetch_list=[probs],
                         scope=scope)
        err = float(np.abs(out - eager).max())
        rungs[b] = {"wall_ms": float(np.median(walls)),
                    "device_ms": device_ms, "bitwise": err == 0.0,
                    "max_abs_err": err}
        if err != 0.0:
            raise AssertionError(f"R4: rung {b}'s graph replay differs from "
                                 f"Executor.run by {err:.3e} (expected "
                                 f"the same bits)")
    changed = same_bits(before, running_stats(scope))
    if changed:
        raise AssertionError(f"R4: serving changed running stats "
                             f"{changed[:5]}")
    shown = {b: (round(r["wall_ms"], 2), round(r["device_ms"], 2))
             for b, r in rungs.items()}
    log(f"ResNet-50 one-shot engine (CUDA graph a rung): dispatch wall / "
        f"replay device ms {shown}; each replay bitwise == Executor.run; "
        f"the {len(before)} running stats unchanged | {smi}")

    pruned = pt.io._prune_for_inference(main, ["img"], [probs.name])
    qprog, qscope, _ = quant.quantize_program(pruned, scope)
    types = [op.type for op in qprog.global_block().ops]
    if types.count("quant_conv2d") != 53 or "conv2d" in types \
            or types.count("quant_mul") != 1:
        raise AssertionError(f"R4: the quantized program runs "
                             f"{types.count('quant_conv2d')} quant_conv2d")
    f32_bytes = program_weight_bytes(pruned, scope)
    int8_bytes = program_weight_bytes(qprog, qscope)
    # the rung-16 engines' dispatches are the main paths: the f32 one
    # launches no hand-written kernel; the int8 one's fc (quant_mul)
    # launches the quantize kernel and K6 once a dispatch, its weight
    # column-major (no repack) and K 2048 (no padding)
    walls, counts = {}, {}
    k6 = qo.int8_matmul_rescaled
    for name, prog, sc in (("f32", pruned, scope), ("int8", qprog, qscope)):
        eng = InferenceEngine.from_program(
            prog, ["img"], [probs], executor=exe, scope=sc,
            config=EngineConfig(buckets=(16,), batch_timeout_ms=0),
            start=False)
        eng.warmup()
        x = rng.rand(16, 3, RESNET_HW, RESNET_HW).astype(np.float32)
        ws = []
        zero_counts()                   # the main path starts here
        k6.repacks = k6.k_pads = 0
        for _ in range(RESNET_INT8_DISPATCHES):
            t0 = time.perf_counter()
            eng._dispatch([x])
            ws.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        counts[name] = read_counts()    # the main path ends here
        walls[name] = float(np.median(ws))
        del eng
        if name == "int8" and (k6.repacks or k6.k_pads):
            raise AssertionError(f"R4: the int8 fc's K6 made {k6.repacks} "
                                 f"repacks and {k6.k_pads} K paddings")
    n = RESNET_INT8_DISPATCHES
    check_counts(counts["f32"], launches_of(), "R4 f32 rung 16")
    check_counts(counts["int8"], launches_of(
        int8_matmul=n, quantize_activations=n), "R4 int8 rung 16")
    dequantize = qo.dequantize

    def marked(*a, **k):
        with record_function("int8/dequantize"):
            return dequantize(*a, **k)
    qo.dequantize = marked
    x = rng.rand(16, 3, RESNET_HW, RESNET_HW).astype(np.float32)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            exe.run(qprog, feed={"img": x}, fetch_list=[probs], scope=qscope)
            torch.cuda.synchronize()
    finally:
        qo.dequantize = dequantize
    deq_us = sum(float(getattr(ev, "device_time_total", 0.0) or 0.0)
                 for ev in prof.events() if ev.name == "int8/dequantize"
                 and getattr(ev, "device_type", None)
                 != torch.autograd.DeviceType.CUDA)
    dev_us = sum(float(ev.time_range.elapsed_us()) for ev in prof.events()
                 if getattr(ev, "device_type", None)
                 == torch.autograd.DeviceType.CUDA)
    agree = 0
    for i in range(RESNET_AGREE_IMAGES // 16):
        x = np.random.RandomState(SEED + 100 + i).rand(
            16, 3, RESNET_HW, RESNET_HW).astype(np.float32)
        p32, = exe.run(pruned, feed={"img": x}, fetch_list=[probs],
                       scope=scope)
        p8, = exe.run(qprog, feed={"img": x}, fetch_list=[probs],
                      scope=qscope)
        agree += int((p32.argmax(1) == p8.argmax(1)).sum())
    int8 = {"rung16_wall_ms": walls["int8"], "f32_rung16_wall_ms":
            walls["f32"], "dequantize_device_ms": deq_us / 1e3,
            "dispatch_device_ms": dev_us / 1e3,
            "dequantize_share": deq_us / dev_us if dev_us else None,
            "weight_bytes": int8_bytes, "f32_weight_bytes": f32_bytes,
            "top1_agreement": agree / RESNET_AGREE_IMAGES}
    log(f"ResNet-50 int8 (53 quant_conv2d + quant_mul): rung-16 dispatch "
        f"wall {walls['int8']:.2f} ms against f32 {walls['f32']:.2f} ms "
        f"({n} dispatches each; launches {counts['int8']['int8_matmul']} "
        f"K6 and {counts['int8']['quantize_activations']} quantize in the "
        f"int8 one's, none in the f32 one's); "
        f"the dequantize {deq_us / 1e3:.2f} ms of a profiled eager "
        f"dispatch's {dev_us / 1e3:.2f} ms of kernels; weights "
        f"{int8_bytes / 2**20:.1f} MiB against {f32_bytes / 2**20:.1f} MiB; "
        f"top-1 agreement with f32 {agree}/{RESNET_AGREE_IMAGES} | {smi}")
    return counts, {"inprocess_fed_images_per_s": fed, "rungs": rungs,
                    "running_stats_unchanged": True, "int8": int8}


def main():
    name, smi = device_phase()
    t0 = time.perf_counter()
    _build.build_libraries(_build.KERNEL_SOURCES)
    log(f"build: {', '.join(_build.KERNEL_SOURCES)} (nvcc, sm_90a, in "
        f"parallel) in {time.perf_counter() - t0:.1f} s")
    cases = kernel_phase()
    serving_k1, decode_step = engine_phase(smi)
    bwd, k1_train = backward_kernel_phase(smi)
    lse = lse_case(np.random.RandomState(SEED + 4), TRAIN_B * TRAIN_T, HID,
                   "train", smi)
    train_counts, train = training_phase(smi)
    short_counts, short_train = short_training_phase(smi)
    k6, k6_cases, quantize = int8_kernel_phase(smi)
    int8_counts, int8_serving = int8_serving_phase(smi)
    bf16 = bf16_kernel_phase(smi)
    amp_counts, amp_train = amp_training_phase(
        smi, train["losses"][0], TRAIN_T, TRAIN_B, SEED + 3, 5)
    amp_short_counts, amp_short = amp_training_phase(
        smi, short_train["losses"][0], SHORT_T, SHORT_B, SEED + 5, 3)
    amp_batch = amp_batch_phase(smi)
    medium = medium_kernel_phase(smi)
    med_amp_counts, med_weights, med_amp = medium_amp_phase(smi)
    med_f32_counts, med_f32 = medium_f32_phase(smi)
    med_gen_counts, med_gen = medium_generation_phase(med_weights, smi)
    med_int8_counts, med_int8 = medium_int8_phase(med_weights, smi)
    del med_weights
    trainer_counts, trainer = trainer_phase(smi)
    suite = optimizer_suite_phase(smi)
    resnet_train_counts, resnet_weights, resnet_train = \
        resnet_train_phase(smi)
    resnet_parity = resnet_parity_phase(smi)
    resnet_hostfed_counts, resnet_hostfed = resnet_hostfed_phase(
        smi, resnet_train)
    resnet_serving_counts, resnet_serving = resnet_serving_phase(
        resnet_weights, smi)
    del resnet_weights
    paths = {"serving": {"flash_attn_fwd": serving_k1},
             f"training_T{TRAIN_T}": train_counts,
             f"training_T{SHORT_T}": short_counts,
             "serving_int8": int8_counts,
             f"training_amp_T{TRAIN_T}": amp_counts,
             f"training_amp_T{SHORT_T}": amp_short_counts,
             "gpt2_medium_training_amp": med_amp_counts,
             "gpt2_medium_training_f32": med_f32_counts,
             "gpt2_medium_generation": med_gen_counts,
             "gpt2_medium_serving_int8": med_int8_counts,
             "trainer": trainer_counts,
             "resnet50_training_amp": resnet_train_counts,
             "resnet50_hostfed_amp": resnet_hostfed_counts,
             "resnet50_serving_f32": resnet_serving_counts["f32"],
             "resnet50_serving_int8": resnet_serving_counts["int8"]}
    launches = {k: sum(p.get(k, 0) for p in paths.values())
                for k in ALL_KERNELS}
    by_path = {k: {p: c.get(k, 0) for p, c in paths.items()}
               for k in ALL_KERNELS}
    for k, n in launches.items():
        if n == 0:
            raise AssertionError(f"{k} was launched no time on a main path")
    decode = next(c for c in cases if c["case"] == "decode_paged")
    kernels = [{
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attn_fwd.cu",
        "design": K1_DESIGN,
        "replaces": "paddle_tpu/ops/pallas_attention.py:212",
        "launches": launches["flash_attn_fwd"],
        "launches_by_path": by_path["flash_attn_fwd"],
        "max_abs_err": max([c["max_abs_err"] for c in cases]
                           + [k1_train["max_abs_err"]]),
        "ms": decode["ms"], "plain_ms": decode["plain_ms"],
        "bound_ms": decode["bound_ms"], "bound_by": decode["bound_by"],
        "library_ms": decode["library_ms"],
        "bound_3xtf32_ms": decode["bound_3xtf32_ms"],
        "cases": cases + [k1_train]}]
    for kname, (_, _, _, replaces) in BWD_KERNELS.items():
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attn_bwd.cu",
            "design": BWD_DESIGN[kname],
            "replaces": replaces, "launches": launches[kname],
            "launches_by_path": by_path[kname], **bwd[kname]})
    kernels.append({
        "name": "lm_head_lse", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/lm_head_lse.cu",
        "design": K5_DESIGN,
        "replaces": "paddle_tpu/ops/chunked_ce.py:90",
        "launches": launches["lm_head_lse"],
        "launches_by_path": by_path["lm_head_lse"], **lse})
    dispatch = (f"one rung-8 dispatch: {INT8_PER_DISPATCH} launches ({LAYERS} "
                f"x qkv, proj, ffn_up, ffn_down + lm head) at M "
                f"{SERVE_B * TRAIN_T}")
    kernels.append({
        "name": "int8_matmul", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/int8_matmul.cu",
        "design": K6_DESIGN,
        "replaces": "paddle_tpu/ops/quant_ops.py:123",
        "launches": launches["int8_matmul"],
        "launches_by_path": by_path["int8_matmul"],
        "max_abs_err": 0.0, "case": dispatch, **k6, "cases": k6_cases})
    kernels.append({
        "name": "quantize_activations", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/int8_matmul.cu",
        "design": QUANTIZE_DESIGN,
        "replaces": "paddle_tpu/ops/quant_ops.py:173-179 (the activation "
                    "quantize of int8_matmul: XLA ops, not a Pallas kernel)",
        "launches": launches["quantize_activations"],
        "launches_by_path": by_path["quantize_activations"],
        "case": dispatch, **quantize})
    for kname, r in bf16.items():
        kernels.append({
            "name": kname, "route": "cuda",
            "source": ("paddle_tpu_torch/csrc/lm_head_lse_bf16.cu"
                       if kname == "lm_head_lse_bf16" else
                       "paddle_tpu_torch/csrc/flash_attn_bf16.cu"),
            "design": BF16_DESIGN[kname], "launches": launches[kname],
            "launches_by_path": by_path[kname], **r})
    for entry in kernels:
        if entry["name"] in medium:
            entry["gpt2_medium"] = medium[entry["name"]]
    print(json.dumps({"kernels": kernels, "decode_step": decode_step,
                      "training": train,
                      "training_short": short_train,
                      "serving_int8": int8_serving,
                      "training_amp": amp_train,
                      "training_amp_short": amp_short,
                      "training_amp_batch": amp_batch,
                      "gpt2_medium": {"training_amp": med_amp,
                                      "training_f32": med_f32,
                                      "generation": med_gen,
                                      "serving_int8": med_int8},
                      "trainer": trainer, "optimizer_suite": suite,
                      "resnet50": {"training_amp": resnet_train,
                                   "parity": resnet_parity,
                                   "hostfed": resnet_hostfed,
                                   "serving": resnet_serving}}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
