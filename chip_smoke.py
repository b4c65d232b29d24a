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
     slots x 1 row over 384 keys), float32, ragged kv_len, inputs from
     a numpy seed. Tolerance 1e-4 absolute on O and LSE: the two sum in
     different orders (online softmax over 64-key tiles with 3xTF32
     tensor-core products for Tq > 1, over 32-key chunks for decode, vs
     one softmax over the row). Times: the kernel, the plain version and
     torch's scaled_dot_product_attention (a yardstick only; the port
     never calls it), each over input sets that together exceed the
     50 MB L2, beside the least time the card could take;
  4. engine: GPT-2-small at full width (vocab 50304, H 768, 12 layers,
     12 heads, max_len 1024; random weights from numpy seed 0) behind
     the port's HTTP server with the default paged KV cache and prefix
     cache. Seven /v1/generate requests: four concurrent streams, one
     buffered, one exact repeat (a full prefix hit) and one sharing a
     page-aligned prefix (a prefix hit that prefills from q_start > 0).
     Checks: token counts, prefix hits, page/slot allocs == frees after
     drain, K1 launches == layers x (prefills + decode steps), and the
     greedy tokens of three requests against a plain full-recompute
     forward of the same weights on the card;
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
     yardstick only). The activation quantize kernel bitwise against
     quantize_activations_plain on a dispatch's activations (K 768 and
     3072), rows of zeros, rows of exact halves and a static scale; its
     time beside its bytes bound and the plain version;
 10. int8 one-shot serving: GPT-2-small transformer_lm + argmax at full
     width (T 1024, f32, TF32 off, the port's startup, generator seed
     0) saved by save_inference_model, quantized by the port's
     quantize_inference_model (50 quantized ops), loaded and served by
     InferenceEngine.from_program (rungs 1, 2, 4, 8) behind the HTTP
     server — the code of `serve --model_dir`. The int8 matmul weights
     are column-major on the card, their bytes unchanged. Eight
     /v1/infer requests of 1-3 rows from four client threads must
     co-batch; launches a dispatch: the quantize kernel 49, K6 49 (no
     repack, no K padding), K1 12. Checks: reply ids == Executor.run on
     the same rows; every quant_mul output of a rung-8 run bitwise == the
     plain recompute (plain quantize, int8_matmul_plain, rescale) from
     its own input; logits within 5e-2 of max |logit| of a plain full
     recompute (plain attention, the plain int8 ops), ids equal where its
     top-2 margin exceeds twice the largest difference. Printed: the f32
     model on the same batch, both dispatch walls, tokens/s, peak memory,
     weight bytes, and a profiled dispatch's device time split into K6,
     the quantize kernel, K1, an eager rescale (none) and the rest;
 11. bf16 kernels: K1-, K3- and K4-bf16 held against their plain bf16
     versions (the reference's roundings: P and dS to bf16 before the
     products they feed, O and the gradients once at the end) at the
     training shape [8, 12, 1024, 64] (head views of the packed bf16
     planes), a ragged kv_len case and a Tq != Tk case; K2-bf16 (the
     fused backward: a cluster of two blocks a (batch, head) that sums dq
     in f32 on chip and writes it once in bf16) at its main path's [32,
     12, 256, 64], a ragged and a Tq > Tk case, two calls bitwise equal;
     K5-bf16 at x
     [8192, 768] @ w [768, 50304]. Tolerance 1e-2 of the largest |plain|
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
     and busy share.

The second-to-last line is the kernel table as JSON; the last line is
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
    from paddle_tpu_torch.ops import chunked_ce as ce
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import quant_ops as qo
    from paddle_tpu_torch.ops import registry as op_registry
    from paddle_tpu_torch.serving import (EngineConfig, GenerationConfig,
                                          GenerationEngine, InferenceEngine,
                                          LMSpec, init_lm_weights)
    from paddle_tpu_torch.serving.http import make_server
    from paddle_tpu_torch.weights import lm_weights_from_numpy
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
    return results


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
    t0 = time.perf_counter()
    rungs = engine.warmup()
    log(f"engine: warmed {len(rungs)} rungs in "
        f"{time.perf_counter() - t0:.1f} s")
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
    results = {}
    errors = []

    def run(key, body):
        try:
            results[key] = post(port, body)
        except Exception as e:           # re-raised below, in order
            errors.append((key, e))

    fa.flash_attn_fwd.launches = 0      # the main path starts here
    t_start = time.perf_counter()
    threads = [threading.Thread(target=run, args=(i, {
        "prompt": prompts[i], "max_new_tokens": n_new}))
        for i in range(4)]
    threads.append(threading.Thread(target=run, args=(4, {
        "prompt": prompts[4], "max_new_tokens": n_new, "stream": False})))
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    run("repeat", {"prompt": prompts[1], "max_new_tokens": n_new})
    run("shared", {"prompt": shared, "max_new_tokens": n_new})
    wall = time.perf_counter() - t_start
    launches = fa.flash_attn_fwd.launches
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
              "slot_frees": st["slot_frees"], "k1_launches": launches}
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

    ttfts = [results[i][1] for i in range(4)]
    tokens = sum(len(t) for t, _ in results.values())
    decode_ms = 1e3 * monitor.snapshot()["histograms"][
        "serving_lm.decode_step_s"]["mean"]
    log(f"engine: TTFT p50 {1e3 * float(np.median(ttfts)):.1f} ms over the 4 "
        f"concurrent streams, decode {decode_ms:.2f} ms/step (8 slots), "
        f"{tokens / wall:.1f} tokens/s over {wall:.2f} s | {smi}")
    decode_step_breakdown(engine, smi)
    return launches


def decode_step_breakdown(engine, smi, reps=20):
    """Where one paged decode step's time goes, 8 live slots at position
    300 over their own pages: the host-clock wall of the engine's own
    dispatch (inputs to the card, the step, tokens back), against the
    device time of the same step captured in a CUDA graph and replayed
    between CUDA events. device / wall is the card's busy share while
    the host dispatches eagerly."""
    cfg = engine.config
    S, m = cfg.max_slots, cfg.pages_per_seq
    host = (np.arange(S, dtype=np.int32), np.full(S, 300, np.int32),
            np.ones(S, bool),
            np.arange(1, S * m + 1, dtype=np.int32).reshape(S, m))
    for _ in range(3):
        engine._dispatch_decode(*host)
    t0 = time.perf_counter()
    for _ in range(reps):
        engine._dispatch_decode(*host)
    wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    args = engine._to_device(*host)
    with torch.inference_mode():
        device_ms = time_ms(lambda: engine._decode_fn(*args), [()], reps)
    log(f"decode step: wall {wall_ms:.3f} ms (eager dispatch, tokens read "
        f"back), device {device_ms:.3f} ms (CUDA-graph replay), busy "
        f"share {device_ms / wall_ms:.3f} | {smi}")


# -- phase 5: backward kernels vs plain --------------------------------------

def live_pairs(B, Tq, Tk, kv_len, causal):
    """Live (row, key) pairs of one head summed over the batch."""
    rows = np.arange(Tq)[None, :]
    lim = np.minimum(np.asarray(kv_len)[:, None], Tk)
    if causal:
        lim = np.minimum(lim, rows + 1)
    return int(np.maximum(lim, 0).sum())


def attn_bound(B, Tq, Tk, kv_len, causal, products, ins, outs):
    """The least time for `products` T x T x D products over the live
    pairs, against `ins` q-sized inputs read, `outs` outputs written and
    the [B, n, Tq] row statistics (lse and, backward, delta): (ms,
    bound_by, ms with 3xTF32 tensor cores)."""
    pairs = live_pairs(B, Tq, Tk, kv_len, causal) * N_HEADS
    elems = B * N_HEADS * HEAD_DIM
    nbytes = 4 * (elems * (Tq + 2 * Tk)                 # q, k, v
                  + elems * (ins - 3) * Tq               # dO (backward)
                  + elems * sum(outs)                    # outputs
                  + B * N_HEADS * Tq * (1 if ins == 3 else 2))
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


def bwd_inputs(rng, B, Tq, Tk, kv_len, causal, scale):
    dev = torch.device("cuda")
    q, k, v, do = (torch.from_numpy(rng.randn(B, N_HEADS, T, HEAD_DIM)
                                    .astype(np.float32)).to(dev)
                   for T in (Tq, Tk, Tk, Tq))
    lens = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    o, lse = fa.flash_attn_fwd(q, k, v, lens, torch.zeros_like(lens),
                               causal, scale)
    delta = (do * o).sum(-1).contiguous()
    return (q, k, v, do, lse, delta, lens)


def device_kernels(fn, calls=4):
    """{device kernel name: us per call} over `calls` profiled calls of
    fn: names the backend behind a library yardstick (its time is
    measured by events). Several calls, because the profiler now and
    then drops a call's device events; each name's time is its mean over
    the calls that recorded it."""
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
                names[ev.name] = names.get(ev.name, 0.0) + float(
                    ev.time_range.elapsed_us())
        per_call.append(names)
    seen = {}
    for call in per_call:
        for n, us in call.items():
            seen.setdefault(n, []).append(us)
    names = {n: float(np.mean(us)) for n, us in seen.items()}
    return {n: round(us, 1) for n, us in sorted(names.items(),
                                                key=lambda kv: -kv[1])}


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

def lse_kernel_phase(smi):
    """K5 against its plain version at the training shape, and against
    itself (two calls, bitwise). Tolerance 1e-4 absolute on values near
    log(V) = 10.8: f32-accurate dot products over H = 768 (3xTF32, summed
    a 64-wide k tile at a time) and a sum of 50304 exponentials, in other
    orders."""
    rng = np.random.RandomState(SEED + 4)
    N = TRAIN_B * TRAIN_T
    dev = torch.device("cuda")
    sets = [(torch.from_numpy(rng.randn(N, HID).astype(np.float32)).to(dev),
             torch.from_numpy((rng.randn(HID, VOCAB) * 0.02)
                              .astype(np.float32)).to(dev))
            for _ in range(2)]
    got = ce.lm_head_lse(*sets[0])
    again = ce.lm_head_lse(*sets[0])
    torch.cuda.synchronize()
    ref = ce.lm_head_lse_plain(*sets[0])
    err = float((got - ref).abs().max())
    log(f"kernel lm_head_lse: x [{N},{HID}] w [{HID},{VOCAB}] "
        f"max_abs_err {err:.3e} (tol {TOL:g}); two calls bitwise equal: "
        f"{bool(torch.equal(got, again))}")
    if not np.isfinite(err) or err > TOL:
        raise AssertionError("lm_head_lse disagrees with its plain version")
    if not torch.equal(got, again):
        raise AssertionError("lm_head_lse: two calls on the same inputs "
                             "differ (the split merge must be in order)")
    r = {"max_abs_err": err,
         "ms": time_ms(ce.lm_head_lse, sets, reps=6),
         "plain_ms": time_ms(ce.lm_head_lse_plain, sets, reps=3),
         "library_ms": time_ms(lambda x, w: torch.logsumexp(x @ w, dim=1),
                               sets, reps=3)}
    flops, nbytes = 2.0 * N * HID * VOCAB, 4.0 * (N * HID + HID * VOCAB + N)
    r["bound_ms"], r["bound_by"] = bound(flops, nbytes)
    r["bound_3xtf32_ms"] = bound_3xtf32(flops, nbytes)
    log(f"kernel lm_head_lse: ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f}"
        f" library_ms (logsumexp(x @ w)) {r['library_ms']:.4f} bound_ms "
        f"{r['bound_ms']:.5f} ({r['bound_by']}) | {smi}")
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
             "tiles, cp.async 2-stage; Tq = 1: f32 FMA, 8 warps split "
             "the keys")
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
                           "register A, V MN-major), 256 q rows = 4 "
                           "consumer warpgroups + a TMA producer warp, K/V "
                           "tiles by TMA in a 3-stage mbarrier ring; S_j "
                           "issued before P_{j-1}.V_{j-1}, whose run hides "
                           "the softmax of S_j",
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
    "lm_head_lse_bf16": "bf16 mma.sync m16n8k16, 64-row x tile resident, "
                        "w [64 x 128] chunks cp.async 2-stage by "
                        "ldmatrix.trans, 8 warps"}

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
    "flash_attn_fwd": ("flash_fwd_",),
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
    a rung-8 dispatch (M = 8192) and a ragged case, the weight
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
    proj, ffn_up, lm head; K 3072: ffn_down), dynamic and static scales;
    timed per width and summed over a dispatch (37 x K 768, 12 x K 3072)
    beside its bytes bound (f32 in, int8 out) and the plain version."""
    M = SERVE_B * TRAIN_T
    per_dispatch = {HID: 3 * LAYERS + 1, 4 * HID: LAYERS}
    static = torch.tensor([0.0125], device="cuda")
    results = {}
    for K, count in per_dispatch.items():
        sets = [(quantize_inputs(rng, M, K),) for _ in range(3)]
        for scale in (None, static):
            xq, ax = qo.quantize_activations(sets[0][0], scale)
            torch.cuda.synchronize()
            ref_q, ref_ax = qo.quantize_activations_plain(sets[0][0], scale)
            if not (torch.equal(xq, ref_q) and torch.equal(ax, ref_ax)):
                raise AssertionError(
                    f"quantize_activations [{M},{K}] "
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
        bound_ms = 5.0 * M * K / PEAK_HBM_BYTES * 1e3
        results[K] = (count, ms, plain_ms, bound_ms)
        log(f"kernel quantize_activations [{M},{K}]: bitwise == plain "
            f"(dynamic and static; zero row, exact halves); ms {ms:.4f} "
            f"plain_ms {plain_ms:.4f} bound_ms {bound_ms:.5f} (bytes) | "
            f"{smi}")
        del sets
    total = {"max_abs_err": 0.0, "library_ms": None, "bound_by": "bytes",
             "cases": [{"M": M, "K": K, "per_dispatch": c, "ms": ms,
                        "plain_ms": p, "bound_ms": b}
                       for K, (c, ms, p, b) in results.items()]}
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
    log(f"int8 serving: warmed rungs {rungs} in "
        f"{time.perf_counter() - t0:.1f} s")
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
    torch.cuda.reset_peak_memory_stats()
    int8_ms, int8_min = timed_dispatch(exe, prog, qscope, feed, fetch)
    int8_peak = torch.cuda.max_memory_allocated() / 2**30
    breakdown = dispatch_breakdown("int8", exe, prog, qscope, feed, fetch,
                                   int8_ms, smi)
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
    tokens = SERVE_B * TRAIN_T
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


def attn_bound_bf16(B, Tq, Tk, kv_len, causal, products, ins, outs):
    """attn_bound's work with bf16 operands: `products` T x T x D
    products over the live pairs at the bf16 peak, against `ins`
    q-sized bf16 inputs, the bf16 outputs `outs` (lengths) and the f32
    row statistics."""
    pairs = live_pairs(B, Tq, Tk, kv_len, causal) * N_HEADS
    elems = B * N_HEADS * HEAD_DIM
    nbytes = (2 * (elems * (Tq + 2 * Tk) + elems * (ins - 3) * Tq
                   + elems * sum(outs))
              + 4 * B * N_HEADS * Tq * (1 if ins == 3 else 2))
    return bound_bf16(2.0 * HEAD_DIM * pairs * products, nbytes)


def bf16_err(got, ref):
    """(max |got - ref|, that over max |ref|) in f32."""
    diff = float((got.float() - ref.float()).abs().max())
    return diff, diff / max(float(ref.float().abs().max()), 1e-30)


def bf16_attn_inputs(rng, B, Tq, Tk, kv_len, causal, scale):
    """bf16 q/k/v head views of packed [B, T, 3 * 768] planes, as the qkv
    fc writes them (q from a plane of its own when Tq != Tk), dO a head
    view of a [B, Tq, 768] plane, and the forward's LSE and delta (f32).
    Returns the backward's arguments and the forward's O."""
    dev, H = torch.device("cuda"), N_HEADS * HEAD_DIM

    def plane(T, width):
        return torch.from_numpy(rng.randn(B, T, width).astype(np.float32)
                                ).to(dev, torch.bfloat16)
    kv = plane(Tk, 3 * H)
    qp = kv if Tq == Tk else plane(Tq, 3 * H)
    q, k, v = (fa._heads(t, N_HEADS) for t in
               (qp[..., :H], kv[..., H:2 * H], kv[..., 2 * H:]))
    do = fa._heads(plane(Tq, H), N_HEADS)
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
    ragged kv_len case and a Tq != Tk case; K5-bf16 at x [8192, 768] @
    w [768, 50304]. Each timed by CUDA-graph replay over two input sets
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
    results["flash_attn_bwd_fused_bf16"] = fused_bf16_phase(rng, scale, smi)

    # K5-bf16 at the training shape
    N = TRAIN_B * TRAIN_T
    dev = torch.device("cuda")
    lse_sets = [(torch.from_numpy(rng.randn(N, HID).astype(np.float32))
                 .to(dev, torch.bfloat16),
                 torch.from_numpy((rng.randn(HID, VOCAB) * 0.02)
                                  .astype(np.float32)).to(dev, torch.bfloat16))
                for _ in range(2)]
    got = ce.lm_head_lse_bf16(*lse_sets[0])
    torch.cuda.synchronize()
    ref = ce.lm_head_lse_plain(*lse_sets[0])
    err = float((got - ref).abs().max())
    log(f"bf16 lm_head_lse_bf16: x [{N},{HID}] w [{HID},{VOCAB}] "
        f"max_abs_err {err:.3e} (tol {TOL:g})")
    if not np.isfinite(err) or err > TOL:
        raise AssertionError("lm_head_lse_bf16 disagrees with its plain "
                             "version")
    r = {"case": "train", "max_abs_err": err,
         "ms": time_ms(ce.lm_head_lse_bf16, lse_sets, reps=10),
         "plain_ms": time_ms(ce.lm_head_lse_plain, lse_sets, reps=3),
         "library_ms": time_ms(lambda x, w: torch.logsumexp(
             torch.mm(x, w, out_dtype=torch.float32), dim=1), lse_sets,
             reps=5),
         "replaces": "paddle_tpu/ops/chunked_ce.py:90"}
    r["bound_ms"], r["bound_by"] = bound_bf16(
        2.0 * N * HID * VOCAB, 2.0 * (N * HID + HID * VOCAB) + 4.0 * N)
    log(f"bf16 lm_head_lse_bf16: ms {r['ms']:.4f} plain_ms "
        f"{r['plain_ms']:.4f} library_ms (logsumexp(mm(x, w, f32 out))) "
        f"{r['library_ms']:.4f} bound_ms {r['bound_ms']:.5f} "
        f"({r['bound_by']}) | {smi}")
    results["lm_head_lse_bf16"] = r
    del lse_sets
    torch.cuda.empty_cache()
    return results


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
               "lm_head_lse_bf16": ("lse_bf16_kernel",)}
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


def main():
    name, smi = device_phase()
    t0 = time.perf_counter()
    _build.build_libraries(_build.KERNEL_SOURCES)
    log(f"build: {', '.join(_build.KERNEL_SOURCES)} (nvcc, sm_90a, in "
        f"parallel) in {time.perf_counter() - t0:.1f} s")
    cases = kernel_phase()
    serving_k1 = engine_phase(smi)
    bwd, k1_train = backward_kernel_phase(smi)
    lse = lse_kernel_phase(smi)
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
    paths = {"serving": {"flash_attn_fwd": serving_k1},
             f"training_T{TRAIN_T}": train_counts,
             f"training_T{SHORT_T}": short_counts,
             "serving_int8": int8_counts,
             f"training_amp_T{TRAIN_T}": amp_counts,
             f"training_amp_T{SHORT_T}": amp_short_counts}
    launches = {k: sum(p.get(k, 0) for p in paths.values())
                for k in ALL_KERNELS}
    by_path = {k: {p: c.get(k, 0) for p, c in paths.items()}
               for k in ALL_KERNELS}
    for k, n in launches.items():
        if n == 0:
            raise AssertionError(f"{k} was launched no time on a main path")
    decode = next(c for c in cases if c["case"] == "decode")
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
    print(json.dumps({"kernels": kernels, "training": train,
                      "training_short": short_train,
                      "serving_int8": int8_serving,
                      "training_amp": amp_train,
                      "training_amp_short": amp_short,
                      "training_amp_batch": amp_batch}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
