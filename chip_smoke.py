"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. device: torch's name for card 0 and nvidia-smi's name and power
     limit;
  2. build: the K1 flash-attention kernel (paddle_tpu_torch/csrc/
     flash_attn_fwd.cu) with nvcc for sm_90a, from this checkout;
  3. kernel: K1 held against its plain PyTorch version at the LM
     server's shapes (GPT-2-small heads: n=12, D=64; prefill b=4,
     t=256 over a 384-key page view, cold and prefix-hit; decode 8
     slots x 1 row over 384 keys), float32, ragged kv_len, inputs from
     a numpy seed. Tolerance 1e-4 absolute on O and LSE: the two sum in
     different orders (online softmax over 32-key chunks vs one
     softmax over the row). Times: the kernel, the plain version and
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
     forward of the same weights on the card.

The second-to-last line is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when
no CUDA card is visible or when run outside a checkout of the repo.
"""

import json
import os
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
    from paddle_tpu_torch import _build, flags, monitor
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.serving import (GenerationConfig,
                                          GenerationEngine, LMSpec,
                                          init_lm_weights)
    from paddle_tpu_torch.serving.http import make_server
    from paddle_tpu_torch.weights import lm_weights_from_numpy
    from paddle_tpu_torch._device import use_full_f32
except ImportError as e:
    sys.exit(f"chip_smoke: the paddle_tpu_torch package is not beside "
             f"this script ({e}); run it from a checkout of the repo")

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
TOL = 1e-4
SEED = 0
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
    HBM peak."""
    live = live_mask(B, Tq, kv_len, q_start)
    pairs = int(live.sum()) * N_HEADS
    flops = 4.0 * HEAD_DIM * pairs
    kv_rows = int(np.minimum(kv_len, VIEW).sum()) * N_HEADS
    nbytes = 4 * (B * N_HEADS * Tq * HEAD_DIM * 2       # q in, O out
                  + 2 * kv_rows * HEAD_DIM              # live K and V
                  + B * N_HEADS * Tq)                   # LSE out
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


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
        bound_ms, bound_by = bound_of(B, Tq, kv_len, q_start)
        log(f"kernel {name}: ms {ms:.4f} plain_ms {plain_ms:.4f} "
            f"library_ms {library_ms:.4f} bound_ms {bound_ms:.5f} "
            f"({bound_by})")
        results.append({"case": name, "q": [B, N_HEADS, Tq, HEAD_DIM],
                        "kv": VIEW, "max_abs_err": max(err_o, err_lse),
                        "ms": ms, "plain_ms": plain_ms,
                        "library_ms": library_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by})
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


def main():
    name, smi = device_phase()
    t0 = time.perf_counter()
    _build.build_library("flash_attn_fwd")
    log(f"build: flash_attn_fwd (nvcc, sm_90a) in "
        f"{time.perf_counter() - t0:.1f} s")
    cases = kernel_phase()
    launches = engine_phase(smi)
    decode = next(c for c in cases if c["case"] == "decode")
    kernels = [{
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "paddle_tpu/ops/pallas_attention.py:212",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": decode["ms"], "plain_ms": decode["plain_ms"],
        "bound_ms": decode["bound_ms"], "bound_by": decode["bound_by"],
        "library_ms": decode["library_ms"], "cases": cases}]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
