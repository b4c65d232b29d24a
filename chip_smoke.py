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

 26. telemetry (monitor/, profiler.py): (a) GPT-2-small amp at T 1024,
     B 32 (bench.py's transformer_mfu) under the port's Trainer, three
     steps without health_metrics and three with: step walls, the
     perf.mfu gauge, and one more step's grad_norm, param_norm and every
     update ratio against float64 recomputes of the same tensors on the
     card (1e-5 relative); the health launches (device events of a
     profiled step with the health fetches less without); (b)
     deviceprof.profile_program on that step: device mode, at least 0.9
     of the device time attributed to Program ops, and each hand-written
     kernel's events a step (the most of three profiled steps) equal to
     its launch counter a step; the top 12 ops; (c) a step:N:nan fault
     under check_nan_inf with blackbox_dir set: one blackbox bundle with
     spans, the health section and torch.cuda memory; (d) GPT-2-small
     behind the HTTP server (graph rungs) with metrics, trace_path and a
     0.5 s sampler: 36 generations of 64 tokens from 6 clients, /debug/vars with
     metrics, perf, timeseries rates and the SLO table, every request's
     span in the trace file under the x-trace-id its client sent,
     tokens/s and the decode dispatch wall with telemetry on and off
     (the same tokens); (e) the int8 GPT-2-small one-shot engine with
     profile_sample_n=4: per-rung serving.device_time histograms and a
     deviceprof section whose rows name K6 and the quantize kernel.
 27. seq2seq-attention training: bench.py's bench_seq2seq program, card
     config and feed (amp, Adam 1e-3, B 256, T 64, vocab 30000, emb /
     hid 512, lengths fed int64): 3 warm-up and 10 timed steps, losses
     finite and falling; tokens/s, step ms, peak memory, MFU from
     program_flops, one step under deviceprof.profile_program (busy
     share, top ops); then a batch with lengths 16-64 from the seed;
 28. its beam decode (seq2seq_attention_infer over phase 27's weights,
     64 sentences, beam 4, max_len 32): sentences/s; the card against
     the plain CPU run of gru_attention_beam_decode on the card's
     EncStates (ids and lengths equal but on rows excused by a near tie,
     at most 2; scores within 1e-4 relative);
 29. the book's stacked-LSTM sentiment net (emb 128, hidden 512, 3
     LSTMs, B 128, lengths 32-128 through the DataFeeder), f32 with TF32
     off: ms a batch beside the reference's K40m figure;
 30. the seq2seq training program at width 32 for two Adam steps, every
     op on the card on the CPU's values of its inputs within 1e-4.
     No TPU kernel lies on these paths: their launch counts are checked
     to be 0.
 31. CTR training: bench.py's bench_ctr_sparse card config (wide&deep
     over 10M x 32 and 10M x 1 is_sparse tables, 26 fields, hidden
     (64, 32), Adam 1e-3, ids uniform over the vocab) at B 512 and 4096
     under each sparse_grad mode (auto, selected_rows, dense), timed as
     bench.py's _train_throughput (2 warm-up steps, 3 x 10 steps):
     examples/s median, low, high; a profiled step's device ms, busy
     share and device kernels; syncs of a step (torch's sync debug
     mode); peak memory; the dispatch counters (auto must take the
     dense path at this size); losses finite and falling;
     auto_vs_best_forced; the host-fed row (B 4096, auto, DeviceFeeder)
     and DeepFM at B 4096 under selected_rows; 5 steps under the NaN
     guard against 5 without;
 32. CTR on the card: (a) both CTR programs at vocab 200, 8 fields,
     emb 8, hidden 16, B 64, a dense input of 4, selected_rows, two
     Adam steps, every op on the card on the CPU's values of its inputs
     (SelectedRows rows equal, values and merged sums) within 1e-5 of
     its largest element; (b) selected_rows against dense under SGD at
     phase 31's config, B 4096, 3 steps, within rtol 1e-5 atol 1e-6;
     (c) lazy Adam: phase 31's selected_rows B 4096 run leaves every
     untouched table row bitwise equal and moves every looked-up one;
     (d) two selected_rows Adam runs from one seed bitwise equal;
 33. scoring: an InGraphAuc over phase 31's batches, its histograms
     equal to numpy's of the fetched scores exactly, its AUC within
     1e-6 of the host Auc's; the book's MLP MNIST trained on the card
     with an InGraphAccuracy (the loss below a fifth, accuracy > 0.9,
     the in-graph counts equal to the batches'). No TPU kernel lies on
     these paths either: their launch counts are checked to be 0.
 34. control flow, f32 with TF32 off: (a) a While-RNN (array_read over
     x [T 64, B 64, D 512], matmul, tanh, assign, increment, less_than)
     against the simple_rnn op on the same weight, the final state
     within 1e-5 of its largest element, the condition read on the host
     T + 1 times a run; (b) an IfElse row-wise merge at B 4096, width
     512, with dW, against a plain torch recompute within 1e-5; (c) a
     recurrent_group whose step is simple_rnn's cell (a memory of 512, a
     StaticInput bias): its output and the gradients of W and b against
     the simple_rnn op within 1e-5, then 20 Adam steps with the loss
     falling. Each: step wall, device ms, busy share, syncs a step;
 35. OCR: models.ocr.crnn_ctc_cost at its own widths on 1 x 32 x 256
     images (T 64), 95 classes + blank, B 128, labels of 5-20 ids with
     repeats, image widths 160-256: step 1's loss and every gradient
     against the same program on the CPU (1e-5 relative; 1e-4 of each
     gradient's largest element), 200 Adam 5e-3 steps on the batch, the
     loss below half of step 1's; the greedy decode (ctc_align,
     edit_distance) at the initial state and after training, each row's
     ids, length and edit distance equal to numpy's on the card's own
     logits, and its mean edit distance (EditDistance); examples/s,
     device ms, busy, syncs;
 36. SRL: the book's db_lstm + CRF (word_dim 32, mark_dim 5, hidden 512,
     depth 8, conll05's 5000 words, 3000 predicates, 59 labels), B 64,
     lengths 8-64: step 1 against the CPU (the loss within 1e-5
     relative, each gradient within 2e-3 of its largest element: relu
     candidates move a few by more than one op's rounding), the Viterbi
     paths equal but where the two paths' scores are within 1e-5 (a near
     tie), 20 Adam steps with the loss falling, the InGraphChunkEvaluator
     counts equal to the host ChunkEvaluator's on the decoded tags
     exactly; then step 1 op by op on the card within 1e-4, and a control
     with tanh candidates whose step 1 is held as 35's; tokens/s, device
     ms, busy. No TPU kernel lies on the phases 34-36 paths: their launch
     counts are checked to be 0. A profile that lost device events (fewer
     than its host side launched) is taken again, up to 3 times, and
     else its device ms and busy share are not reported;
 37. an LM fleet in process: a port FleetRouter over two GPT-2-small
     GenerationEngines (phase 4's weights and config: paged KV, 8 slots,
     every rung a CUDA graph), each behind its own make_server(
     replica_id=...) and FleetRegistrar. Four concurrent streams, one
     buffered request and a repeated prompt through the router: both
     replicas serve (x-served-by), every reply's greedy tokens equal the
     same prompt on one engine alone bitwise, summed over both engines
     and read through the graphs' tallies: the decode kernel's K1
     launches == layers x decode steps, the Tq > 1 kernel's == layers x
     prefills, and page gathers == 2 x layers x prefills. Tokens/s and
     TTFT p50 / p99 of 400 generations at 8 closed-loop streaming
     clients through the router and against one engine directly (a
     fresh prompt set each), and the router's added TTFT (1 client).
     Then lm-1 stopped hard (server closed, engine shut down without
     draining) with buffered generations live: every request succeeds on
     the survivor (tokens equal to it alone) or fails typed, and the
     fleet.* counters (requests, hops, retries, failovers, typed replies)
     equal what the clients saw;
 38. a supervised one-shot fleet of real `python -m paddle_tpu_torch
     serve --model_dir ... --fleet` replica processes: phase 10's
     GPT-2-small + argmax at T 1024 saved in f32 and quantized to int8 in
     a temporary directory, each model's ids for 4 request sets of 8 rows
     computed here by Executor.run first. Two f32 replicas (one rung of
     8 rows each, a CUDA graph): (a) SIGKILL one under 4 closed-loop
     clients: zero raw and zero typed failures, x-trace-id kept, counters
     of the reference drill (one breaker open, ejection, restart and
     registration, failovers as seen), the respawned replica seen
     registered but not ready before its readmission, every reply's ids
     bitwise the f32 ids; requests/s and p50 / p99 of 8 closed-loop
     clients for 10 s through the router and for 10 s against one
     replica directly; (b) rolling_swap to the int8 directory, its
     replicas sampling their dispatches (profile_sample_n), under load:
     zero dropped and zero typed, fleet.swaps 2, every reply the f32 or
     the int8 ids and every reply after the swap the int8 ids; each int8
     replica's /debug/vars: its dispatches, and its own sampled device
     trace naming K6 and the quantize kernel. Their launches are not
     read: they live on the replica's own kernel wrappers, not in the
     metrics it serves or dumps (ROADMAP C25); (c) the reactive
     autoscaler, min 1, max 2, over a fresh
     one-replica int8 fleet: a 16-client ramp gives exactly one
     scale-up, the plateau only holds, a trickle through the quiesce
     sees exactly one scale-down by drain and zero failures. Boot times,
     the swap's duration and the decision timeline are printed, and the
     memory: nvidia-smi's card total before and with the replicas, its
     per-process reading where it lists the PID, and each replica's
     torch.cuda reserved and peak bytes from its /debug/vars; on a
     failure the replicas' log tails.
 39. detection and the evaluators left, f32 with TF32 off: SSD300 on
     VGG16 (conv1_1-conv5_3, pool3 in ceil_mode, fc6 dilated 6 and fc7
     as convolutions, four extra pairs, conv4_3 l2-normalised times a
     learned scale at 20, multi_box_head over six maps: 8732 priors, 21
     classes). (a) the detection ops at its sizes (B 32, 16 gt slots)
     on the card against the same port code on the CPU over the same
     seeded inputs: priors within 1 ulp, IoU and the three box codes
     within 1e-6 of each array's largest element, bipartite_match,
     target_assign, mine_hard_examples' mask and multiclass_nms' Out and
     OutCount exactly (a row excused only at a near tie, counted; the
     NMS also with every score tied, exactly); each
     op's card time, the NMS's kernels, host syncs (none) and peak
     memory; (b) one training step at B 2 op by op, every op on the
     CPU's values of its inputs within 1e-4 of each output's largest
     element, the step run free printed, not held; (c) ssd_loss with
     hard-negative mining (3:1, overlap 0.5), Momentum(1e-5, 0.9), 50
     steps at B 32 on one batch: the mean of the last 5 losses below
     0.8 x step 1's; images/s, step wall, device ms, busy share, kernels
     and syncs a step, peak memory; (d) inference at B 32 over 4
     batches (softmax, detection_output at nms 0.45, top 400, keep 200,
     score 0.01, InGraphDetectionMAP with 512 buckets): each batch's
     in-graph TpHist / FpHist / PosCount bitwise detection_map_buckets
     on the CPU over the fetched detections, walls, the NMS's share,
     syncs, the in-graph mAP beside the host DetectionMAP's; (e)
     roi_pool at Fast R-CNN's shape ([2, 512, 38, 63], 1/16, 128 ROIs an
     image, 7 x 7): Out and Argmax equal to the CPU's, the gradient of a
     weighted sum within 1e-6, ms and peak memory; (f) InGraphPnpair
     over 16384 scores in 64 queries and InGraphPrecisionRecall over
     4096 predictions of 21 classes: counts equal to the CPU's and the
     host evaluators'. No TPU kernel lies on the SSD300 paths: their
     launch counts are checked to be 0.
 40. the rest of the op corpus, f32 with TF32 off. (a) each of the 57
     ops at a stated shape on the card against the same lowering on
     the CPU: outputs within 1e-5 of their largest element, gradients
     within 1e-4, the integer and selecting outputs (gather, scatter
     with distinct ids, multiplex, crop, rotate, range, isfinite, ceil,
     round, the with_index pools' Mask) exactly, a tied window's
     gradient split in quarters exactly; where raises; print syncs
     once; nce without CustomSamples draws uniform negatives in [0, V)
     (chi-square) and scores them as the CPU does, with CustomSamples
     draws nothing; sampling_id's one-hot rows exact, a fixed row's
     draws by chi-square. (b) word2vec's N-gram model at the book's
     widths (V 2073, embedding 32, hidden 256, B 100) with the softmax,
     NCE (10 negatives) and hsigmoid heads: step 1 op by op against the
     CPU (NCE's negatives given), 200 Adam steps with the loss falling,
     examples/s, device ms, busy share, syncs a step. (c) nets.glu and
     nets.scaled_dot_product_attention against the CPU. (d) C3D's conv1
     / pool1 / conv2 / pool2 and conv2's inverse (B 8 clips of 3 x 16 x
     112 x 112), SegNet's pool with index into unpool (B 4 x 64 x 360 x
     480), spp on VGG16's conv5 map and bilinear_interp x 2: forward +
     backward ms and peak memory, and at batch 1 against the CPU. No
     TPU kernel lies on these paths: their launch counts are checked to
     be 0.
 41. the legacy front end, f32 with TF32 off (~60-90 s). (a) a legacy
     AlexNet config after benchmark/paddle/image/alexnet.py (227 x 227 x
     3, 1000 classes, B 128, Momentum 0.9, L2; its @provider draws
     images and labels from a seed), written with its provider into a
     temporary directory: `python -m paddle_tpu_torch train` (layer_num
     1, 1280 samples: 10 batches, every cost finite, pass-00000 saved),
     `time --num_batches=20` (ms a batch, samples/s) and `test
     --init_model_path=.../pass-00000`, run in this process through
     runpy so the launch counters see them; then step 1 at layer_num 1
     and 2 (dropout off) on the card against the CPU from the same
     weights: the loss within 1e-5 relative, each op on the CPU's values
     of its inputs within 1e-4 of each output's largest element; the
     step's wall, device ms, busy share, kernels and peak memory. (b)
     `checkgrad` on tests/fixtures/cli/tiny_config.py: max relative
     diff under 5e-2. (c) the v2 API: init(use_gpu=True), the book's
     recognize-digits conv net, one pass of 8192 synthetic mnist images
     at B 128 through trainer.SGD with Momentum, infer on 128 test
     images: the first 3 costs and the probabilities within 1e-5 of the
     CPU's from the same weights; samples/s. (d) legacy_beam_generate:
     the memory decoder of tests/test_legacy_generation.py at width 512,
     a 30000-word dictionary, beam 3, B 64, max_length 50 (the seqToseq
     demo's 250, cut): ms and kernels a generation, no device -> host
     sync in a generation, ids and lengths equal to the CPU's from the
     same weights but for rows at a near tie (at most 2), scores within
     1e-5. (e) cross_entropy_over_beam: tests/test_beam_training.py's
     two cases and a B 64 batch of 3 expansions, beam 3, through kmax ->
     sub_nested_seq -> seq_slice: loss and gradients within 1e-6 of the
     CPU's, beam.host_syncs 1 a forward + backward. No TPU kernel lies
     on these paths: their launch counts are checked to be 0.
 42. the pb model format, recordio and the dataset loaders. (a) phase
     10's GPT-2-small inference program and weights saved with
     format="pb" (the reference's binary ProgramDesc, `__model__`) and
     with format="json"; both loaded by load_inference_model (walls in
     turns, the program's parse alone, the files' sizes), the programs
     alike (ops, slots, var shapes, dtypes, persistables; float attrs
     equal after rounding to float32); the pb directory quantized by
     quantize_inference_model (4 x 12 + 2 ops, no fallback), written
     again as pb, loaded (int8 weights column-major) and served one-shot
     through InferenceEngine.from_program behind make_server with phase
     10's eight requests (the main path `pb_serving_int8`): K1, K6 and
     the quantize kernel launch as on phase 10 a dispatch, and every
     reply's ids are bitwise those of the json-saved int8 model. (b)
     phase 27's seq2seq amp program (B 256, vocab 30000, emb / hid 512,
     Adam 1e-3) trained 8 steps by the Trainer from wmt16.train (lengths
     3-16) through recordio (pickled examples in 4 files built with g++
     from native/recordio.cpp, sharded_reader(paths, 1, 0),
     reader.batch(256)): feeds bitwise those of wmt16.train fed
     straight, step 1's loss bitwise, later losses within
     WMT_LOSS_TOL (beside the spread of a second recordio run), finite
     and falling; tokens/s, step wall, a profiled step's device time,
     the busy share and a batch's host time (read, unpickle, batch,
     DataFeeder) beside phase 27's. (c) the book's recommender from
     movielens.train through recordio, 6 steps at B 256: feeds bitwise
     the direct reader's, losses finite and falling. No TPU kernel lies
     on (b) and (c): their launch counts are checked to be 0.

The second-to-last line is the kernel table as JSON (with the ResNet-50
results under "resnet50"); the last line is
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when
no CUDA card is visible or when run outside a checkout of the repo.
"""

import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
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
    from paddle_tpu_torch.serving import (AutoscaleConfig,
                                          AutoscaleController, EngineConfig,
                                          FleetRegistrar, FleetRouter,
                                          GenerationConfig, GenerationEngine,
                                          InferenceEngine, LMSpec,
                                          ReplicaSupervisor, RouterConfig,
                                          init_lm_weights)
    from paddle_tpu_torch.serving.http import make_server
    from paddle_tpu_torch.weights import (lm_weights_from_numpy,
                                          scope_from_numpy)
    from paddle_tpu_torch._device import use_full_f32
    from paddle_tpu_torch.native import build as native_build
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

TYPED_ERRORS = ("shed", "unavailable", "deadline")    # a fleet's typed sheds


def local(port):
    return f"http://127.0.0.1:{port}"


def http_call(url, path, body=None, trace_id=None, timeout=300):
    """One HTTP exchange with a server, a router or a replica: a GET
    without `body`, else a POST of it (bytes, or a dict sent as JSON).
    Returns (status, headers, raw body, seconds to the status line)."""
    import http.client
    from urllib.parse import urlsplit
    parts = urlsplit(url)
    conn = http.client.HTTPConnection(parts.hostname, parts.port,
                                      timeout=timeout)
    headers = {"Content-Type": "application/json"}
    if trace_id:
        headers["x-trace-id"] = trace_id
    if isinstance(body, dict):
        body = json.dumps(body)
    t0 = time.perf_counter()
    try:
        conn.request("GET" if body is None else "POST", path, body=body,
                     headers=headers)
        resp = conn.getresponse()
        first = time.perf_counter() - t0
        return resp.status, dict(resp.getheaders()), resp.read(), first
    finally:
        conn.close()


def outcome(status, error_type):
    """"ok", "typed" (a 429 / 503 / 504 naming a typed shed) or "raw"."""
    if status == 200 and not error_type:
        return "ok"
    if status in (429, 503, 504) and error_type in TYPED_ERRORS:
        return "typed"
    return "raw"


def generate(url, body, trace_id=None):
    """One POST /v1/generate of the dict `body` (streamed unless its
    "stream" is false): a dict with status, outcome, served_by,
    attempts, trace_ok, tokens, TTFT (the first token line; the whole
    reply when buffered), wall, and the error_type and error of a
    failure (an in-band error event included)."""
    import http.client
    from urllib.parse import urlsplit
    parts = urlsplit(url)
    conn = http.client.HTTPConnection(parts.hostname, parts.port,
                                      timeout=600)
    stream = body.get("stream", True)
    t0 = time.perf_counter()
    conn.request("POST", "/v1/generate", json.dumps(body),
                 {"Content-Type": "application/json",
                  **({"x-trace-id": trace_id} if trace_id else {})})
    resp = conn.getresponse()
    out = {"status": resp.status, "served_by": resp.getheader("x-served-by"),
           "attempts": int(resp.getheader("x-fleet-attempts") or 1),
           "trace_ok": (trace_id is None
                        or resp.getheader("x-trace-id") == trace_id),
           "tokens": [], "ttft": None, "error_type": None, "error": None}
    try:
        if resp.status != 200:
            raw = resp.read()
            out["error"] = raw[:300]
            try:
                out["error_type"] = json.loads(raw or b"{}").get("error_type")
            except ValueError:
                pass
        elif not stream:
            out["tokens"] = json.loads(resp.read())["tokens"]
            out["ttft"] = time.perf_counter() - t0
        else:
            for line in resp:
                ev = json.loads(line)
                if ev["event"] == "token":
                    if out["ttft"] is None:
                        out["ttft"] = time.perf_counter() - t0
                    out["tokens"].append(ev["token"])
                elif ev["event"] == "error":
                    out["error_type"] = ev.get("error_type") or "in-band"
                    out["error"] = ev
    finally:
        conn.close()
    out["wall"] = time.perf_counter() - t0
    out["outcome"] = ("raw" if resp.status == 200 and out["error"]
                      else outcome(resp.status, out["error_type"]))
    return out


def post(port, body, trace_id=None):
    """generate() on the server at `port`, raising unless it answered
    in full (and echoed `trace_id`): (tokens, TTFT)."""
    r = generate(local(port), body, trace_id)
    if r["outcome"] != "ok" or not r["trace_ok"]:
        raise AssertionError(f"/v1/generate -> {r['status']}, x-trace-id "
                             f"echoed: {r['trace_ok']}: {r['error']!r}")
    return r["tokens"], r["ttft"]


def get_json(port, path):
    status, _, body, _ = http_call(local(port), path, timeout=60)
    if status != 200:
        raise AssertionError(f"GET {path} -> {status}: {body[:300]!r}")
    return json.loads(body)


def post_infer(port, tokens):
    status, _, body, _ = http_call(local(port), "/v1/infer",
                                   {"feeds": {"tokens": tokens.tolist()}})
    if status != 200:
        raise AssertionError(f"/v1/infer -> {status}: {body[:300]!r}")
    return np.asarray(json.loads(body)["outputs"][0], np.int64)


class ClientLoad:
    """`clients` closed-loop client threads, started at once. Each calls
    `send(i, trace_id)` for the next request number i until finish() or,
    with `cap`, until `cap` requests were sent in all, waiting `period_s`
    between its requests. A record is send()'s dict with the send time
    `t`, `trace_id` and `i`; a send that raises is a raw failure."""

    def __init__(self, send, clients, prefix, cap=None, period_s=0.0):
        self.records = []
        self.stop = threading.Event()
        self.wall = None
        self._lock = threading.Lock()
        self._next = 0
        self._t0 = time.perf_counter()
        self._threads = [threading.Thread(
            target=self._client, args=(send, prefix, cap, period_s),
            daemon=True) for _ in range(clients)]
        for t in self._threads:
            t.start()

    def _client(self, send, prefix, cap, period_s):
        while not self.stop.is_set():
            with self._lock:
                i = self._next
                self._next += 1
            if cap is not None and i >= cap:
                return
            rec = {"t": time.monotonic(), "trace_id": f"{prefix}-{i}", "i": i}
            try:
                rec.update(send(i, rec["trace_id"]))
            except Exception as e:       # a raw failure: recorded
                rec.update(outcome="raw", error=repr(e))
            self.records.append(rec)
            if period_s:
                self.stop.wait(period_s)

    def oks(self, start=0):
        return sum(1 for r in self.records[start:] if r["outcome"] == "ok")

    def served(self, rid, start=0):
        return any(r.get("served_by") == rid and r["outcome"] == "ok"
                   for r in self.records[start:])

    def join(self):
        """Wait for every client (a capped load ends by itself); the
        records by request number, and `wall` from start to end."""
        for t in self._threads:
            t.join(900)
        if any(t.is_alive() for t in self._threads):
            raise TimeoutError("a client thread did not finish")
        self.wall = time.perf_counter() - self._t0
        return sorted(self.records, key=lambda r: r["i"])

    def finish(self):
        self.stop.set()
        return self.join()


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
    fa.flash_attn_fwd.decode_launches = 0


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


def lower_on(op, ins, attrs, device, in_place=False, grad=False,
             generator=None):
    """One op's lowering on `device` over numpy arrays or tensors (the
    executor's dispatch without a program): a tensor already on
    `device` is passed as it is, anything else is copied there (always
    copied when `in_place`, so the lowering never writes the caller's
    arrays); autograd records only when `grad`; a random op draws from
    `generator`."""
    ctx = types.SimpleNamespace(in_place=in_place, op=None,
                                device=torch.device(device),
                                generator=generator)
    tins = {k: [torch.as_tensor(v).to(device, copy=in_place) for v in vs]
            for k, vs in ins.items()}
    with torch.set_grad_enabled(grad):
        return op_registry.get_op(op).lowering(ctx, tins, dict(attrs))


def optimizer_suite_phase(smi):
    """Phase 21: every update op once at a GPT-2 parameter's shape
    [768, 3072] on the card, held to the same op on the CPU (SUITE_RTOL
    of each output's largest element); on the card, the guard's
    new-tensor mode == the in-place mode bitwise."""
    worst = {}
    for name, (op_type, ins, attrs) in suite_cases().items():
        def run(device, in_place):
            out = lower_on(op_type, {k: [v] for k, v in ins.items()}, attrs,
                           device, in_place=in_place)
            return {k: v[0].cpu() for k, v in out.items()}

        cpu, card, fresh = run("cpu", True), run("cuda", True), \
            run("cuda", False)
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


# -- phase 26: telemetry -----------------------------------------------------

TEL_B = 32                       # bench.py's transformer_mfu batch (amp)
TEL_STEPS = 3
TEL_HEALTH_RTOL = 1e-5
TEL_COVERAGE = 0.9
TEL_CLIENTS, TEL_REQUESTS, TEL_NEW = 6, 36, 64
TEL_SAMPLE_N = 4


def tel_reader(n_batches, seed):
    rng = np.random.RandomState(seed)
    n = TEL_B * n_batches
    tok = rng.randint(0, VOCAB, (n, TRAIN_T, 1)).astype(np.int64)
    nxt = rng.randint(0, VOCAB, (n, TRAIN_T, 1)).astype(np.int64)
    return pt.reader.batch(lambda: zip(tok, nxt), TEL_B)


class TelTrainer:
    """The amp GPT-2-small program (T 1024, B 32) under the port's
    Trainer, with a handler that times every step (BeginIteration to
    EndIteration) and keeps its health snapshot."""

    def __init__(self, health):
        main, startup, cost, _ = build_gpt2(TRAIN_T)
        amp.enable(main)
        self.cost = cost
        self.trainer = pt.Trainer(cost, main_program=main,
                                  startup_program=startup,
                                  health_metrics=health, feed_workers=1)
        self.walls, self.health, self.skipped = [], [], []

    def handler(self, ev):
        kind = type(ev).__name__
        if kind == "BeginIteration":
            torch.cuda.synchronize()
            self._t0 = time.perf_counter()
        elif kind == "EndIteration":
            self.walls.append(1e3 * (time.perf_counter() - self._t0))
            self.health.append(ev.health)
        elif kind == "IterationSkipped":
            self.skipped.append((ev.pass_id, ev.batch_id))

    def train(self, n_batches, seed):
        t = self.trainer
        t.train(tel_reader(n_batches, seed), t._start_pass + 1,
                ["tok", "nxt"], self.handler)


def rel_vec_err(got, ref):
    """max |got - ref| / |ref| elementwise, in float64."""
    got, ref = got.double().ravel(), ref.double().ravel()
    return float(((got - ref).abs() / ref.abs().clamp_min(1e-300)).max())


def health_check(tt, smi):
    """One more executor step of the health trainer's program with every
    gradient fetched beside the health fetches: grad_norm, param_norm and
    each update ratio against float64 recomputes of the same tensors."""
    H = monitor.health
    t = tt.trainer
    pairs = H.param_grad_pairs(t.main_program)
    scope = t.scope
    pre = {p: scope.get(p).detach().double() for p, _ in pairs}
    rng = np.random.RandomState(SEED + 41)
    feed = {k: rng.randint(0, VOCAB, (TEL_B, TRAIN_T, 1)).astype(np.int64)
            for k in ("tok", "nxt")}
    out = t.exe.run(t.main_program, feed=feed,
                    fetch_list=[tt.cost.name] + [g for _, g in pairs]
                    + list(H.FETCHES), scope=scope, return_numpy=False)
    grads = out[1:1 + len(pairs)]
    gn, pn, ratios = out[-3], out[-2], out[-1]
    gn64 = torch.sqrt(sum(g.double().square().sum() for g in grads))
    post = {p: scope.get(p).detach().double() for p, _ in pairs}
    pn64 = torch.sqrt(sum(v.square().sum() for v in post.values()))
    r64 = torch.stack([torch.linalg.vector_norm(post[p] - pre[p])
                       / (torch.linalg.vector_norm(pre[p]) + 1e-12)
                       for p, _ in pairs])
    errs = {"grad_norm": rel_vec_err(gn, gn64),
            "param_norm": rel_vec_err(pn, pn64),
            "update_ratios": rel_vec_err(ratios, r64)}
    log(f"telemetry (a): health values vs float64 recomputes on the card "
        f"over {len(pairs)} parameters: grad_norm {float(gn):.6g} "
        f"({errs['grad_norm']:.2e} relative), param_norm {float(pn):.6g} "
        f"({errs['param_norm']:.2e}), update ratios worst "
        f"{errs['update_ratios']:.2e} (tol {TEL_HEALTH_RTOL:g}) | {smi}")
    bad = {k: v for k, v in errs.items() if not v <= TEL_HEALTH_RTOL}
    if bad:
        raise AssertionError(f"health values differ from the float64 "
                             f"recomputes: {bad}")
    return errs, feed


def kernel_events(report, fragment):
    return sum(k["events_per_step"] for name, k in report["kernels"].items()
               if fragment in name)


def attribution_check(tt, feed, smi):
    """deviceprof.profile_program on the health trainer's step: device
    mode, coverage, and each hand-written kernel's events a step equal
    to its launch counter; then the health launches: one profiled step
    with the health fetches and one without."""
    t = tt.trainer
    dp = monitor.deviceprof
    zero_counts()
    rep = dp.profile_program(t.main_program, feed, [tt.cost.name], t.scope,
                             t.exe, steps=3, warmup=1)
    runs = 4                            # warm-up + 3 profiled steps
    per_step = {k: v / runs for k, v in read_counts().items()}
    log(f"telemetry (b): profile_program mode {rep['mode']}, coverage "
        f"{rep['coverage']:.4f} (floor {TEL_COVERAGE}), device time "
        f"{rep['total_us'] / 1e3:.2f} ms a step, unattributed "
        f"{rep['unresolved_us'] / 1e3:.3f} ms, step wall "
        f"{1e3 * rep['step_time_s']:.1f} ms (profiled) | {smi}")
    log("telemetry (b): top 12 Program ops of the amp step:\n"
        + dp.format_rows(rep["rows"], top=12))
    by_type = {}
    for r in rep["rows"]:
        by_type[r["op_type"]] = by_type.get(r["op_type"], 0.0) \
            + r["device_time_us"] / 1e3
    by_type = dict(sorted(((k, round(v, 3)) for k, v in by_type.items()),
                          key=lambda kv: -kv[1]))
    log(f"telemetry (b): device ms a step by op type {by_type}; device "
        f"events' launches over the 3 steps {rep['links']} | {smi}")
    matched = {}
    for w, frags in AMP_KERNELS.items():
        for frag in frags:
            matched[frag] = (kernel_events(rep, frag), per_step[w])
    log(f"telemetry (b): kernel events a step (the most of 3 profiled "
        f"steps) vs launch counter a step: {matched}")
    if rep["mode"] != "device":
        raise AssertionError(f"profile_program mode {rep['mode']}, "
                             "expected device")
    if not rep["coverage"] >= TEL_COVERAGE:
        raise AssertionError(f"deviceprof coverage {rep['coverage']:.4f} "
                             f"< {TEL_COVERAGE}")
    wrong = {f: v for f, v in matched.items() if v[0] != v[1]}
    if wrong or not any(v[1] for v in matched.values()):
        raise AssertionError(f"deviceprof kernel events != launch "
                             f"counters: {wrong}")
    unscoped = [r for r in rep["rows"]
                if dp.SCOPE_RE.fullmatch(r["scope"]) is None]
    if unscoped:
        raise AssertionError(f"rows not named by a Program op: {unscoped}")

    def events_of(fetch):
        r = dp.profile_fn(lambda: t.exe.run(
            t.main_program, feed=feed, fetch_list=fetch, scope=t.scope,
            return_numpy=False), steps=1, warmup=0)
        return sum(k["events_per_step"] for k in r["kernels"].values()), r
    plain, _ = events_of([tt.cost.name])
    with_health, rh = events_of([tt.cost.name]
                                + list(monitor.health.FETCHES))
    health_launches = with_health - plain
    log(f"telemetry (a): device events a step {plain} without health, "
        f"{with_health} with: {health_launches} health launches; step "
        f"wall {1e3 * rh['step_time_s']:.1f} ms profiled | {smi}")
    brief = dp.brief_rows(rep["rows"], top=12)
    return {"mode": rep["mode"], "coverage": rep["coverage"],
            "device_ms": rep["total_us"] / 1e3,
            "unresolved_ms": rep["unresolved_us"] / 1e3,
            "links": rep["links"], "ms_by_op_type": by_type,
            "kernel_events_vs_launches": matched, "top": brief,
            "health_launches": health_launches}


def bundle_check(tt, smi):
    """A step:N:nan fault under check_nan_inf with blackbox_dir set: one
    blackbox bundle that parses and holds spans, the health section and
    the card's memory."""
    import glob
    bb = tempfile.mkdtemp(prefix="chip_smoke_bb_")
    t = tt.trainer
    step = t.global_step + 1
    flags.set_flag("blackbox_dir", bb)
    flags.set_flag("check_nan_inf", True)
    flags.set_flag("faults", f"step:{step}:nan")
    pt.resilience.faults.reset()
    t.anomaly_policy = pt.resilience.AnomalyPolicy("skip_batch")
    try:
        tt.train(3, SEED + 43)
    finally:
        flags.set_flag("faults", "")
        pt.resilience.faults.reset()
        flags.set_flag("check_nan_inf", False)
        flags.set_flag("blackbox_dir", "")
        t.anomaly_policy = None
    files = glob.glob(os.path.join(bb, "blackbox-*.json"))
    if len(files) != 1:
        raise AssertionError(f"expected one blackbox bundle, got {files}")
    with open(files[0]) as f:
        bundle = json.load(f)
    spans = [r for r in bundle["records"] if r.get("kind") == "span"]
    mem = bundle["device_memory"]
    health = bundle.get("health") or {}
    log(f"telemetry (c): {os.path.basename(files[0])} "
        f"({os.path.getsize(files[0])} B): reason {bundle['reason']}, "
        f"error {bundle['error']!r}, {len(spans)} spans, health last "
        f"{health.get('last')}, device memory {mem[0].get('bytes_in_use')} "
        f"B in use / peak {mem[0].get('peak_bytes_in_use')} B "
        f"({mem[0].get('source')}); skipped {tt.skipped} | {smi}")
    if not spans or not health.get("last") or \
            mem[0].get("source") != "torch.cuda" or \
            not mem[0].get("bytes_in_use"):
        raise AssertionError("the bundle lacks spans, the health section "
                             "or the card's memory")
    size = os.path.getsize(files[0])
    shutil.rmtree(bb, ignore_errors=True)
    return {"bundle_bytes": size, "spans": len(spans),
            "reason": bundle["reason"]}


def telemetry_trainer_phase(smi):
    """(a)-(c): the amp GPT-2-small step under the Trainer without and
    with health_metrics (the path telemetry_trainer_amp), the health
    values against float64, deviceprof's attribution of the step, and a
    blackbox bundle from an injected NaN."""
    torch.cuda.empty_cache()
    monitor.reset()
    monitor.introspect.reset()
    flags.set_flag("metrics", True)
    route = fa.bwd_route(TRAIN_T)
    steps = 2 * TEL_STEPS
    zero_counts()                       # the main path starts here
    walls = {}
    off = TelTrainer(health=False)
    off.train(TEL_STEPS, SEED + 40)
    walls["off"] = off.walls
    del off
    torch.cuda.empty_cache()
    tt = TelTrainer(health=True)
    tt.train(TEL_STEPS, SEED + 40)
    walls["on"] = tt.walls
    counts = read_counts()              # the main path ends here
    split = LAYERS * steps if route == "split" else 0
    check_counts(counts, launches_of(
        flash_attn_fwd_bf16=LAYERS * steps,
        flash_attn_bwd_fused_bf16=LAYERS * steps - split,
        flash_attn_bwd_dq_bf16=split, flash_attn_bwd_dkv_bf16=split,
        lm_head_lse_bf16=steps), f"telemetry trainer ({steps} steps)")
    gauges = monitor.snapshot()["gauges"]
    mfu = {k: v for k, v in gauges.items() if k.startswith("perf.mfu|")}
    hl = tt.health[-1]
    log(f"telemetry (a): Trainer amp T {TRAIN_T} B {TEL_B}: step walls "
        f"without health {[round(w, 1) for w in walls['off']]} ms, with "
        f"{[round(w, 1) for w in walls['on']]} ms (steps 2-3: "
        f"{np.mean(walls['off'][1:]):.1f} vs {np.mean(walls['on'][1:]):.1f}"
        f" ms); {mfu}, perf.step_flops {gauges.get('perf.step_flops')}; "
        f"last health {hl} | {smi}")
    if not mfu or not all(0 < v < 1 for v in mfu.values()):
        raise AssertionError(f"perf.mfu gauge missing or out of (0, 1): "
                             f"{mfu}")
    if any(h is None for h in tt.health):
        raise AssertionError("EndIteration.health missing")
    errs, feed = health_check(tt, smi)
    attribution = attribution_check(tt, feed, smi)
    bundle = bundle_check(tt, smi)
    del tt
    torch.cuda.empty_cache()
    return counts, {"step_ms_off": walls["off"], "step_ms_on": walls["on"],
                    "mfu": mfu, "health_rel_err": errs,
                    "attribution": attribution, "bundle": bundle}


def lm_load(port, tag):
    """TEL_REQUESTS generations from TEL_CLIENTS client threads, each
    with its own x-trace-id; returns ({trace id: tokens}, wall s)."""
    rng = np.random.RandomState(SEED + 50)
    bodies = [{"prompt": rng.randint(0, VOCAB, int(n)).tolist(),
               "max_new_tokens": TEL_NEW, "stream": bool(i % 2)}
              for i, n in enumerate(rng.randint(16, 96, TEL_REQUESTS))]
    load = ClientLoad(lambda i, tid: generate(local(port), bodies[i], tid),
                      TEL_CLIENTS, tag, cap=TEL_REQUESTS)
    records = load.join()
    bad = [(r["i"], r.get("status"), r.get("error")) for r in records
           if r["outcome"] != "ok" or not r["trace_ok"]]
    if bad or len(records) != TEL_REQUESTS:
        raise AssertionError(f"telemetry (d): requests failed: {bad}")
    return {r["trace_id"]: r["tokens"] for r in records}, load.wall


def lm_telemetry_phase(smi):
    """(d): GPT-2-small behind the HTTP server on graph rungs with
    metrics, an ambient trace and the 0.5 s sampler on, then off."""
    tdir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    trace_file = os.path.join(tdir, "trace.json")
    spec = LMSpec(50304, 768, 12, 12, 1024)
    weights = init_lm_weights(spec, seed=SEED)
    cfg = GenerationConfig(max_slots=8, prefill_batch=4, max_prompt_len=256,
                           max_new_tokens=128, paged=True, page_len=16,
                           prefix_cache=True)
    engine = GenerationEngine(spec, weights, config=cfg, ready=False)
    engine.warmup()
    server = make_server(engine, port=0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    walls = []
    real = engine._dispatch_decode

    def timed_decode(*a, **k):
        t0 = time.perf_counter()
        out = real(*a, **k)
        walls.append(time.perf_counter() - t0)
        return out

    engine._dispatch_decode = timed_decode
    monitor.reset()
    flags.set_flag("metrics", True)
    flags.set_flag("trace_path", trace_file)
    flags.set_flag("metrics_sample_s", 0.5)
    try:
        time.sleep(0.6)                 # a sampler tick before the load
        zero_counts()                   # the main path starts here
        steps0 = engine.stats()["decode_steps"]
        on, wall_on = lm_load(port, "cafe")
        time.sleep(1.1)                 # two sampler ticks after the load
        counts = read_counts()          # the main path ends here
        steps_on = engine.stats()["decode_steps"] - steps0
        dv = get_json(port, "/debug/vars")
    finally:
        flags.set_flag("metrics_sample_s", 0)
        monitor.trace.stop(save=True)
    dec_on = list(walls)
    monitor.set_enabled(False)
    walls.clear()
    off, wall_off = lm_load(port, "beef")
    dec_off = list(walls)
    server.shutdown()
    engine.shutdown(drain=True, timeout=600)
    flags.set_flag("metrics", True)
    tokens = TEL_REQUESTS * TEL_NEW
    ts = dv.get("timeseries") or {}
    rates = {n: c["rate"] for n, c in (ts.get("window") or {}).get(
        "counters", {}).items() if n.startswith("serving_lm.")}
    slo = ts.get("slo") or []
    with open(trace_file) as f:
        events = json.load(f)["traceEvents"]
    traced = {(ev.get("args") or {}).get("trace_id") for ev in events
              if ev.get("name") == "serving_lm/request"}
    missing = sorted(set(on) - traced)
    log(f"telemetry (d): /debug/vars sections {sorted(dv)}; timeseries "
        f"ticks {ts.get('ticks')}, rates {rates}; slo table "
        f"{[(r.get('rule'), r.get('state')) for r in slo]}; trace file "
        f"{os.path.getsize(trace_file)} B, {len(events)} events, "
        f"{len(set(on)) - len(missing)} of {len(on)} request ids found")
    log(f"telemetry (d): telemetry on: {tokens / wall_on:.1f} tokens/s "
        f"({wall_on:.2f} s), decode dispatch {1e3 * np.mean(dec_on):.3f} ms "
        f"(median {1e3 * np.median(dec_on):.3f}, {len(dec_on)} steps); off: "
        f"{tokens / wall_off:.1f} tokens/s ({wall_off:.2f} s), decode "
        f"dispatch {1e3 * np.mean(dec_off):.3f} ms (median "
        f"{1e3 * np.median(dec_off):.3f}, {len(dec_off)} steps); K1 "
        f"launches {counts['flash_attn_fwd']} | {smi}")
    for key in ("metrics", "perf", "timeseries"):
        if key not in dv:
            raise AssertionError(f"/debug/vars lacks {key!r}")
    if not rates.get("serving_lm.tokens") or not slo:
        raise AssertionError("/debug/vars timeseries has no token rate or "
                             "no SLO table")
    if missing:
        raise AssertionError(f"trace file lacks request spans {missing}")
    if any(on[k] != off[k.replace("cafe", "beef", 1)] for k in on):
        raise AssertionError("telemetry on and off served other tokens")
    if not counts["flash_attn_fwd"] or steps_on <= 0:
        raise AssertionError("the LM server launched no K1")
    shutil.rmtree(tdir, ignore_errors=True)
    del engine, weights
    torch.cuda.empty_cache()
    return counts, {"tokens_per_s_on": tokens / wall_on,
                    "tokens_per_s_off": tokens / wall_off,
                    "decode_ms_on": 1e3 * float(np.mean(dec_on)),
                    "decode_ms_off": 1e3 * float(np.mean(dec_off)),
                    "slo_rules": len(slo), "ticks": ts.get("ticks")}


def sampler_phase(smi):
    """(e): the int8 GPT-2-small one-shot engine with profile_sample_n=4:
    per-rung serving.device_time histograms and a deviceprof section
    whose rows name K6 and the quantize kernel."""
    torch.cuda.empty_cache()
    main, startup, logits, ids = build_gpt2_lm()
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sampler_")
    src, out = os.path.join(tmp, "f32"), os.path.join(tmp, "int8")
    pt.io.save_inference_model(src, ["tokens"], [ids], exe,
                               main_program=main, scope=scope)
    del scope
    quant.quantize_inference_model(src, out)
    qscope = pt.Scope()
    prog, feeds, fetch = pt.io.load_inference_model(out, exe, scope=qscope)
    monitor.reset()
    monitor.deviceprof.reset()
    flags.set_flag("metrics", True)
    flags.set_flag("profile_sample_n", TEL_SAMPLE_N)
    try:
        engine = InferenceEngine.from_program(
            prog, feeds, fetch, executor=exe, scope=qscope,
            config=EngineConfig(max_batch_size=4, buckets=(1, 2, 4),
                                batch_timeout_ms=5))
    finally:
        flags.set_flag("profile_sample_n", 0)
    engine.warmup()
    rng = np.random.RandomState(SEED + 60)
    reqs = [rng.randint(0, VOCAB, (int(r), TRAIN_T)).astype(np.int64)
            for r in rng.randint(1, 5, 16)]
    zero_counts()                       # the main path starts here
    for r in reqs:
        engine.infer({"tokens": r}, timeout=300)
    counts = read_counts()              # the main path ends here
    st = engine.stats()
    engine.shutdown()
    shutil.rmtree(tmp, ignore_errors=True)
    dp = st.get("deviceprof") or {}
    hists = {k: v["count"] for k, v in monitor.snapshot()[
        "histograms"].items() if k.startswith("serving.device_time")}
    top = dp.get("top_ops") or []
    names = [r["op"] for r in top]
    log(f"telemetry (e): {st['batches']} batches, sampler {dict((k, dp.get(k)) for k in ('batches_seen', 'sampled', 'captures', 'capture_errors'))}; "
        f"serving.device_time counts {hists}; last sample "
        f"{ {k: v for k, v in (dp.get('last') or {}).items() if k != 'top_ops'} }; "
        f"launches {counts}; top rows {top} | {smi}")
    if not hists or not all("|rung=" in k for k in hists):
        raise AssertionError("no per-rung serving.device_time histogram")
    if not dp.get("captures") or not any("int8_matmul_kernel" in n
                                         for n in names) \
            or not any("quantize_rows" in n for n in names):
        raise AssertionError(f"the sampler's rows do not name K6 and the "
                             f"quantize kernel: {names}")
    if not counts["int8_matmul"] or not counts["quantize_activations"]:
        raise AssertionError("the int8 engine launched no K6 / quantize")
    del engine, qscope
    torch.cuda.empty_cache()
    return counts, {"device_time_counts": hists, "sampler": {
        k: dp.get(k) for k in ("batches_seen", "sampled", "captures")},
        "top_ops": top}


def telemetry_phase(smi):
    """Phase 26, (a)-(e)."""
    t0 = time.perf_counter()
    trainer_counts, trainer = telemetry_trainer_phase(smi)
    lm_counts, lm = lm_telemetry_phase(smi)
    sampler_counts, sampler = sampler_phase(smi)
    log(f"telemetry: phase 26 in {time.perf_counter() - t0:.1f} s | {smi}")
    return ({"telemetry_trainer_amp": trainer_counts,
             "telemetry_lm_server": lm_counts,
             "telemetry_sampler_int8": sampler_counts},
            {"trainer": trainer, "lm_server": lm, "sampler": sampler})



# -- phases 27-30: sequence (LoD) programs -----------------------------------
# No TPU kernel lies on this path: the reference runs the recurrences as
# lax.scan and the attention as two batched matmuls (XLA), so the port's
# lowerings are plain torch; the paths' kernel counts are checked to be 0.

# bench.py's bench_seq2seq card config (bench.py:216-217)
S2S_B, S2S_T, S2S_VOCAB, S2S_EMB, S2S_HID = 256, 64, 30000, 512, 512
S2S_LR, S2S_WARM, S2S_TIMED = 1e-3, 3, 10
S2S_RAGGED = (16, 64)            # the extra batch's lengths, from the seed
DEC_SENTENCES, DEC_BEAM, DEC_MAX_LEN = 64, 4, 32
DEC_SRC_LENS = (8, 64)
DEC_SCORE_RTOL = 1e-4
DEC_TIE_LEAD = 1e-5              # a step's choice led the next by less
DEC_MAX_TIE_ROWS = 2
# the book's stacked-LSTM sentiment net (benchmark/paddle/rnn's width)
LSTM_B, LSTM_VOCAB, LSTM_EMB, LSTM_HID, LSTM_STACKED = 128, 30000, 128, 512, 3
LSTM_LENS = (32, 128)
LSTM_WARM, LSTM_TIMED = 2, 5
LSTM_K40M_MS = 261.0             # BASELINE.md:17, B 128, hidden 512, K40m
# phase 30: the seq2seq training program at a small width, op by op
SEQ_PAR_B, SEQ_PAR_T, SEQ_PAR_VOCAB, SEQ_PAR_W = 8, 12, 64, 32
SEQ_PAR_TOL = 1e-4


def seq2seq_program(vocab, emb, hid, lr, use_amp):
    """bench.py's bench_seq2seq program: seq2seq_attention_cost with
    Adam(lr), amp when asked."""
    pt.framework.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        src, tgt, nxt = [pt.layers.data(n, [1], dtype="int64", lod_level=1)
                         for n in ("src", "tgt", "nxt")]
        cost = pt.models.seq2seq.seq2seq_attention_cost(
            src, tgt, nxt, vocab, vocab, emb, hid)
        pt.AdamOptimizer(lr).minimize(cost)
    if use_amp:
        amp.enable(main)
    return main, startup, cost


def seq2seq_feed(B, T, vocab, seed, lens=None):
    """bench.py's feed (:235-240): random source and target ids, the
    next-token labels the target rolled by one, every length T fed as
    int64 to the int32 @SEQLEN vars; or `lens`, with the padded tail 0."""
    rng = np.random.RandomState(seed)
    s = rng.randint(1, vocab, (B, T)).astype(np.int64)
    t = rng.randint(1, vocab, (B, T)).astype(np.int64)
    n = np.roll(t, -1, 1)
    if lens is None:
        lens = np.full((B,), T, np.int64)
    else:
        pad = np.arange(T)[None, :] >= lens[:, None]
        s[pad] = t[pad] = n[pad] = 0
    return {"src": s, "src@SEQLEN": lens, "tgt": t, "tgt@SEQLEN": lens,
            "nxt": n, "nxt@SEQLEN": lens}


def timed_steps(exe, main, feed, cost, scope, warm, timed):
    """`warm` then `timed` steps, each ending in the loss's fetch (so the
    card has finished it): (losses, step walls in ms)."""
    losses, walls = [], []
    for i in range(warm + timed):
        t0 = time.perf_counter()
        loss, = exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
        if i >= warm:
            walls.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(loss.ravel()[0]))
    return losses, walls


def seq2seq_train_phase(smi):
    """Phase 27: bench.py's seq2seq-attention training program at its card
    config (B 256, T 64, vocab 30000, emb / hid 512, Adam 1e-3, amp),
    fed as bench.py feeds it: S2S_WARM warm-up steps, then S2S_TIMED
    timed steps on one batch (losses finite and falling); tokens/s, step
    ms median and range, peak memory, MFU from program_flops; one step
    under deviceprof.profile_program (busy share = its device time over
    the unprofiled median step, the top ops); then one step of a batch
    with lengths from the seed in S2S_RAGGED. Returns (launch counts,
    the trained scope, results)."""
    torch.cuda.empty_cache()
    main, startup, cost = seq2seq_program(S2S_VOCAB, S2S_EMB, S2S_HID,
                                          S2S_LR, True)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    feed = seq2seq_feed(S2S_B, S2S_T, S2S_VOCAB, SEED + 27)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()                       # the main path starts here
    losses, walls = timed_steps(exe, main, feed, cost, scope, S2S_WARM,
                                S2S_TIMED)
    counts = read_counts()              # the main path ends here
    peak = torch.cuda.max_memory_allocated()
    check_counts(counts, launches_of(), "seq2seq training (no TPU kernel "
                 "on this path)")
    med, lo, hi = median_lo_hi(walls)
    tokens_s = S2S_B * S2S_T / (med / 1e3)
    flops = monitor.introspect.program_flops(main, feed)
    peak_flops, label = monitor.introspect.peak_flops()
    mfu = flops / (med / 1e3) / peak_flops
    log(f"seq2seq amp training B {S2S_B} T {S2S_T} vocab {S2S_VOCAB} emb/hid "
        f"{S2S_EMB}: {tokens_s:.0f} tokens/s, step {med:.2f} ms median "
        f"({lo:.2f}-{hi:.2f}, {S2S_TIMED} steps after {S2S_WARM}); losses "
        f"{[round(x, 4) for x in losses]}; peak memory "
        f"{peak / 2**30:.2f} GiB; program_flops {flops / 1e12:.3f} TFLOP a "
        f"step, MFU {mfu:.4f} of {label} {peak_flops / 1e12:.0f} TFLOP/s "
        f"| {smi}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"seq2seq losses not finite and falling: "
                             f"{losses}")
    rep = monitor.deviceprof.profile_program(main, feed, [cost.name], scope,
                                             exe, steps=1, warmup=0)
    device_ms = rep["total_us"] / 1e3
    by_type = {}
    for r in rep["rows"]:
        by_type[r["op_type"]] = by_type.get(r["op_type"], 0.0) \
            + (r["device_time_us"] or 0.0) / 1e3
    by_type = dict(sorted(((k, round(v, 3)) for k, v in by_type.items()),
                          key=lambda kv: -kv[1])[:12])
    log(f"seq2seq amp step under profile_program: mode {rep['mode']}, "
        f"device {device_ms:.2f} ms against the {med:.2f} ms median step "
        f"(busy share {device_ms / med:.3f}), coverage "
        f"{rep['coverage']:.4f}; device ms by op type {by_type} | {smi}")
    log(f"seq2seq amp step: top 12 Program ops | {smi}\n"
        + monitor.deviceprof.format_rows(rep["rows"], top=12))
    rng = np.random.RandomState(SEED + 28)
    lens = rng.randint(S2S_RAGGED[0], S2S_RAGGED[1] + 1, S2S_B).astype(
        np.int64)
    ragged = seq2seq_feed(S2S_B, S2S_T, S2S_VOCAB, SEED + 29, lens)
    r_losses, r_walls = timed_steps(exe, main, ragged, cost, scope, 1, 2)
    log(f"seq2seq amp ragged batch (lengths {lens.min()}-{lens.max()}, "
        f"mean {lens.mean():.1f}): losses {[round(x, 4) for x in r_losses]}"
        f", step {np.median(r_walls):.2f} ms | {smi}")
    if not all(np.isfinite(r_losses)):
        raise AssertionError(f"seq2seq ragged losses {r_losses}")
    return counts, scope, {
        "tokens_per_s": tokens_s, "step_ms": med, "step_ms_lo": lo,
        "step_ms_hi": hi, "losses": losses, "peak_gib": peak / 2**30,
        "program_tflop": flops / 1e12, "mfu": mfu,
        "profile": {"mode": rep["mode"], "device_ms": device_ms,
                    "busy": device_ms / med, "coverage": rep["coverage"],
                    "by_op_type_ms": by_type,
                    "top": monitor.deviceprof.brief_rows(rep["rows"], 12)},
        "ragged": {"losses": r_losses, "step_ms": float(np.median(r_walls)),
                   "len_min": int(lens.min()), "len_max": int(lens.max())}}


def decode_leads(record):
    """A wrapper of beam_ops.beam_step that appends, for each step, every
    batch row's smallest lead among the step's K + 1 best candidates
    (the chosen K in order, then the first one left out)."""
    from paddle_tpu_torch.ops import beam_ops
    real = beam_ops.beam_step

    def step(pre_scores, logprobs, finished, end_id, beam_size,
             first_step=False):
        out = real(pre_scores, logprobs, finished, end_id, beam_size,
                   first_step)
        B, K, V = logprobs.shape
        cont = torch.where(finished[..., None],
                           torch.where(torch.arange(V) == end_id,
                                       torch.tensor(0.0),
                                       torch.tensor(-1e9)), logprobs)
        total = pre_scores[..., None] + cont
        if first_step:
            total[:, 1:] += -1e9
        top = torch.sort(total.reshape(B, -1), dim=1, descending=True,
                         stable=True).values[:, :beam_size + 1]
        record.append((top[:, :-1] - top[:, 1:]).amin(dim=1))
        return out
    return beam_ops, real, step


def seq2seq_decode_phase(scope, smi):
    """Phase 28: seq2seq_attention_infer at phase 27's width over its
    trained weights (the stable names find them in the scope),
    DEC_SENTENCES ragged source sentences, beam DEC_BEAM, max_len
    DEC_MAX_LEN: sentences/s and ms a decode; then the card against the
    plain CPU run of gru_attention_beam_decode fed the card's own
    EncStates and the same weights: SentenceIds and SentenceLen equal
    on every row, except a row where some step's chosen candidate led
    the next by under DEC_TIE_LEAD (rounding may pick the other one
    there); such excused rows are counted, at most DEC_MAX_TIE_ROWS;
    SentenceScores within DEC_SCORE_RTOL relative on every row whose
    sentences are equal. The rows with a near tie at all are counted
    and printed too."""
    from paddle_tpu_torch.ops import beam_ops
    pt.framework.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        src = pt.layers.data("src", [1], dtype="int64", lod_level=1)
        ids, scores, lens = pt.models.seq2seq.seq2seq_attention_infer(
            src, S2S_VOCAB, S2S_VOCAB, S2S_EMB, S2S_HID,
            beam_size=DEC_BEAM, max_len=DEC_MAX_LEN)
    op = next(o for o in main.global_block().ops
              if o.type == "gru_attention_beam_decode")
    rng = np.random.RandomState(SEED + 30)
    slens = rng.randint(DEC_SRC_LENS[0], DEC_SRC_LENS[1] + 1,
                        DEC_SENTENCES).astype(np.int32)
    T = int(pt.data_feeder.bucket_length(int(slens.max())))
    s = rng.randint(1, S2S_VOCAB, (DEC_SENTENCES, T, 1)).astype(np.int64)
    s[np.arange(T)[None, :] >= slens[:, None]] = 0
    feed = {"src": s, "src@SEQLEN": slens}
    exe = pt.Executor()
    fetch = [ids, scores, lens, op.input("EncStates")[0],
             op.input("SrcMask")[0]]
    zero_counts()                       # the main path starts here
    walls = []
    for i in range(4):
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                      return_numpy=False)
        torch.cuda.synchronize()
        if i:
            walls.append(1e3 * (time.perf_counter() - t0))
    counts = read_counts()              # the main path ends here
    check_counts(counts, launches_of(), "seq2seq beam decode (no TPU "
                 "kernel on this path)")
    med = float(np.median(walls))
    card_ids, card_scores, card_lens = (t.cpu() for t in out[:3])
    w = {slot: scope.get(op.input(slot)[0]).cpu()
         for slot in op.inputs if slot not in ("EncStates", "SrcMask")}
    record = []
    mod, real, wrapped = decode_leads(record)
    mod.beam_step = wrapped
    try:
        t0 = time.perf_counter()
        cpu_ids, cpu_scores, cpu_lens = beam_ops.gru_attention_beam_decode(
            out[3].cpu(), out[4].cpu(), w, DEC_BEAM, DEC_MAX_LEN,
            op.attrs["bos_id"], op.attrs["end_id"])
        cpu_s = time.perf_counter() - t0
    finally:
        mod.beam_step = real
    lead = torch.stack(record).amin(dim=0)          # [B]
    near = lead < DEC_TIE_LEAD
    same = ((card_ids == cpu_ids).flatten(1).all(1)
            & (card_lens == cpu_lens).all(1))
    differ = ~same
    excused = differ & near
    rel = ((card_scores - cpu_scores).abs()
           / cpu_scores.abs().clamp_min(1e-30))[same]
    rel_max = float(rel.max()) if rel.numel() else 0.0
    log(f"seq2seq beam decode: {DEC_SENTENCES} sentences (source lengths "
        f"{slens.min()}-{slens.max()}, padded {T}), beam {DEC_BEAM}, "
        f"max_len {DEC_MAX_LEN}: {med:.1f} ms a decode median of 3 "
        f"({DEC_SENTENCES / (med / 1e3):.1f} sentences/s); mean length "
        f"{float(card_lens[:, 0].float().mean()):.1f} | {smi}")
    log(f"seq2seq beam decode, card vs the plain CPU run on the card's "
        f"EncStates ({cpu_s:.1f} s): scores max relative error "
        f"{rel_max:.2e} (tolerance {DEC_SCORE_RTOL:g}) on the "
        f"{int(same.sum())} rows whose sentences are equal; rows whose ids "
        f"or lengths differ: {int(differ.sum())}, excused by a near tie: "
        f"{int(excused.sum())} (at most {DEC_MAX_TIE_ROWS}); rows with a "
        f"step lead under {DEC_TIE_LEAD:g} at all: {int(near.sum())}; "
        f"smallest lead {float(lead.min()):.3e} | {smi}")
    if rel_max > DEC_SCORE_RTOL or bool((differ & ~near).any()) \
            or int(excused.sum()) > DEC_MAX_TIE_ROWS:
        raise AssertionError("the card's beam decode differs from the "
                             "plain CPU run")
    return counts, {"ms_per_decode": med,
                    "sentences_per_s": DEC_SENTENCES / (med / 1e3),
                    "scores_rel_err": rel_max,
                    "near_tie_rows": int(near.sum()),
                    "differing_rows": int(differ.sum()),
                    "excused_rows": int(excused.sum()),
                    "smallest_lead": float(lead.min()),
                    "cpu_decode_s": cpu_s}


def lstm_phase(smi):
    """Phase 29: the book's stacked-LSTM sentiment net (emb LSTM_EMB,
    hidden LSTM_HID, stacked_num LSTM_STACKED, vocab LSTM_VOCAB, 2
    classes, Adam 1e-3), f32 with TF32 off, B LSTM_B, lengths from the
    seed in LSTM_LENS through the DataFeeder (bucketed to 128):
    LSTM_WARM + LSTM_TIMED batches, ms a batch beside the reference's
    published K40m figure."""
    torch.cuda.empty_cache()
    pt.framework.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        words = pt.layers.data("words", [1], dtype="int64", lod_level=1)
        label = pt.layers.data("label", [1], dtype="int64")
        probs = pt.models.lstm_text.stacked_lstm_net(
            words, LSTM_VOCAB, class_dim=2, emb_dim=LSTM_EMB,
            hid_dim=LSTM_HID, stacked_num=LSTM_STACKED)
        cost = pt.layers.mean(pt.layers.cross_entropy(probs, label))
        pt.AdamOptimizer(1e-3).minimize(cost)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(SEED + 31)
    rows = [(rng.randint(1, LSTM_VOCAB, int(n)).tolist(), int(n) % 2)
            for n in rng.randint(LSTM_LENS[0], LSTM_LENS[1] + 1, LSTM_B)]
    feed = pt.DataFeeder([words, label]).feed(rows)
    T = feed["words"].shape[1]
    zero_counts()                       # the main path starts here
    losses, walls = timed_steps(exe, main, feed, cost, scope, LSTM_WARM,
                                LSTM_TIMED)
    counts = read_counts()              # the main path ends here
    check_counts(counts, launches_of(), "stacked-LSTM training (no TPU "
                 "kernel on this path)")
    med, lo, hi = median_lo_hi(walls)
    log(f"stacked-LSTM f32 (TF32 off) B {LSTM_B}, padded T {T} (lengths "
        f"{LSTM_LENS[0]}-{LSTM_LENS[1]}), emb {LSTM_EMB}, hidden {LSTM_HID}, "
        f"{LSTM_STACKED} LSTMs: {med:.1f} ms a batch median ({lo:.1f}-"
        f"{hi:.1f}, {LSTM_TIMED} after {LSTM_WARM}); the reference's "
        f"published figure for B 128 at hidden 512 is {LSTM_K40M_MS:g} ms "
        f"on its own card, a K40m (BASELINE.md:17), not this one; losses "
        f"{[round(x, 4) for x in losses]} | {smi}")
    if T != 128 or not all(np.isfinite(losses)):
        raise AssertionError(f"stacked-LSTM: padded T {T}, losses {losses}")
    return counts, {"ms_per_batch": med, "ms_lo": lo, "ms_hi": hi,
                    "padded_T": int(T), "losses": losses,
                    "reference_k40m_ms": LSTM_K40M_MS}


def max_rel(got, ref):
    """max |got - ref| / max |ref| (float64)."""
    got = torch.as_tensor(got).double().cpu()
    ref = torch.as_tensor(ref).double().cpu()
    return float((got - ref).abs().max()) / max(float(ref.abs().max()),
                                                1e-30)


def op_by_op_step(main, feed, scope, what, tol, err=max_rel):
    """One step of `main` on the CPU from `scope` (a CPU scope, which the
    step advances), then every op lowered on the card on the CPU's values
    of its inputs (executor.lower_ops_on); raises if an output's `err`
    exceeds `tol`. Returns ({output: err}, {output: (card, CPU)})."""
    block = main.global_block()
    names = [n for n, v in block.vars.items()
             if not v.persistable and n not in feed]
    before = tensors_of(scope)
    out = pt.Executor(pt.CPUPlace()).run(main, feed=feed, fetch_list=names,
                                         scope=scope, return_numpy=False)
    values = dict(zip(names, out))
    for n, t in scope.vars.items():
        if isinstance(t, torch.Tensor) and block._find_var(n) is not None:
            values[n] = t
    values.update({k: torch.from_numpy(np.asarray(v))
                   for k, v in feed.items()})
    pairs = lower_ops_on(main, "cuda", before, values)
    errs = {n: err(got, ref) for n, (got, ref) in pairs.items()}
    bad = sorted((e, n) for n, e in errs.items() if not e <= tol)
    if bad:
        raise AssertionError(f"{what} op by op: the card differs from the "
                             f"CPU: {bad[-5:]}")
    return errs, pairs


def seq_parity_phase(smi):
    """Phase 30: the seq2seq training program at emb / hid SEQ_PAR_W,
    vocab SEQ_PAR_VOCAB, B SEQ_PAR_B, ragged lengths <= SEQ_PAR_T (a
    zero-length row), f32, two Adam steps: each step run on the CPU,
    then every op lowered on the card (executor.lower_ops_on) on the
    CPU's values of its inputs, each output within SEQ_PAR_TOL of its
    largest element."""
    main, startup, cost = seq2seq_program(SEQ_PAR_VOCAB, SEQ_PAR_W,
                                          SEQ_PAR_W, 1e-2, False)
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    rng = np.random.RandomState(SEED + 32)
    lens = rng.randint(1, SEQ_PAR_T + 1, SEQ_PAR_B).astype(np.int32)
    lens[-1] = 0
    feed = seq2seq_feed(SEQ_PAR_B, SEQ_PAR_T, SEQ_PAR_VOCAB, SEED + 33, lens)
    worst, n_out = {}, 0
    for step in (1, 2):
        errs, _ = op_by_op_step(main, feed, scope, f"seq2seq, step {step}",
                                SEQ_PAR_TOL)
        n_out += len(errs)
        k = max(errs, key=errs.get)
        worst[step] = (k, errs[k])
    block = main.global_block()
    log(f"seq2seq f32 op by op on the card, on the CPU's inputs (emb/hid "
        f"{SEQ_PAR_W}, vocab {SEQ_PAR_VOCAB}, B {SEQ_PAR_B}, lengths "
        f"{lens.tolist()}): {n_out} outputs of {len(block.ops)} ops over 2 "
        f"Adam steps, worst {worst} of the largest element (tolerance "
        f"{SEQ_PAR_TOL:g}) | {smi}")
    return {"outputs": n_out, "ops": len(block.ops),
            "worst": {str(k): v for k, v in worst.items()}}


def sequence_phase(smi):
    """Phases 27-30."""
    t0 = time.perf_counter()
    train_counts, scope, train = seq2seq_train_phase(smi)
    decode_counts, decode = seq2seq_decode_phase(scope, smi)
    del scope
    lstm_counts, lstm = lstm_phase(smi)
    parity = seq_parity_phase(smi)
    log(f"sequence programs: phases 27-30 in {time.perf_counter() - t0:.1f}"
        f" s | {smi}")
    return ({"seq2seq_training_amp": train_counts,
             "seq2seq_beam_decode": decode_counts,
             "stacked_lstm_training": lstm_counts},
            {"seq2seq_training_amp": train, "seq2seq_beam_decode": decode,
             "stacked_lstm_training": lstm, "seq2seq_op_by_op": parity})


# -- phases 31-33: CTR with SelectedRows sparse gradients ---------------------

# bench.py's bench_ctr_sparse card config (:537): wide&deep over a 10M-row
# table, 26 fields, embedding 32, hidden (64, 32) (wide_deep's default),
# Adam 1e-3, ids uniform over the vocab, B 512 and 4096, three gradient
# paths; _train_throughput's 2 warm-up steps, 10 steps, 3 repeats
CTR_V, CTR_F, CTR_DIM, CTR_HIDDEN, CTR_LR = 10_000_000, 26, 32, (64, 32), 1e-3
CTR_BATCHES = (512, 4096)
CTR_MODES = ("auto", "selected_rows", "dense")
CTR_WARM, CTR_STEPS, CTR_REPEATS = 2, 10, 3
CTR_GUARD_STEPS = 5
# phase 32 (a): both CTR programs at a small width, op by op
CTR_PAR_V, CTR_PAR_F, CTR_PAR_EMB, CTR_PAR_HID, CTR_PAR_B = 200, 8, 8, 16, 64
CTR_PAR_TOL = 1e-5
CTR_SGD_RTOL, CTR_SGD_ATOL, CTR_SGD_LR = 1e-5, 1e-6, 0.5   # phase 32 (b)
CTR_AUC_BUCKETS, CTR_AUC_TOL = 200, 1e-6
MNIST_STEPS = 80


def ctr_program(model, with_auc=False, opt=None, dense_input=False,
                width=None):
    """bench.py's CTR program (`model` over is_sparse tables, mean
    sigmoid log-loss, Adam 1e-3 unless `opt`), optionally scored by an
    InGraphAuc over sigmoid(logit): (main, startup, cost, auc). `width`:
    (vocab, fields, embedding, hidden), phase 31's by default."""
    V, F, emb, hidden = width or (CTR_V, CTR_F, CTR_DIM, CTR_HIDDEN)
    pt.framework.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        ids = pt.layers.data("ids", [F, 1], dtype="int64")
        label = pt.layers.data("label", [1], dtype="float32")
        dense = pt.layers.data("dense", [4]) if dense_input else None
        logit = getattr(pt.models.ctr, model)(
            ids, V, F, emb_dim=emb, hidden=hidden, dense_input=dense,
            is_sparse=True)
        cost = pt.layers.mean(
            pt.layers.sigmoid_cross_entropy_with_logits(logit, label))
        auc = None
        if with_auc:
            auc = pt.evaluator.InGraphAuc(
                pt.layers.sigmoid(logit), label,
                num_thresholds=CTR_AUC_BUCKETS)
        (opt or pt.AdamOptimizer(CTR_LR)).minimize(cost)
    return main, startup, cost, auc


def ctr_feed(rng, B, V=None, F=None):
    """bench.py's feed: ids uniform over the vocab [B, F, 1] int64,
    click labels 0 / 1 float32."""
    V, F = V or CTR_V, F or CTR_F
    return {"ids": rng.randint(0, V, (B, F, 1)).astype(np.int64),
            "label": rng.randint(0, 2, (B, 1)).astype(np.float32)}


def ctr_throughput(exe, scope, main, cost, feed, B):
    """bench.py's _train_throughput: CTR_WARM steps, one with the loss's
    fetch, then CTR_REPEATS x CTR_STEPS steps, each repeat fetching only
    on its last step: (examples/s median, low, high, the losses)."""
    for _ in range(CTR_WARM):
        exe.run(main, feed=feed, fetch_list=[], scope=scope)
    losses = [float(exe.run(main, feed=feed, fetch_list=[cost],
                            scope=scope)[0][0])]
    rates = []
    for _ in range(CTR_REPEATS):
        t0 = time.perf_counter()
        for _ in range(CTR_STEPS - 1):
            exe.run(main, feed=feed, fetch_list=[], scope=scope)
        losses.append(float(exe.run(main, feed=feed, fetch_list=[cost],
                                    scope=scope)[0][0]))
        rates.append(B * CTR_STEPS / (time.perf_counter() - t0))
    return (*median_lo_hi(rates), losses)


# what torch's sync debug mode warns at each sync (its one-time notice
# that the mode is a prototype names "synchronizing" too, so it is not
# matched by that word alone)
SYNC_WARNING = "called a synchronizing CUDA operation"


def call_syncs(fn):
    """The device -> host syncs of one call of fn, counted by torch's
    sync debug mode (each sync warns once)."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum(SYNC_WARNING in str(w.message) for w in seen)


def ctr_step_syncs(exe, main, feed, scope):
    """The syncs of one step with no fetch (call_syncs; the feed's copies
    from pageable host memory count too)."""
    return call_syncs(lambda: exe.run(main, feed=feed, fetch_list=[],
                                      scope=scope))


def ctr_dispatch(exe, main, feed, scope):
    """One step with the monitor on: (dense_dispatch, selected_rows)
    counts of that step."""
    monitor.reset()
    monitor.set_enabled(True)
    try:
        exe.run(main, feed=feed, fetch_list=[], scope=scope)
        c = monitor.snapshot().get("counters", {})
    finally:
        monitor.set_enabled(False)
        monitor.reset()
    return (int(c.get("sparse.dense_dispatch", 0)),
            int(c.get("sparse.selected_rows", 0)))


def ctr_profile(exe, main, feed, cost, scope, step_ms, trace_dir=None):
    """One step under deviceprof.profile_program: device ms, busy share
    against `step_ms`, device kernels a step, the top op types."""
    rep = monitor.deviceprof.profile_program(main, feed, [cost.name], scope,
                                             exe, steps=1, warmup=0,
                                             trace_dir=trace_dir)
    device_ms = rep["total_us"] / 1e3
    by_type = {}
    for r in rep["rows"]:
        by_type[r["op_type"]] = by_type.get(r["op_type"], 0.0) \
            + (r["device_time_us"] or 0.0) / 1e3
    top = dict(sorted(((k, round(v, 3)) for k, v in by_type.items()),
                      key=lambda kv: -kv[1])[:6])
    launches = int(sum(k["events_per_step"]
                       for k in rep["kernels"].values()))
    return {"device_ms": device_ms, "busy": device_ms / step_ms,
            "kernels_per_step": launches, "mode": rep["mode"],
            "top_op_types_ms": top}


def ctr_losses_fall(losses, what):
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"{what}: losses not finite and falling: "
                             f"{losses}")


def ctr_run(model, B, mode, smi, untouched=False, guard=False):
    """One cell of phase 31: `model` at bench.py's config, B, `mode`;
    returns (launch counts, results). `untouched`: also phase 32 (c),
    lazy Adam's untouched rows bitwise equal after the run; `guard`:
    CTR_GUARD_STEPS more steps under the NaN guard, timed."""
    torch.cuda.empty_cache()
    flags.set_flag("sparse_grad", mode)
    main, startup, cost, _ = ctr_program(model)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    feed = ctr_feed(np.random.RandomState(SEED), B)
    tables = [n for n in scope.vars if n.endswith("_emb")]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()                       # the main path starts here
    med, lo, hi, losses = ctr_throughput(exe, scope, main, cost, feed, B)
    counts = read_counts()              # the main path ends here
    peak = torch.cuda.max_memory_allocated()
    what = f"CTR {model} B {B} {mode}"
    check_counts(counts, launches_of(), f"{what} (no TPU kernel on this "
                 "path)")
    ctr_losses_fall(losses, what)
    step_ms = 1e3 * B / med
    dense, sparse = ctr_dispatch(exe, main, feed, scope)
    syncs = ctr_step_syncs(exe, main, feed, scope)
    prof = ctr_profile(exe, main, feed, cost, scope, step_ms)
    out = {"examples_per_s": med, "lo": lo, "hi": hi, "step_ms": step_ms,
           "losses": losses, "peak_gib": peak / 2**30,
           "dense_dispatch_per_step": dense,
           "selected_rows_per_step": sparse, "syncs_per_step": syncs,
           **prof}
    log(f"{what}: {med:.1f} examples/s median ({lo:.1f}-{hi:.1f}, "
        f"{CTR_REPEATS} x {CTR_STEPS} steps after {CTR_WARM + 1}), step "
        f"{step_ms:.2f} ms, device {prof['device_ms']:.2f} ms (busy "
        f"{prof['busy']:.3f}), {prof['kernels_per_step']} kernels a step, "
        f"{syncs} syncs a step (no fetch), peak {peak / 2**30:.2f} GiB, "
        f"dispatch dense {dense} / selected_rows {sparse} a step; losses "
        f"{[round(x, 5) for x in losses]}; device ms by op type "
        f"{prof['top_op_types_ms']} | {smi}")
    if mode == "auto" and (dense, sparse) != (2, 0):
        raise AssertionError(f"{what}: auto did not take the dense path at "
                             f"this size (dense {dense}, selected_rows "
                             f"{sparse} a step)")
    if mode == "selected_rows" and (dense, sparse) != (0, 2):
        raise AssertionError(f"{what}: dispatch dense {dense}, "
                             f"selected_rows {sparse} a step")
    if untouched:
        # the tables as the startup program made them: its generator
        # draws the same values again from the program's seed
        start = pt.Scope()
        exe.run(startup, scope=start)
        start = {n: start.get(n) for n in tables}
        touched = torch.zeros(CTR_V, dtype=torch.bool, device="cuda")
        touched[torch.from_numpy(feed["ids"]).reshape(-1).cuda()] = True
        for n in tables:
            same = torch.equal(scope.get(n)[~touched], start[n][~touched])
            moved = bool((scope.get(n)[touched] != start[n][touched])
                         .any(dim=-1).all())
            if not (same and moved):
                raise AssertionError(f"{what}: lazy Adam: untouched rows of "
                                     f"{n} bitwise {same}, every touched "
                                     f"row moved {moved}")
        out["untouched_rows"] = int((~touched).sum())
        log(f"{what}: lazy Adam left the {out['untouched_rows']} untouched "
            f"rows of {tables} bitwise equal; every looked-up row moved | "
            f"{smi}")
        del start
    if guard:
        flags.set_flag("check_nan_inf", True)
        try:
            walls = []
            for _ in range(CTR_GUARD_STEPS):
                t0 = time.perf_counter()
                exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
                walls.append(1e3 * (time.perf_counter() - t0))
        finally:
            flags.set_flag("check_nan_inf", False)
        walls_off = []
        for _ in range(CTR_GUARD_STEPS):
            t0 = time.perf_counter()
            exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
            walls_off.append(1e3 * (time.perf_counter() - t0))
        out["guard_step_ms"] = median_lo_hi(walls)
        out["unguarded_step_ms"] = median_lo_hi(walls_off)
        log(f"{what}: NaN guard on {out['guard_step_ms'][0]:.2f} ms a step "
            f"(fetching the loss; {out['guard_step_ms'][1]:.2f}-"
            f"{out['guard_step_ms'][2]:.2f}) against "
            f"{out['unguarded_step_ms'][0]:.2f} off | {smi}")
    del scope, exe
    torch.cuda.empty_cache()
    flags.set_flag("sparse_grad", "auto")
    return counts, out


def ctr_hostfed(smi):
    """Phase 31's host-fed row (bench.py's run_hostfed): B 4096 under
    the default `auto` through the DeviceFeeder with the port's defaults
    over a pool of three host batches, 2 warm-up then CTR_STEPS steps
    each fetching the loss: examples/s and the feeder's counters."""
    from paddle_tpu_torch.reader import DeviceFeeder
    B = max(CTR_BATCHES)
    torch.cuda.empty_cache()
    main, startup, cost, _ = ctr_program("wide_deep")
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(SEED)
    pool = [ctr_feed(rng, B) for _ in range(3)]

    def reader():
        i = 0
        while True:
            yield pool[i % len(pool)]
            i += 1

    feeder = DeviceFeeder(reader, main, exe)
    it = iter(feeder)
    for _ in range(2):
        exe.run(main, feed=next(it), fetch_list=[cost], scope=scope)
    losses = []
    zero_counts()                       # the main path starts here
    t0 = time.perf_counter()
    for _ in range(CTR_STEPS):
        losses.append(float(exe.run(main, feed=next(it), fetch_list=[cost],
                                    scope=scope)[0][0]))
    rate = B * CTR_STEPS / (time.perf_counter() - t0)
    counts = read_counts()              # the main path ends here
    it.close()
    stats = feeder.stats()
    check_counts(counts, launches_of(), "CTR host-fed (no TPU kernel on "
                 "this path)")
    ctr_losses_fall(losses, "CTR host-fed")
    log(f"CTR wide_deep B {B} auto host-fed (DeviceFeeder, defaults): "
        f"{rate:.1f} examples/s over {CTR_STEPS} steps; losses "
        f"{[round(x, 5) for x in losses]}; feed {stats} | {smi}")
    del scope, exe, feeder
    torch.cuda.empty_cache()
    return counts, {"examples_per_s": rate, "losses": losses,
                    "feed": stats}


def ctr_train_phase(smi):
    """Phase 31: bench.py's bench_ctr_sparse on the card (wide&deep,
    10M x 32 and 10M x 1 tables, 26 fields, Adam 1e-3) at B 512 and
    4096 under each sparse_grad mode: examples/s (median, low, high),
    step ms, device ms and busy share of a profiled step, peak memory,
    device kernels and syncs a step, the dispatch counters (auto must
    take the dense path here), losses finite and falling; bench.py's
    auto_vs_best_forced; the host-fed row; DeepFM at B 4096 under
    selected_rows. The selected_rows B 4096 cell also checks phase 32
    (c) and times CTR_GUARD_STEPS steps under the NaN guard."""
    paths, out = {}, {}
    for B in CTR_BATCHES:
        row = {}
        for mode in CTR_MODES:
            big_sparse = B == max(CTR_BATCHES) and mode == "selected_rows"
            counts, row[mode] = ctr_run("wide_deep", B, mode, smi,
                                        untouched=big_sparse,
                                        guard=big_sparse)
            paths[f"ctr_wide_deep_B{B}_{mode}"] = counts
        best = max(row["selected_rows"]["examples_per_s"],
                   row["dense"]["examples_per_s"])
        row["auto_vs_best_forced"] = row["auto"]["examples_per_s"] / best
        log(f"CTR wide_deep B {B}: auto_vs_best_forced "
            f"{row['auto_vs_best_forced']:.3f} (auto "
            f"{row['auto']['examples_per_s']:.1f}, selected_rows "
            f"{row['selected_rows']['examples_per_s']:.1f}, dense "
            f"{row['dense']['examples_per_s']:.1f} examples/s) | {smi}")
        out[f"B{B}"] = row
    counts, out[f"B{max(CTR_BATCHES)}_hostfed"] = ctr_hostfed(smi)
    paths["ctr_hostfed"] = counts
    counts, out["deepfm"] = ctr_run("deepfm", max(CTR_BATCHES),
                                    "selected_rows", smi)
    paths["ctr_deepfm"] = counts
    return paths, out


def ctr_err(got, ref):
    """max |got - ref| / max |ref| of two tensors, or of two
    SelectedRows (rows equal, else inf; then the larger of the values'
    and the merged sums' errors)."""
    from paddle_tpu_torch.selected_rows import is_selected_rows, merge_rows
    if not is_selected_rows(ref):
        return max_rel(got, ref)
    if not torch.equal(got.rows.cpu(), ref.rows.cpu()):
        return float("inf")
    (gu, gs), (ru, rs) = merge_rows(got.to("cuda")), merge_rows(ref)
    if not torch.equal(gu.cpu(), ru):
        return float("inf")
    return max(ctr_err(got.values.cpu(), ref.values),
               ctr_err(gs.cpu(), rs))


def ctr_parity_phase(smi):
    """Phase 32 (a): both CTR programs at vocab CTR_PAR_V, CTR_PAR_F
    fields, embedding CTR_PAR_EMB, hidden CTR_PAR_HID, B CTR_PAR_B with a
    dense input of 4, under selected_rows, two Adam steps: each step run
    on the CPU, then every op lowered on the card on the CPU's values of
    its inputs; every output, the SelectedRows gradients' rows (equal),
    values and merged sums included, within CTR_PAR_TOL of its largest
    element."""
    flags.set_flag("sparse_grad", "selected_rows")
    out = {}
    try:
        for model in ("wide_deep", "deepfm"):
            main, startup, cost, _ = ctr_program(
                model, opt=pt.AdamOptimizer(1e-2), dense_input=True,
                width=(CTR_PAR_V, CTR_PAR_F, CTR_PAR_EMB, (CTR_PAR_HID,)))
            scope = pt.Scope()
            pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
            rng = np.random.RandomState(SEED + 40)
            feed = ctr_feed(rng, CTR_PAR_B, CTR_PAR_V, CTR_PAR_F)
            feed["dense"] = rng.rand(CTR_PAR_B, 4).astype(np.float32)
            block = main.global_block()
            worst, n_out, n_sparse = {}, 0, 0
            for step in (1, 2):
                errs, pairs = op_by_op_step(
                    main, feed, scope, f"CTR {model}, step {step}",
                    CTR_PAR_TOL, ctr_err)
                n_out += len(errs)
                n_sparse += sum(hasattr(r, "rows") for _, r in pairs.values())
                k = max(errs, key=errs.get)
                worst[step] = (k, errs[k])
            log(f"CTR {model} (vocab {CTR_PAR_V}, {CTR_PAR_F} fields, emb "
                f"{CTR_PAR_EMB}, hidden {CTR_PAR_HID}, B {CTR_PAR_B}, dense "
                f"4) selected_rows op by op on the card on the CPU's inputs:"
                f" {n_out} outputs of {len(block.ops)} ops over 2 Adam steps"
                f" ({n_sparse} SelectedRows), worst {worst} of the largest "
                f"element (tolerance {CTR_PAR_TOL:g}) | {smi}")
            out[model] = {"outputs": n_out, "selected_rows": n_sparse,
                          "ops": len(block.ops),
                          "worst": {str(k): v for k, v in worst.items()}}
    finally:
        flags.set_flag("sparse_grad", "auto")
    return out


def ctr_steps(mode, opt, feeds, init=None):
    """wide&deep at phase 31's config under `mode`: the startup
    program's state (or a copy of `init`), one step per feed; (losses,
    the state before, the state after)."""
    flags.set_flag("sparse_grad", mode)
    main, startup, cost, _ = ctr_program("wide_deep", opt=opt)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    if init is not None:
        for n, t in init.items():
            scope.set(n, t.clone())
    start = tensors_of(scope) if init is None else None
    losses = [float(exe.run(main, feed=f, fetch_list=[cost],
                            scope=scope)[0][0]) for f in feeds]
    flags.set_flag("sparse_grad", "auto")
    return losses, start, {n: t for n, t in scope.vars.items()
                           if isinstance(t, torch.Tensor)}


def ctr_card_checks_phase(smi):
    """Phase 32 (b) and (d) at phase 31's config, B 4096, three batches:
    (b) selected_rows against dense under SGD (lr CTR_SGD_LR) from one
    initialisation, losses and every parameter within rtol CTR_SGD_RTOL,
    atol CTR_SGD_ATOL (tests/test_sparse.py's tolerance); (d) two
    selected_rows Adam runs from one seed, every state tensor bitwise
    equal."""
    torch.cuda.empty_cache()
    rng = np.random.RandomState(SEED + 41)
    feeds = [ctr_feed(rng, max(CTR_BATCHES)) for _ in range(3)]
    sgd = lambda: pt.SGDOptimizer(CTR_SGD_LR)   # noqa: E731
    d_losses, init, dense = ctr_steps("dense", sgd(), feeds)
    s_losses, _, sparse = ctr_steps("selected_rows", sgd(), feeds, init)
    del init
    worst = {}
    for n, t in dense.items():
        diff = (sparse[n] - t).abs()
        worst[n] = float(diff.max())
        if not torch.allclose(sparse[n], t, rtol=CTR_SGD_RTOL,
                              atol=CTR_SGD_ATOL):
            raise AssertionError(f"CTR (b): {n} under selected_rows differs "
                                 f"from dense by {worst[n]:.3e}")
    if not np.allclose(s_losses, d_losses, rtol=CTR_SGD_RTOL,
                       atol=CTR_SGD_ATOL):
        raise AssertionError(f"CTR (b): losses {s_losses} against {d_losses}")
    log(f"CTR (b) wide_deep B {max(CTR_BATCHES)} SGD({CTR_SGD_LR}) 3 steps: "
        f"selected_rows against dense within rtol {CTR_SGD_RTOL:g} atol "
        f"{CTR_SGD_ATOL:g}; largest differences {worst}; losses "
        f"{s_losses} / {d_losses} | {smi}")
    del dense, sparse
    torch.cuda.empty_cache()
    adam = lambda: pt.AdamOptimizer(CTR_LR)   # noqa: E731
    a_losses, _, a = ctr_steps("selected_rows", adam(), feeds)
    a = {n: t.clone() for n, t in a.items()}
    b_losses, _, b = ctr_steps("selected_rows", adam(), feeds)
    same = all(torch.equal(t, b[n]) for n, t in a.items())
    log(f"CTR (d) two selected_rows Adam runs of 3 steps from one seed: "
        f"{len(a)} state tensors bitwise equal {same}; losses {a_losses} / "
        f"{b_losses} | {smi}")
    if not same or a_losses != b_losses:
        raise AssertionError("CTR (d): two selected_rows runs from one seed "
                             "differ")
    del a, b
    torch.cuda.empty_cache()
    return {"sgd_max_abs_diff": worst, "sgd_losses": [s_losses, d_losses],
            "repeat_bitwise": same}


def ctr_auc_phase(smi):
    """Phase 33 (a): InGraphAuc (CTR_AUC_BUCKETS buckets) over
    sigmoid(logit) of wide&deep at phase 31's config under
    selected_rows, accumulated in the training step over phase 31's
    host-fed batches and its throughput batch: the histograms equal a
    numpy histogram of the fetched scores (bucket floor(clip(s) * n) in
    float32) exactly; the AUC within CTR_AUC_TOL of the host Auc's."""
    torch.cuda.empty_cache()
    flags.set_flag("sparse_grad", "selected_rows")
    main, startup, cost, auc = ctr_program("wide_deep", with_auc=True)
    score = next(op.input("X")[0] for op in main.global_block().ops
                 if op.type == "clip")
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(SEED)
    B = max(CTR_BATCHES)
    feeds = [ctr_feed(rng, B) for _ in range(3)]
    feeds.append(ctr_feed(np.random.RandomState(SEED), B))
    host = pt.evaluator.Auc(num_thresholds=CTR_AUC_BUCKETS)
    want = np.zeros((2, CTR_AUC_BUCKETS + 1), np.float64)
    zero_counts()                       # the main path starts here
    for f in feeds:
        s, = exe.run(main, feed=f, fetch_list=[score], scope=scope)
        host.update(s, f["label"])
        idx = np.floor(np.clip(s, 0, 1) * np.float32(CTR_AUC_BUCKETS))
        np.add.at(want, (1 - f["label"].astype(np.int64).ravel(),
                         idx.astype(np.int64).ravel()), 1)
    counts = read_counts()              # the main path ends here
    flags.set_flag("sparse_grad", "auto")
    check_counts(counts, launches_of(), "CTR InGraphAuc (no TPU kernel on "
                 "this path)")
    pos, neg = (scope.get(v.name).cpu().numpy() for v in auc.states)
    got = auc.eval(exe, scope)
    exact = bool((pos == want[0]).all() and (neg == want[1]).all())
    log(f"CTR InGraphAuc over {len(feeds)} batches of {B}: histograms equal "
        f"numpy's exactly {exact} ({int(pos.sum())} positives, "
        f"{int(neg.sum())} negatives); AUC {got:.7f} against the host Auc's "
        f"{host.eval():.7f} (tolerance {CTR_AUC_TOL:g}) | {smi}")
    if not exact or abs(got - host.eval()) > CTR_AUC_TOL:
        raise AssertionError("CTR InGraphAuc differs from numpy / host Auc")
    del scope, exe
    torch.cuda.empty_cache()
    return counts, {"auc": got, "host_auc": host.eval(),
                    "histograms_exact": exact,
                    "examples": int(pos.sum() + neg.sum())}


def mnist_accuracy_phase(smi):
    """Phase 33 (b): the book's MLP MNIST (tests/test_book_models.py:34's
    synthetic digits: 64 x 784 from numpy seed 1234, label = argmax of
    |x[:, :10]|), Adam 1e-2, MNIST_STEPS steps on the card with an
    InGraphAccuracy: the loss falls below a fifth, the last batch's
    accuracy exceeds 0.9, the in-graph correct / total equal the sum of
    the batches' counts exactly."""
    pt.framework.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        img = pt.layers.data("img", [784])
        label = pt.layers.data("label", [1], dtype="int64")
        probs = pt.models.mnist.mlp(img)
        cost = pt.layers.mean(pt.layers.cross_entropy(probs, label))
        acc = pt.evaluator.InGraphAccuracy(input=probs, label=label)
        pt.AdamOptimizer(learning_rate=1e-2).minimize(cost)
    rng = np.random.RandomState(1234)
    x = rng.randn(64, 784).astype(np.float32)
    y = (np.abs(x[:, :10]).argmax(axis=1)).astype(np.int64)[:, None]
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    losses, n_correct = [], 0
    zero_counts()                       # the main path starts here
    for _ in range(MNIST_STEPS):
        loss, a = exe.run(main, feed={"img": x, "label": y},
                          fetch_list=[cost, acc.batch_accuracy], scope=scope)
        losses.append(float(loss[0]))
        n_correct += int(round(float(a[0]) * 64))
    counts = read_counts()              # the main path ends here
    check_counts(counts, launches_of(), "MLP MNIST (no TPU kernel on this "
                 "path)")
    correct, total = (float(scope.get(v.name)[0]) for v in acc.states)
    value = acc.eval(exe, scope)
    log(f"MLP MNIST on the card, {MNIST_STEPS} Adam steps: loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, last batch accuracy "
        f"{float(a[0]):.4f}; InGraphAccuracy {value:.6f} = {correct:.0f} / "
        f"{total:.0f} (the batches' counts sum to {n_correct}) | {smi}")
    if not (losses[-1] < 0.2 * losses[0] and float(a[0]) > 0.9
            and correct == n_correct and total == 64 * MNIST_STEPS):
        raise AssertionError("MLP MNIST with InGraphAccuracy failed")
    return counts, {"losses": [losses[0], losses[-1]],
                    "accuracy": float(a[0]), "ingraph_accuracy": value,
                    "correct": correct, "total": total}


def ctr_phase(smi):
    """Phases 31-33."""
    t0 = time.perf_counter()
    paths, train = ctr_train_phase(smi)
    parity = ctr_parity_phase(smi)
    checks = ctr_card_checks_phase(smi)
    paths["ctr_ingraph_auc"], auc = ctr_auc_phase(smi)
    paths["mnist_mlp"], mnist = mnist_accuracy_phase(smi)
    log(f"CTR: phases 31-33 in {time.perf_counter() - t0:.1f} s | {smi}")
    return paths, {"training": train, "op_by_op": parity,
                   "card_checks": checks, "ingraph_auc": auc,
                   "mnist_mlp": mnist}


# -- phases 34-36: control flow, OCR (CTC) and SRL (CRF) ----------------------

# phase 34 (a): a While-RNN against the simple_rnn op (x [T, B, D])
CF_T, CF_B, CF_D = 64, 64, 512
CF_RTOL = 1e-5
# phase 34 (b): an IfElse row-wise merge at B 4096, width 512
IE_B, IE_D, IE_TOL = 4096, 512, 1e-5
# phase 34 (c): recurrent_group with simple_rnn's cell (memory 512, a
# StaticInput bias), B 64, T CF_T; then RG_STEPS Adam steps
RG_TOL, RG_STEPS, RG_LR = 1e-5, 20, 1e-3
CF_TIMED = 5
# phase 35: models.ocr.crnn_ctc_cost at its own widths (conv 16 / 32,
# hidden 96, future_context 2) on 1 x 32 x 256 images (T 64), 95 classes
# plus the blank, B 128, labels of 5-20 ids; Adam 5e-3, OCR_STEPS steps
OCR_B, OCR_H, OCR_W, OCR_CLASSES = 128, 32, 256, 95
OCR_LABELS, OCR_LR, OCR_STEPS = (5, 20), 5e-3, 200
# step 1 on the card against the same program on the CPU from the same
# state: the loss within 1e-5 relative, each gradient within
# SEQ_CPU_TOL of its largest element (f32 with TF32 off; the conv and
# CTC sums in other orders); op by op, each op on the CPU's values of
# its inputs, within SEQ_CPU_TOL too
SEQ_CPU_TOL = 1e-4
# run free, the SRL network's relu candidates (8 LSTMs x 64 steps) move
# a few gradients by more (ROADMAP C11's kink): a control, the same
# network with tanh candidates, is held to SEQ_CPU_TOL run free; the
# relu network's free run to SRL_FREE_TOL of each gradient's largest
# element (its reading on an H100 80GB HBM3 at 700 W: 7.63e-4), and op
# by op to SEQ_CPU_TOL
SRL_FREE_TOL = 2e-3
# phase 36: the book's db_lstm + CRF (label_semantic_roles): word_dim 32,
# mark_dim 5, hidden 512, depth 8; the vocabularies of
# paddle_tpu/dataset/conll05.py's synthetic dicts (5000 words, 3000
# predicates, 59 labels); B 64, lengths 8-64, Adam 1e-3, SRL_STEPS steps
SRL_WORDS, SRL_PREDS, SRL_LABELS, SRL_MARKS = 5000, 3000, 59, 2
SRL_WORD_DIM, SRL_MARK_DIM, SRL_HIDDEN, SRL_DEPTH = 32, 5, 512, 8
SRL_B, SRL_LENS, SRL_LR, SRL_STEPS = 64, (8, 64), 1e-3, 20
SRL_TIE = 1e-5        # a decoded path may differ only at a near tie


def whole_profile(exe, main, feed, cost, scope, step_ms, what, smi,
                  tries=3):
    """ctr_profile of one step from a capture that kept its device
    events: every kernel launch call that the capture's host side
    recorded (runtime or driver, matched by its correlation id) must
    have its kernel among the device events. A capture that lost one is
    taken again, up to `tries` times; if none is whole, device ms, busy
    and the top op types are None (not measured). `host_launches`
    counts every launch, copy and set call, against the device events
    of `kernels_per_step`."""
    for n in range(1, tries + 1):
        tdir = tempfile.mkdtemp(prefix="chip_smoke_prof_")
        try:
            prof = ctr_profile(exe, main, feed, cost, scope, step_ms, tdir)
            events = monitor.deviceprof.load_trace_events(
                os.path.join(tdir, "step0.trace.json")) or []
        finally:
            shutil.rmtree(tdir, ignore_errors=True)
        launched = sum(
            str(e.get("cat", "")).lower() in ("cuda_runtime", "cuda_driver")
            and any(k in str(e.get("name", ""))
                    for k in ("Launch", "Memcpy", "Memset"))
            for e in events)
        calls = sorted(((e.get("ts", 0), (e.get("args") or {}).get(
            "correlation")) for e in events
            if str(e.get("cat", "")).lower() in ("cuda_runtime",
                                                  "cuda_driver")
            and "LaunchKernel" in str(e.get("name", ""))),
            key=lambda tc: float(tc[0]))
        called = {c for _, c in calls}
        ran = {(e.get("args") or {}).get("correlation") for e in events
               if str(e.get("cat", "")).lower() == "kernel"}
        lost = len(called - ran)
        prof.update(host_launches=launched, captures=n,
                    kernel_launches=len(called), kernels_lost=lost)
        if called and lost == 0:
            return prof
        # where in the step's launch order the lost kernels sat (C30)
        at = [i for i, (_, c) in enumerate(calls) if c not in ran]
        log(f"{what}: profile {n} kept {prof['kernels_per_step']} device "
            f"events of {launched} launched, lost {lost} of "
            f"{len(called)} kernels, at launches {at[:3]}..{at[-3:]} of "
            f"{len(calls)} | {smi}")
    prof.update(device_ms=None, busy=None, top_op_types_ms=None)
    return prof


def step_costs(exe, main, feed, cost, scope, walls, what, smi):
    """What a step costs on the card: the median wall of `walls`, one
    profiled step's device ms and busy share (whole_profile), the
    device -> host syncs of a step (torch's sync debug mode) and the
    While conditions read on the host (the monitor's
    control_flow.host_syncs)."""
    med, lo, hi = median_lo_hi(walls)
    prof = whole_profile(exe, main, feed, cost, scope, med, what, smi)
    syncs = ctr_step_syncs(exe, main, feed, scope)
    monitor.reset()
    monitor.set_enabled(True)
    try:
        exe.run(main, feed=feed, fetch_list=[], scope=scope)
        cond_reads = int(monitor.snapshot().get("counters", {}).get(
            "control_flow.host_syncs", 0))
    finally:
        monitor.set_enabled(False)
        monitor.reset()
    device = ("not measured" if prof["device_ms"] is None else
              f"{prof['device_ms']:.2f} ms (busy {prof['busy']:.3f})")
    log(f"{what}: step {med:.2f} ms median ({lo:.2f}-{hi:.2f}), device "
        f"{device}, {prof['kernels_per_step']} kernels a step of "
        f"{prof['host_launches']} launched, {syncs} syncs a step "
        f"({cond_reads} While conditions read on the host); top ops "
        f"{prof['top_op_types_ms']} | {smi}")
    return {"step_ms": med, "step_ms_lo": lo, "step_ms_hi": hi,
            "device_ms": prof["device_ms"], "busy": prof["busy"],
            "kernels_per_step": prof["kernels_per_step"],
            "host_launches_per_step": prof["host_launches"],
            "profile_captures": prof["captures"],
            "syncs_per_step": syncs, "while_host_reads": cond_reads,
            "top_op_types_ms": prof["top_op_types_ms"]}


def while_rnn_phase(smi):
    """Phase 34 (a): a While-RNN (array_read over x [T, B, D], matmul,
    tanh, assign, increment, less_than) and the simple_rnn op on one
    weight, f32 with TF32 off: the final states within CF_RTOL of the
    largest element."""
    cf = pt.layers.control_flow
    T, B, D = CF_T, CF_B, CF_D
    rng = np.random.RandomState(SEED + 40)
    w = torch.from_numpy((rng.uniform(-1, 1, (D, D)) / np.sqrt(D)).astype(
        np.float32)).cuda()
    xd = rng.randn(B, T, D).astype(np.float32)
    feed = {"x": xd, "x@SEQLEN": np.full((B,), T, np.int32)}
    pt.framework.reset_default_programs()
    main_w, start_w = pt.Program(), pt.Program()
    with pt.program_guard(main_w, start_w):
        x = pt.layers.data("x", [D], lod_level=1)
        w_p = pt.layers.create_parameter([D, D], name="w_rnn")
        x_tbd = pt.layers.transpose(x, [1, 0, 2])          # [T, B, D]
        h = pt.layers.fill_constant([B, D], "float32", 0.0)
        i = pt.layers.fill_constant([1], "int64", 0)
        n = pt.layers.fill_constant([1], "int64", T)
        cond = pt.layers.less_than(i, n)
        loop = cf.While(cond)
        with loop.block():
            x_t = cf.array_read(x_tbd, i)
            pt.layers.assign(pt.layers.tanh(x_t + pt.layers.matmul(h, w_p)),
                             output=h)
            pt.layers.increment(i)
            pt.layers.less_than(i, n, cond=cond)
    main_s, start_s = pt.Program(), pt.Program()
    with pt.program_guard(main_s, start_s):
        x = pt.layers.data("x", [D], lod_level=1)
        hidden = pt.layers.simple_rnn(x, D, act="tanh",
                                      param_attr=pt.ParamAttr(name="w_rnn"))
    exe, scope = pt.Executor(), pt.Scope()
    scope.set("w_rnn", w)
    zero_counts()                       # the main path starts here
    h_w, = exe.run(main_w, feed=feed, fetch_list=[h], scope=scope,
                   return_numpy=False)
    walls = timed_steps(exe, main_w, feed, h, scope, 0, CF_TIMED)[1]
    counts = read_counts()              # the main path ends here
    check_counts(counts, launches_of(), "While-RNN (no TPU kernel on this "
                 "path)")
    hid, = exe.run(main_s, feed=feed, fetch_list=[hidden], scope=scope,
                   return_numpy=False)
    err = max_rel(h_w, hid[:, -1])
    log(f"While-RNN T {T} B {B} D {D} (f32, TF32 off) against simple_rnn on "
        f"one weight: final state within {err:.2e} of its largest element "
        f"(tol {CF_RTOL:g}) | {smi}")
    if not err <= CF_RTOL:
        raise AssertionError(f"While-RNN differs from simple_rnn by {err}")
    costs = step_costs(exe, main_w, feed, h, scope, walls,
                       f"While-RNN T {T} B {B} D {D}", smi)
    if costs["while_host_reads"] != T + 1:
        raise AssertionError(f"While-RNN read its condition "
                             f"{costs['while_host_reads']} times, not {T + 1}")
    return counts, {"T": T, "B": B, "D": D, "max_rel_err": err, **costs}


def ifelse_phase(smi):
    """Phase 34 (b): an IfElse row-wise merge, tanh(x W) on the rows
    whose condition holds and 0.5 x W on the others, at B IE_B and width
    IE_D, with the gradient of W through both branches: the merged rows
    and dW against a plain torch recompute, within IE_TOL of each
    largest element."""
    cf = pt.layers.control_flow
    rng = np.random.RandomState(SEED + 41)
    xd = rng.randn(IE_B, IE_D).astype(np.float32)
    cd = rng.rand(IE_B, 1) < 0.5
    w = torch.from_numpy((rng.uniform(-1, 1, (IE_D, IE_D))
                          / np.sqrt(IE_D)).astype(np.float32)).cuda()
    pt.framework.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", [IE_D])
        c = pt.layers.data("c", [1], dtype="bool")
        w_p = pt.layers.create_parameter([IE_D, IE_D], name="ie_w")
        ie = cf.IfElse(c)
        with ie.true_block():
            ie.output(pt.layers.tanh(pt.layers.matmul(ie.input(x), w_p)))
        with ie.false_block():
            ie.output(pt.layers.matmul(ie.input(x), w_p) * 0.5)
        out, = ie()
        loss = pt.layers.mean(out)
        (_p, grad), = pt.backward.append_backward(loss)
    exe, scope = pt.Executor(), pt.Scope()
    scope.set("ie_w", w)
    feed = {"x": xd, "c": cd}
    zero_counts()                       # the main path starts here
    out_v, g_v = exe.run(main, feed=feed, fetch_list=[out, grad],
                         scope=scope, return_numpy=False)
    walls = timed_steps(exe, main, feed, loss, scope, 0, CF_TIMED)[1]
    counts = read_counts()              # the main path ends here
    check_counts(counts, launches_of(), "IfElse (no TPU kernel on this path)")
    wr = w.clone().requires_grad_()
    xw = torch.from_numpy(xd).cuda() @ wr
    ref = torch.where(torch.from_numpy(cd).cuda(), torch.tanh(xw), xw * 0.5)
    g_ref, = torch.autograd.grad(ref.mean(), wr)
    errs = {"out": max_rel(out_v, ref.detach()), "dW": max_rel(g_v, g_ref)}
    log(f"IfElse B {IE_B} width {IE_D}: merged rows and dW against the plain "
        f"recompute {errs} of the largest element (tol {IE_TOL:g}) | {smi}")
    if not max(errs.values()) <= IE_TOL:
        raise AssertionError(f"IfElse differs from the plain recompute: "
                             f"{errs}")
    costs = step_costs(exe, main, feed, loss, scope, walls,
                       f"IfElse B {IE_B} width {IE_D} with dW", smi)
    return counts, {"B": IE_B, "width": IE_D, "max_rel_err": errs, **costs}


def rg_cell(w, D):
    """simple_rnn's cell as a recurrent_group step over (x_t, a bias):
    h = tanh(x_t + b + h @ W), the memory "rg_h" of width D."""
    def step(y, bias):
        mem = pt.layers.memory(name="rg_h", size=D)
        return pt.layers.tanh(y + bias + pt.layers.matmul(mem, w),
                              name="rg_h")
    return step


def rnn_group_programs(T, B, D):
    """[(main, output, loss, params_grads)] of a recurrent_group whose
    step is simple_rnn's cell, h = tanh(x_t + b + h @ W) (a memory of D,
    the bias a StaticInput), then of the simple_rnn op over x + b, with
    the same parameters by name; each loss the mean of its output."""
    pt.framework.reset_default_programs()
    progs = []
    for group in (True, False):
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup):
            x = pt.layers.data("x", [D], lod_level=1)
            b = pt.layers.create_parameter([D], name="rg_b")
            if group:
                w = pt.layers.create_parameter([D, D], name="rg_w")
                out = pt.layers.recurrent_group(
                    step=rg_cell(w, D),
                    input=[x, pt.layers.StaticInput(b)])
            else:
                xb = pt.layers.elementwise_add(x, b)
                out = pt.layers.simple_rnn(xb, D, act="tanh",
                                           param_attr=pt.ParamAttr("rg_w"))
            loss = pt.layers.mean(out)
            pg = pt.backward.append_backward(loss)
        progs.append((main, out, loss, pg))
    return progs


def rnn_group_phase(smi):
    """Phase 34 (c): the recurrent_group of `rnn_group_programs` against
    the simple_rnn op: outputs and the gradients of W and b within
    RG_TOL of each largest element; then the group trains RG_STEPS Adam
    steps towards a fixed target and the loss falls."""
    T, B, D = CF_T, CF_B, CF_D
    rng = np.random.RandomState(SEED + 42)
    params = {"rg_w": (rng.uniform(-1, 1, (D, D)) / np.sqrt(D)).astype(
        np.float32),
              "rg_b": rng.uniform(-.1, .1, (D,)).astype(np.float32)}
    feed = {"x": rng.randn(B, T, D).astype(np.float32),
            "x@SEQLEN": np.full((B,), T, np.int32)}
    (gmain, gout, gloss, gpg), (smain, sout, _sloss, spg) = \
        rnn_group_programs(T, B, D)
    exe = pt.Executor()
    scope = scope_from_numpy(params)
    zero_counts()                       # the main path starts here
    got = exe.run(gmain, feed=feed, fetch_list=[gout] + [g for _, g in gpg],
                  scope=scope, return_numpy=False)
    walls = timed_steps(exe, gmain, feed, gloss, scope, 0, CF_TIMED)[1]
    counts = read_counts()
    ref = exe.run(smain, feed=feed, fetch_list=[sout] + [g for _, g in spg],
                  scope=scope, return_numpy=False)
    names = ["out"] + [p.name for p, _ in gpg]
    ref_by = dict(zip(["out"] + [p.name for p, _ in spg], ref))
    errs = {n: max_rel(g, ref_by[n]) for n, g in zip(names, got)}
    log(f"recurrent_group (simple_rnn's cell, memory {D}, StaticInput bias) "
        f"T {T} B {B}: output and gradients against the simple_rnn op {errs} "
        f"of the largest element (tol {RG_TOL:g}) | {smi}")
    if sorted(errs) != ["out", "rg_b", "rg_w"] or \
            not max(errs.values()) <= RG_TOL:
        raise AssertionError(f"recurrent_group differs from simple_rnn: "
                             f"{errs}")
    costs = step_costs(exe, gmain, feed, gloss, scope, walls,
                       f"recurrent_group forward + backward T {T} B {B} D "
                       f"{D}", smi)
    # training: mean squared error to a fixed target, Adam
    pt.framework.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", [D], lod_level=1)
        target = pt.layers.data("target", [D], lod_level=1)
        b = pt.layers.create_parameter([D], name="rg_b")
        w = pt.layers.create_parameter([D, D], name="rg_w")
        out = pt.layers.recurrent_group(step=rg_cell(w, D),
                                        input=[x, pt.layers.StaticInput(b)])
        cost = pt.layers.mean(pt.layers.square_error_cost(out, target))
        pt.AdamOptimizer(RG_LR).minimize(cost)
    scope = pt.Scope()
    exe.run(startup, scope=scope)              # the Adam state
    for k, v in params.items():
        scope.set(k, torch.from_numpy(v).cuda())
    zero_counts()                       # the main path starts again here
    tfeed = dict(feed, target=rng.uniform(-.5, .5, (B, T, D)).astype(
        np.float32), **{"target@SEQLEN": feed["x@SEQLEN"]})
    losses, twalls = timed_steps(exe, main, tfeed, cost, scope, 0, RG_STEPS)
    counts = {k: counts[k] + v for k, v in read_counts().items()}
    check_counts(counts, launches_of(), "recurrent_group (no TPU kernel on "
                 "this path)")
    tmed = float(np.median(twalls[1:]))
    log(f"recurrent_group training T {T} B {B} D {D}, Adam {RG_LR:g}, "
        f"{RG_STEPS} steps: loss {losses[0]:.5f} -> {losses[-1]:.5f}, step "
        f"{tmed:.2f} ms median | {smi}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"recurrent_group training: losses {losses}")
    return counts, {"T": T, "B": B, "D": D, "max_rel_err": errs,
                    "forward_backward": costs,
                    "train_losses": [losses[0], losses[-1]],
                    "train_step_ms": tmed}


def control_flow_phase(smi):
    """Phase 34 (a)-(c)."""
    paths, res = {}, {}
    paths["control_flow_while_rnn"], res["while_rnn"] = while_rnn_phase(smi)
    paths["control_flow_ifelse"], res["ifelse"] = ifelse_phase(smi)
    paths["control_flow_recurrent_group"], res["recurrent_group"] = \
        rnn_group_phase(smi)
    return paths, res


def first_step_against_cpu(exe, main, feed, fetch, n_grads, scope, what,
                           smi, tol=SEQ_CPU_TOL):
    """Step 1 on the card and the same program on the CPU from the same
    state: the loss (fetch[0]) within 1e-5 relative and each of the
    `n_grads` gradients after it within `tol` of its largest element.
    Returns (the card's fetches, the CPU's, the worst gradient, the
    state before the step on the CPU)."""
    state = scope_of(tensors_of(scope), "cpu")
    card = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                   return_numpy=False)
    cpu = pt.Executor(pt.CPUPlace()).run(main, feed=feed, fetch_list=fetch,
                                         scope=scope_of(state.vars, "cpu"),
                                         return_numpy=False)
    loss_err = max_rel(card[0], cpu[0])
    names = [v if isinstance(v, str) else v.name
             for v in fetch[1:1 + n_grads]]
    errs = {n: max_rel(c, r) for n, c, r in zip(names, card[1:], cpu[1:])}
    top = sorted(errs.items(), key=lambda kv: -kv[1])[:4]
    c, r = (t.double().cpu() for t in (card[1 + names.index(top[0][0])],
                                       cpu[1 + names.index(top[0][0])]))
    at = np.unravel_index(int((c - r).abs().argmax()), tuple(r.shape))
    log(f"{what} step 1 on the card against the CPU: loss "
        f"{float(card[0].reshape(-1)[0]):.6f} vs "
        f"{float(cpu[0].reshape(-1)[0]):.6f} ({loss_err:.2e} relative, tol "
        f"1e-5); the worst of {len(errs)} gradients "
        f"{[(n, f'{e:.2e}') for n, e in top]} of their largest elements "
        f"(tol {tol:g}), the first at {tuple(int(i) for i in at)}: "
        f"{float(c[at]):.6g} vs {float(r[at]):.6g}, largest "
        f"{float(r.abs().max()):.6g} | {smi}")
    if not (loss_err <= 1e-5 and top[0][1] <= tol):
        raise AssertionError(f"{what}: step 1 differs from the CPU")
    return card, cpu, (top[0][0], top[0][1], loss_err), state


def ocr_feed(rng):
    """B images 1 x H x W of uniform noise, valid widths 160-256 (a
    multiple of 4), labels of OCR_LABELS ids in [1, OCR_CLASSES] with
    repeats (each id repeats its predecessor with probability 0.25)."""
    B = OCR_B
    widths = 4 * rng.randint(40, OCR_W // 4 + 1, B)
    lens = rng.randint(OCR_LABELS[0], OCR_LABELS[1] + 1, B)
    lab = np.zeros((B, OCR_LABELS[1]), np.int64)
    for b, n in enumerate(lens):
        ids = rng.randint(1, OCR_CLASSES + 1, n)
        rep = rng.rand(n) < 0.25
        for t in range(1, n):
            if rep[t]:
                ids[t] = ids[t - 1]
        lab[b, :n] = ids
    return {"img": rng.rand(B, 1, OCR_H, OCR_W).astype(np.float32),
            "lens": widths.astype(np.int32), "lab": lab,
            "lab@SEQLEN": lens.astype(np.int32)}


def levenshtein(a, b):
    row = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        prev, row[0] = row[0], i
        for j, y in enumerate(b, 1):
            prev, row[j] = row[j], min(row[j] + 1, row[j - 1] + 1,
                                       prev + (x != y))
    return row[-1]


def ocr_decode_check(exe, test, fetch, feed, scope, what, smi):
    """The test clone's greedy decode on the card (ctc_greedy_decoder,
    ctc_align, edit_distance) held exactly against numpy on the card's
    own logits: each row's argmax over its length (first maximum),
    repeats merged, blanks (0) dropped; its ids, its length and its edit
    distance to the label. Returns (EditDistance's mean distance and
    sequence error rate, the decoded tokens)."""
    logits, lg_len, ids, out_len, dist = exe.run(test, feed=feed,
                                                 fetch_list=fetch, scope=scope)
    bad = []
    for b in range(logits.shape[0]):
        a = np.argmax(logits[b, :lg_len[b]], -1)
        keep = np.ones(len(a), bool)
        keep[1:] = a[1:] != a[:-1]
        want = a[keep & (a != 0)]
        got = ids[b, :out_len[b]]
        lab = feed["lab"][b, :feed["lab@SEQLEN"][b]]
        if not (out_len[b] == len(want) and np.array_equal(got, want)
                and float(np.ravel(dist[b])[0]) == levenshtein(
                    want.tolist(), lab.tolist())):
            bad.append(b)
    ed = pt.evaluator.EditDistance()
    ed.update(dist)
    mean_d, err_rate = ed.eval()
    tokens = int(np.sum(out_len))
    log(f"{what} on the card against numpy on its logits: {tokens} "
        f"tokens decoded in {logits.shape[0]} rows, {len(bad)} rows differ "
        f"(ids, lengths or edit distances; exact); mean edit distance "
        f"{mean_d:.4f}, sequence error rate {err_rate:.4f} | {smi}")
    if bad:
        raise AssertionError(f"{what}: rows {bad[:8]} differ from numpy")
    return mean_d, err_rate, tokens


def ocr_phase(smi):
    """Phase 35: models.ocr.crnn_ctc_cost (conv 16 / 32, hidden 96,
    future_context 2) on 1 x 32 x 256 images, T 64, 95 classes + blank,
    B 128, f32 Adam 5e-3 on one fixed batch for OCR_STEPS steps: step 1
    against the CPU, the loss below half of step 1's; the greedy decode
    at the initial state and after training held to numpy
    (ocr_decode_check)."""
    rng = np.random.RandomState(SEED + 43)
    feed = ocr_feed(rng)
    pt.framework.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        img = pt.layers.data("img", [1, OCR_H, OCR_W])
        lens = pt.layers.data("lens", [OCR_B], dtype="int32",
                              append_batch_size=False)
        lab = pt.layers.data("lab", [], dtype="int64", lod_level=1)
        cost, logits = pt.models.ocr.crnn_ctc_cost(
            img, lab, num_classes=OCR_CLASSES, image_lens=lens)
        test = main.clone(for_test=True)
        _, pg = pt.AdamOptimizer(OCR_LR).minimize(cost)
    # the decode and its edit distance run in the test clone only
    with pt.program_guard(test, pt.Program()):
        blk = test.global_block()
        decoded = pt.layers.ctc_greedy_decoder(blk.var(logits.name), blank=0)
        dist, _ = pt.layers.edit_distance(decoded, blk.var("lab"),
                                          normalized=False)
    decode = [logits.name, logits.seq_len_var, decoded.name,
              decoded.seq_len_var, dist.name]
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    init_tokens = ocr_decode_check(exe, test, decode, feed, scope,
                                   "OCR greedy decode at the initial state",
                                   smi)[2]
    if not init_tokens:
        raise AssertionError("OCR: the initial decode gave no token to check")
    zero_counts()                       # the main path starts here
    card, _cpu, worst, _state = first_step_against_cpu(
        exe, main, feed, [cost] + [g for _, g in pg], len(pg), scope,
        f"OCR CRNN-CTC B {OCR_B}", smi)
    losses, walls = timed_steps(exe, main, feed, cost, scope, 0,
                                OCR_STEPS - 1)
    counts = read_counts()              # the main path ends here
    check_counts(counts, launches_of(), "OCR CRNN-CTC (no TPU kernel on "
                 "this path)")
    first = float(card[0].reshape(-1)[0])
    mean_d, err_rate, tokens = ocr_decode_check(
        exe, test, decode, feed, scope,
        f"OCR greedy decode after {OCR_STEPS} steps", smi)
    med = float(np.median(walls))
    log(f"OCR CRNN-CTC B {OCR_B} 1x{OCR_H}x{OCR_W} (T {OCR_W // 4}), "
        f"{OCR_CLASSES} classes + blank, Adam {OCR_LR:g}: loss {first:.4f} "
        f"-> {losses[-1]:.4f} in {OCR_STEPS} steps; {OCR_B / (med / 1e3):.1f}"
        f" examples/s (step {med:.2f} ms median); greedy decode: mean edit "
        f"distance {mean_d:.4f} to labels of mean length "
        f"{feed['lab@SEQLEN'].mean():.2f}, sequence error rate "
        f"{err_rate:.4f} | {smi}")
    if not (np.isfinite(losses).all() and losses[-1] < 0.5 * first):
        raise AssertionError(f"OCR: the loss did not fall below half of "
                             f"step 1's: {first} -> {losses[-1]}")
    costs = step_costs(exe, main, feed, cost, scope, walls,
                       f"OCR CRNN-CTC B {OCR_B} training step", smi)
    return counts, {"B": OCR_B, "T": OCR_W // 4, "classes": OCR_CLASSES,
                    "examples_per_s": OCR_B / (med / 1e3),
                    "losses": [first, losses[-1]],
                    "step1_worst_grad": worst[:2],
                    "step1_loss_rel_err": worst[2],
                    "mean_edit_distance": mean_d,
                    "sequence_error_rate": err_rate,
                    "decoded_tokens": {"initial": init_tokens,
                                       "trained": tokens}, **costs}


SRL_CTX = ("word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1", "ctx_p2")


def srl_program(candidate="relu"):
    """The book's label_semantic_roles db_lstm + CRF: the six word-context
    embeddings (one table) with the predicate's and the mark's, summed
    through fc into `hidden`, SRL_DEPTH LSTMs in alternating directions
    (`candidate` their candidate activation, the book's relu), each fed
    by fc of the previous hidden and LSTM outputs, fc to the tags,
    linear_chain_crf; crf_decoding and an InGraphChunkEvaluator over the
    decoded tags. Returns (main, startup, cost, params_grads, decode,
    emission, chunk evaluator)."""
    pt.framework.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        ins = [pt.layers.data(n, [1], dtype="int64", lod_level=1)
               for n in SRL_CTX + ("verb", "mark", "target")]
        embs = [pt.layers.embedding(w, size=[SRL_WORDS, SRL_WORD_DIM],
                                    param_attr=pt.ParamAttr(name="emb"))
                for w in ins[:6]]
        embs.append(pt.layers.embedding(ins[6],
                                        size=[SRL_PREDS, SRL_WORD_DIM]))
        embs.append(pt.layers.embedding(ins[7],
                                        size=[SRL_MARKS, SRL_MARK_DIM]))
        hidden = pt.layers.fc(input=embs, size=SRL_HIDDEN, act="tanh")
        lstm = None
        for i in range(SRL_DEPTH):
            if i:
                hidden = pt.layers.fc(input=[hidden, lstm], size=SRL_HIDDEN,
                                      act="tanh")
            lstm, _ = pt.layers.dynamic_lstm(
                hidden, size=SRL_HIDDEN, candidate_activation=candidate,
                gate_activation="sigmoid", cell_activation="sigmoid",
                is_reverse=bool(i % 2))
        emission = pt.layers.fc(input=[hidden, lstm], size=SRL_LABELS)
        crf = pt.layers.linear_chain_crf(emission, ins[8],
                                         param_attr=pt.ParamAttr("crfw"))
        cost = pt.layers.mean(crf)
        decode = pt.layers.crf_decoding(emission, pt.ParamAttr("crfw"))
        chunk = pt.evaluator.InGraphChunkEvaluator(
            decode, ins[8], num_chunk_types=(SRL_LABELS - 1) // 2)
        _, pg = pt.AdamOptimizer(SRL_LR).minimize(cost)
    return main, startup, cost, pg, decode, emission, chunk


def srl_feed(rng):
    """conll05's synthetic sentences: lengths SRL_LENS, word and context
    ids in [3, words), one predicate id a sentence, a mark of 1 at one
    position, labels uniform over the 59 tags."""
    B, T = SRL_B, SRL_LENS[1]
    lens = rng.randint(SRL_LENS[0], SRL_LENS[1] + 1, B).astype(np.int32)
    lens[0] = T
    valid = (np.arange(T)[None, :] < lens[:, None])[..., None]
    feed = {}
    for n in SRL_CTX:
        feed[n] = rng.randint(3, SRL_WORDS, (B, T, 1)) * valid
    feed["verb"] = np.repeat(rng.randint(3, SRL_PREDS, (B, 1, 1)), T, 1) \
        * valid
    mark = np.zeros((B, T, 1), np.int64)
    mark[np.arange(B), rng.randint(0, lens), 0] = 1
    feed["mark"] = mark
    feed["target"] = rng.randint(0, SRL_LABELS, (B, T, 1)) * valid
    for n in SRL_CTX + ("verb", "mark", "target"):
        feed[n] = feed[n].astype(np.int64)
        feed[n + "@SEQLEN"] = lens
    return feed, lens


def viterbi_score(em, trans, path):
    """The CRF score of one tag path (float64)."""
    start, end, w = trans[0], trans[1], trans[2:]
    s = start[path[0]] + em[0, path[0]] + end[path[-1]]
    for t in range(1, len(path)):
        s += w[path[t - 1], path[t]] + em[t, path[t]]
    return float(s)


def srl_phase(smi):
    """Phase 36: `srl_program` at the book's widths, B SRL_B, lengths
    SRL_LENS, Adam SRL_LR for SRL_STEPS steps: step 1 (loss, gradients
    and the Viterbi paths) against the CPU, the paths equal but at a
    near tie; the loss falls; the in-graph chunk counts equal the host
    ChunkEvaluator's on the decoded tags exactly. Then, outside the
    counted run, step 1 op by op on the card and the tanh-candidate
    control's step 1 against the CPU."""
    rng = np.random.RandomState(SEED + 44)
    feed, lens = srl_feed(rng)
    main, startup, cost, pg, decode, emission, chunk = srl_program()
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    trans0 = scope.get("crfw").double().cpu().numpy()
    host = pt.evaluator.ChunkEvaluator((SRL_LABELS - 1) // 2)
    target = feed["target"][..., 0]

    def count(path):
        for b in range(SRL_B):
            host.update(path[b, :lens[b]], target[b, :lens[b]])

    zero_counts()                       # the main path starts here
    card, cpu, worst, state = first_step_against_cpu(
        exe, main, feed, [cost] + [g for _, g in pg] + [decode, emission],
        len(pg), scope, f"SRL db_lstm + CRF B {SRL_B}", smi, SRL_FREE_TOL)
    path_card, path_cpu = card[-2].cpu().numpy(), cpu[-2].numpy()
    count(path_card)
    em_cpu = cpu[-1].double().numpy()
    rows = [b for b in range(SRL_B)
            if not np.array_equal(path_card[b], path_cpu[b])]
    ties = []
    for b in rows:
        n = lens[b]
        sa = viterbi_score(em_cpu[b, :n], trans0, path_card[b, :n])
        sb = viterbi_score(em_cpu[b, :n], trans0, path_cpu[b, :n])
        ties.append(abs(sa - sb) / max(abs(sb), 1.0))
    if ties and max(ties) > SRL_TIE:
        raise AssertionError(f"SRL: Viterbi paths differ from the CPU's "
                             f"beyond a near tie: rows {rows}, gaps {ties}")
    losses, walls = [float(card[0].reshape(-1)[0])], []
    for _ in range(SRL_STEPS - 1):
        t0 = time.perf_counter()
        loss, path = exe.run(main, feed=feed, fetch_list=[cost, decode],
                             scope=scope)
        walls.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(loss[0]))
        count(path)
    counts = read_counts()              # the main path ends here
    check_counts(counts, launches_of(), "SRL db_lstm + CRF (no TPU kernel "
                 "on this path)")
    errs, _ = op_by_op_step(main, feed, state, f"SRL db_lstm + CRF B "
                            f"{SRL_B}", SEQ_CPU_TOL)
    op_worst = max(errs, key=errs.get)
    log(f"SRL db_lstm + CRF B {SRL_B} step 1 op by op on the card, on the "
        f"CPU's inputs: {len(errs)} outputs of {len(main.global_block().ops)}"
        f" ops, worst {op_worst} at {errs[op_worst]:.2e} of its largest "
        f"element (tol {SEQ_CPU_TOL:g}) | {smi}")
    # the control: tanh candidates, no kink; run free within SEQ_CPU_TOL
    main_t, startup_t, cost_t, pg_t = srl_program("tanh")[:4]
    scope_t = pt.Scope()
    exe.run(startup_t, scope=scope_t)
    control = first_step_against_cpu(
        exe, main_t, feed, [cost_t] + [g for _, g in pg_t], len(pg_t),
        scope_t, f"SRL control with tanh candidates B {SRL_B}", smi)[2]
    cor, inf, lab = (float(np.ravel(v)[0]) for v in exe.run(
        chunk.eval_program, fetch_list=chunk._fetches, scope=scope))
    med = float(np.median(walls))
    tokens_s = float(lens.sum()) / (med / 1e3)
    log(f"SRL db_lstm + CRF (word {SRL_WORD_DIM}, mark {SRL_MARK_DIM}, "
        f"hidden {SRL_HIDDEN}, depth {SRL_DEPTH}, {SRL_LABELS} tags) B "
        f"{SRL_B}, lengths {lens.min()}-{lens.max()}: loss {losses[0]:.4f} "
        f"-> {losses[-1]:.4f} in {SRL_STEPS} Adam steps; {tokens_s:.0f} "
        f"tokens/s (step {med:.2f} ms median); Viterbi paths on the card "
        f"vs the CPU: {len(rows)} of {SRL_B} rows differ, all at near ties "
        f"(gaps {ties}); in-graph chunk counts (correct, inferred, label) "
        f"{(cor, inf, lab)} vs the host's {(host.tp, host.inferred_chunks, host.label_chunks)}"
        f" | {smi}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"SRL: losses {losses}")
    if (cor, inf, lab) != (host.tp, host.inferred_chunks, host.label_chunks):
        raise AssertionError("SRL: in-graph chunk counts differ from the "
                             "host ChunkEvaluator's")
    costs = step_costs(exe, main, feed, cost, scope, walls,
                       f"SRL db_lstm + CRF B {SRL_B} training step", smi)
    return counts, {"B": SRL_B, "tokens": int(lens.sum()),
                    "tokens_per_s": tokens_s, "losses": [losses[0],
                                                         losses[-1]],
                    "step1_worst_grad": worst[:2],
                    "step1_loss_rel_err": worst[2],
                    "step1_op_by_op": {"outputs": len(errs),
                                       "worst": (op_worst, errs[op_worst])},
                    "tanh_control_worst_grad": control[:2],
                    "tanh_control_loss_rel_err": control[2],
                    "viterbi_rows_differing": len(rows),
                    "viterbi_tie_gaps": ties,
                    "chunk_counts": [cor, inf, lab], **costs}


def book_phase(smi):
    """Phases 34-36."""
    t0 = time.perf_counter()
    paths, cf = control_flow_phase(smi)
    paths["ocr_crnn_ctc"], ocr = ocr_phase(smi)
    paths["srl_db_lstm_crf"], srl = srl_phase(smi)
    log(f"control flow, OCR and SRL: phases 34-36 in "
        f"{time.perf_counter() - t0:.1f} s | {smi}")
    return paths, {"control_flow": cf, "ocr": ocr, "srl": srl}


# -- phases 37-38: the serving fleet ------------------------------------------

FLEET_NEW = 32                   # phase 37's tokens a request
FLEET_CLIENTS = 8                # phase 37's load and both phases' bench
FLEET_DEADLINE_MS = 120000       # generous: a failure must be a failover
FLEET_REQS = 4                   # phase 38's distinct request row sets
LM_BENCH_REQS = 400              # phase 37's timed requests a target
FLEET_BENCH_S = 10.0             # phase 38's timed window a target
# phase 38's int8 replicas sample their dispatches: the first is traced
# whole, so each replica's /debug/vars names the kernels it ran
FLEET_SAMPLE_N = 16
FLEET_UNREAD = ("phase 38's int8 replica processes: unread, a replica's "
                "launch counts are not in what it serves (ROADMAP C25); "
                "each replica's own sampled device trace names the kernel")


def gen_body(prompt, n_new, stream):
    return {"prompt": list(prompt), "max_new_tokens": n_new,
            "stream": stream, "deadline_ms": FLEET_DEADLINE_MS}


def pct_ms(values, q):
    return round(1e3 * float(np.percentile(values, q)), 3)


def fleet_counters():
    snap = monitor.snapshot()["counters"]
    return {k: int(v) for k, v in snap.items()
            if k.startswith(("fleet.", "autoscale."))}


def counter_deltas(before, names):
    now = fleet_counters()
    return {n: now.get(n, 0) - before.get(n, 0) for n in names}


def wait_for(cond, what, timeout=300.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError(f"fleet: timed out waiting for {what}")
        time.sleep(0.02)


def lm_bench(url, prompts, what, smi):
    """FLEET_CLIENTS closed-loop streaming clients, one request for each
    of `prompts`, through `url`: tokens/s, TTFT p50 / p99."""
    load = ClientLoad(
        lambda i, tid: generate(url, gen_body(prompts[i], FLEET_NEW, True),
                                tid),
        FLEET_CLIENTS, f"bench-{what}", cap=len(prompts))
    records = load.join()
    bad = [(r["i"], r.get("status"), r.get("error")) for r in records
           if r["outcome"] != "ok" or len(r["tokens"]) != FLEET_NEW]
    if bad:
        raise AssertionError(f"lm fleet bench {what}: failed {bad[:3]}")
    ttfts = [r["ttft"] for r in records]
    out = {"requests": len(records), "clients": FLEET_CLIENTS,
           "tokens_per_s": round(FLEET_NEW * len(records) / load.wall, 1),
           "ttft_p50_ms": pct_ms(ttfts, 50),
           "ttft_p99_ms": pct_ms(ttfts, 99), "wall_s": round(load.wall, 3)}
    log(f"lm fleet bench {what}: {out} | {smi}")
    return out


def lm_fleet_phase(smi):
    """Phase 37: a port FleetRouter over two GPT-2-small LM engines in
    process, each behind its own make_server(replica_id=...) and
    FleetRegistrar; slot-aware routing, tokens bitwise against a solo
    engine, K1's two kernels' launches through the graphs, a hard stop
    with requests in flight, and the router's cost."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    flags.set_flag("metrics", True)
    spec = LMSpec(VOCAB, HID, LAYERS, N_HEADS, TRAIN_T)
    weights = init_lm_weights(spec, seed=SEED)      # phase 4's weights
    cfg = GenerationConfig(max_slots=8, prefill_batch=4, max_prompt_len=256,
                           max_new_tokens=128, paged=True, page_len=16,
                           prefix_cache=True)
    router = FleetRouter(RouterConfig(probe_interval_s=0.25,
                                      breaker_threshold=2,
                                      breaker_cooldown_s=60.0))
    replicas = []
    try:
        for i in range(2):
            rid = f"lm-{i}"
            engine = GenerationEngine(spec, weights, config=cfg,
                                      ready=False)
            server = make_server(engine, port=0, replica_id=rid)
            threading.Thread(target=server.serve_forever,
                             daemon=True).start()
            url = local(server.server_address[1])
            reg = FleetRegistrar(router.url, rid, url, engine,
                                 ttl_s=5.0).start()
            rungs = engine.warmup()
            reg.notify()
            st = engine.stats()
            if st["aot_status"] != "cuda_graph" \
                    or st["aot_rungs"] != cfg.rung_keys():
                raise AssertionError(f"{rid}: rungs not all CUDA graphs: "
                                     f"{st['aot_status']} {rungs}")
            replicas.append({"rid": rid, "engine": engine,
                             "server": server, "url": url, "reg": reg})
        wait_for(lambda: all(router.replica_ready(r["rid"])
                             for r in replicas), "both LM replicas ready")
        rids = [r["rid"] for r in replicas]
        log(f"lm fleet: router {router.url} over {rids}, each GPT-2-small "
            f"{spec.to_meta()} with "
            f"{len(cfg.rung_keys())} CUDA-graph rungs; memory allocated "
            f"{torch.cuda.memory_allocated()} B")

        rng = np.random.RandomState(SEED + 7)
        prompts = [rng.randint(0, VOCAB, size=n).tolist()
                   for n in (200, 37, 120, 64, 90)]
        engines = [r["engine"] for r in replicas]
        before = [e.stats() for e in engines]
        zero_counts()                    # the main path starts here
        fa.gather_pages.calls = 0
        first = ClientLoad(
            lambda i, tid: generate(router.url,
                                    gen_body(prompts[i], FLEET_NEW, i < 4),
                                    tid), 5, "fleet", cap=5).join()
        again = generate(router.url, gen_body(prompts[1], FLEET_NEW, False),
                         "fleet-repeat")
        counts = read_counts()           # the main path ends here
        decodes = fa.flash_attn_fwd.decode_launches
        gathers = fa.gather_pages.calls
        results = {**{r["i"]: r for r in first}, "repeat": again}
        after = [e.stats() for e in engines]
        prefills = sum(a["prefills"] - b["prefills"]
                       for a, b in zip(after, before))
        steps = sum(a["decode_steps"] - b["decode_steps"]
                    for a, b in zip(after, before))
        served = {k: r.get("served_by") for k, r in results.items()}
        k1 = {"decode_kernel": decodes,
              "tq_gt_1_kernel": counts["flash_attn_fwd"] - decodes}
        log(f"lm fleet: 6 requests (4 streams, 1 buffered, 1 repeat) served "
            f"by {served}; {prefills} prefills + {steps} decode steps over "
            f"both engines; K1 launches {counts['flash_attn_fwd']} "
            f"{k1}, page gathers {gathers}")
        bad = {k: (r.get("status"), r.get("error")) for k, r in results.items()
               if r["outcome"] != "ok" or len(r["tokens"]) != FLEET_NEW
               or not r["trace_ok"]}
        if bad:
            raise AssertionError(f"lm fleet: failed requests {bad}")
        if set(served.values()) != {"lm-0", "lm-1"}:
            raise AssertionError(f"slot-aware routing used one replica: "
                                 f"{served}")
        check_counts(counts, launches_of(
            flash_attn_fwd=LAYERS * (prefills + steps)),
            f"lm fleet ({prefills} prefills + {steps} decode steps)")
        check_counts(k1, {"decode_kernel": LAYERS * steps,
                          "tq_gt_1_kernel": LAYERS * prefills},
                     "lm fleet, K1 by kernel (layers x decode steps, "
                     "layers x prefills)")
        check_counts({"page_gathers": gathers},
                     {"page_gathers": 2 * LAYERS * prefills},
                     "lm fleet (2 x layers x prefills: no decode step "
                     "gathers)")
        solo = {}
        for i, p in enumerate(prompts):
            solo[i] = engines[0].generate(np.array(p),
                                          max_new_tokens=FLEET_NEW,
                                          timeout=600)[0].tolist()
        for key, r in results.items():
            want = solo[1 if key == "repeat" else key]
            if r["tokens"] != want:
                raise AssertionError(f"lm fleet: request {key} served by "
                                     f"{r['served_by']} differs from the "
                                     f"solo engine:\n{r['tokens']}\n{want}")
        log("lm fleet: every routed reply's greedy tokens == the same "
            "prompt on one engine alone, bitwise")

        # a prompt set a target: a prompt served twice would hit the
        # prefix cache of the engine that served it first
        bench = {}
        for name, url in (("router", router.url),
                          ("direct", replicas[0]["url"])):
            bench[name] = lm_bench(
                url, [rng.randint(0, VOCAB, size=int(n)).tolist()
                      for n in rng.randint(32, 160, LM_BENCH_REQS)],
                name, smi)
        hop = {}
        for name, url in (("router", router.url),
                          ("direct", replicas[0]["url"])):
            ttfts = [generate(url, gen_body(
                rng.randint(0, VOCAB, size=64).tolist(), 1, True))["ttft"]
                for _ in range(32)]
            hop[name] = pct_ms(ttfts, 50)
        bench["router_added_ttft_ms"] = round(hop["router"]
                                              - hop["direct"], 3)
        bench["single_client_ttft_p50_ms"] = hop
        log(f"lm fleet: router's added TTFT (1 client, 32 sequential "
            f"1-token streams, p50) {bench['router_added_ttft_ms']} ms "
            f"{hop} | {smi}")

        # a hard stop of lm-1 with buffered requests in flight
        c0 = fleet_counters()
        victim = replicas[1]
        fail_prompts = [rng.randint(0, VOCAB, size=64).tolist()
                        for _ in range(FLEET_CLIENTS)]
        load = ClientLoad(
            lambda i, tid: generate(router.url,
                                    gen_body(fail_prompts[i], 128, False),
                                    tid),
            FLEET_CLIENTS, "fo", cap=FLEET_CLIENTS)
        wait_for(lambda: victim["engine"].stats()["live_slots"] > 0,
                 "a generation live on lm-1", timeout=120)
        victim["reg"].stop(deregister=False)       # it just dies
        victim["server"].shutdown()
        victim["server"].server_close()
        victim["engine"].shutdown(drain=False)
        fo = load.join()
        typed = {r["i"]: r["error_type"] for r in fo
                 if r["outcome"] == "typed"}
        raw = {r["i"]: (r.get("status"), r.get("error")) for r in fo
               if r["outcome"] == "raw"
               or (r["outcome"] == "ok" and len(r["tokens"]) != 128)}
        if raw:
            raise AssertionError(f"lm fleet failover: raw failures {raw}")
        for r in fo:
            if r["outcome"] == "ok":
                want = engines[0].generate(np.array(fail_prompts[r["i"]]),
                                           max_new_tokens=128,
                                           timeout=600)[0].tolist()
                if r["tokens"] != want:
                    raise AssertionError(f"lm fleet failover: {r['i']} "
                                         "differs from the survivor alone")
        d = counter_deltas(c0, ("fleet.requests", "fleet.hops",
                                "fleet.retries", "fleet.failovers",
                                "fleet.unavailable", "fleet.shed",
                                "fleet.deadline_exceeded"))
        want = {"fleet.requests": len(fo),
                "fleet.hops": sum(r["attempts"] for r in fo),
                "fleet.retries": sum(r["attempts"] - 1 for r in fo),
                "fleet.failovers": sum(1 for r in fo
                                       if r["outcome"] == "ok"
                                       and r["attempts"] > 1),
                "fleet.unavailable": sum(1 for t in typed.values()
                                         if t == "unavailable"),
                "fleet.shed": sum(1 for t in typed.values() if t == "shed"),
                "fleet.deadline_exceeded": sum(
                    1 for t in typed.values() if t == "deadline")}
        failover = {"requests": len(fo), "typed": typed, "counters": d,
                    "served_by": sorted({r["served_by"] for r in fo
                                         if r["outcome"] == "ok"})}
        log(f"lm fleet failover: lm-1 stopped hard with generations live; "
            f"{failover}")
        if d != want:
            raise AssertionError(f"lm fleet failover: counters {d} != what "
                                 f"the clients saw {want}")
        if want["fleet.failovers"] < 1:
            raise AssertionError("lm fleet failover: no request failed over "
                                 "(the stop was not mid-flight)")
    finally:
        router.shutdown()
        for r in replicas:
            r["reg"].stop(deregister=False)
            if not r["engine"].stats()["closed"]:
                r["server"].shutdown()
                r["server"].server_close()
                r["engine"].shutdown(drain=True, timeout=600)
    wall = time.perf_counter() - t_phase
    log(f"lm fleet: phase 37 in {wall:.1f} s | {smi}")
    return counts, {"served_by": served, "prefills": prefills,
                    "decode_steps": steps, "k1_launches":
                    counts["flash_attn_fwd"], "k1_by_kernel": k1,
                    "page_gathers": gathers, "bench": bench,
                    "failover": failover, "seconds": round(wall, 1)}


def infer_send(url, bodies, want):
    """A ClientLoad send: POST /v1/infer of request set i % len(bodies)
    through `url`. Its record: status, outcome ok / typed / raw, the
    x-trace-id echo, the replica, the hop count, Retry-After, latency,
    and which model's ids the reply equals ("f32", "int8" or None)."""
    def send(i, tid):
        k = i % len(bodies)
        t0 = time.monotonic()
        status, hdrs, body, _ = http_call(url, "/v1/infer", bodies[k],
                                          trace_id=tid)
        try:
            payload = json.loads(body)
        except ValueError:
            payload = {}
        rec = {"status": status, "latency": time.monotonic() - t0,
               "trace_ok": hdrs.get("x-trace-id") == tid,
               "served_by": hdrs.get("x-served-by"),
               "attempts": int(hdrs.get("x-fleet-attempts") or 1),
               "retry_after": hdrs.get("Retry-After"),
               "error_type": payload.get("error_type"),
               "outcome": outcome(status, payload.get("error_type"))}
        if rec["outcome"] == "ok":
            ids = np.asarray(payload["outputs"][0], np.int64)
            rec["match"] = next((m for m, w in want.items()
                                 if np.array_equal(ids, w[k])), None)
        elif rec["outcome"] == "raw":
            rec["error"] = str(payload or body[:300])[:300]
        return rec
    return send


def fleet_summary(records):
    typed = {}
    for r in records:
        if r["outcome"] == "typed":
            typed[r["error_type"]] = typed.get(r["error_type"], 0) + 1
    oks = [r for r in records if r["outcome"] == "ok"]
    return {"requests": len(records), "ok": len(oks),
            "raw": [r for r in records if r["outcome"] == "raw"],
            "typed": typed,
            "lost_trace": sum(1 for r in records if r["outcome"] != "raw"
                              and not r["trace_ok"]),
            "failovers": sum(1 for r in oks if r["attempts"] > 1),
            "served_by": sorted({r["served_by"] for r in oks}),
            "matches": {str(m): sum(1 for r in oks if r["match"] == m)
                        for m in {r["match"] for r in oks}}}


def card_used_mib():
    """The card's used memory, nvidia-smi's reading, MiB."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return int(out.split()[0])


def replica_vars(sup, router):
    """{rid: /debug/vars} of the supervisor's live replicas."""
    urls = {r["replica_id"]: r["url"] for r in router.status()["replicas"]}
    out = {}
    for rid, p in sup.procs().items():
        if p.poll() is None and rid in urls:
            _, _, body, _ = http_call(urls[rid], "/debug/vars")
            out[rid] = json.loads(body)
    return out


def replica_memory(sup, dvars):
    """{rid: memory} of the replicas whose /debug/vars are `dvars`:
    nvidia-smi's per-process used_memory (None where nvidia-smi lists no
    such PID, as in a sandbox with its own PID namespace) and the
    replica's own torch.cuda reserved and peak allocated bytes."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout
    by_pid = {}
    for line in out.splitlines():
        parts = [x.strip() for x in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit():
            by_pid[int(parts[0])] = parts[1]
    procs = sup.procs()
    mem = {}
    for rid, dv in dvars.items():
        dev = dv["device_memory"][0]
        mem[rid] = {"smi_mib": by_pid.get(procs[rid].pid),
                    "torch_reserved_b": dev.get("bytes_reserved"),
                    "torch_peak_b": dev.get("peak_bytes_in_use")}
    return mem


def replica_boots(sup, router):
    """Seconds from each slot's spawn to its readmission."""
    boots = {}
    while len(boots) < len(sup.slots):
        for slot in sup.slots:
            if slot["rid"] not in boots and router.replica_ready(slot["rid"]):
                boots[slot["rid"]] = round(time.monotonic()
                                           - slot["spawned_at"], 2)
        if time.monotonic() - min(s["spawned_at"] for s in sup.slots) > 300:
            raise TimeoutError(f"fleet: replicas not ready: {boots}")
        time.sleep(0.02)
    return boots


def fleet_bench(url, bodies, want, what, smi):
    """FLEET_CLIENTS closed-loop clients of SERVE_B-row requests through
    `url` for FLEET_BENCH_S seconds, every reply the f32 ids:
    requests/s over the window (the last replies included), latency
    p50 / p99."""
    load = ClientLoad(infer_send(url, bodies, want), FLEET_CLIENTS,
                      f"bench-{what.split()[0]}")
    time.sleep(FLEET_BENCH_S)
    records = load.finish()
    res = fleet_summary(records)
    if res["raw"] or res["typed"] or res["matches"] != {"f32": res["ok"]}:
        raise AssertionError(f"fleet bench {what}: raw {res['raw'][:3]}, "
                             f"typed {res['typed']}, {res['matches']}")
    lat = [r["latency"] for r in records]
    out = {"requests": len(records), "clients": FLEET_CLIENTS,
           "rows_per_request": SERVE_B, "window_s": round(load.wall, 3),
           "requests_per_s": round(len(records) / load.wall, 2),
           "p50_ms": pct_ms(lat, 50), "p99_ms": pct_ms(lat, 99)}
    log(f"fleet bench {what}: {out} | {smi}")
    return out


def logs_tail(tmp):
    for name in sorted(os.listdir(tmp)):
        if name.endswith(".log"):
            with open(os.path.join(tmp, name), errors="replace") as f:
                log(f"--- {name} (tail) ---\n{f.read()[-3000:]}")


def prepare_fleet_models(tmp):
    """Phase 10's GPT-2-small + argmax at T 1024 saved in f32 and
    quantized to int8, and each model's ids for FLEET_REQS request row
    sets of SERVE_B rows from Executor.run in this process."""
    main, startup, _, ids = build_gpt2_lm()
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    f32, int8 = os.path.join(tmp, "f32"), os.path.join(tmp, "int8")
    pt.io.save_inference_model(f32, ["tokens"], [ids], exe,
                               main_program=main, scope=scope)
    del scope
    quant.quantize_inference_model(f32, int8)
    rng = np.random.RandomState(SEED + 8)
    reqs = [rng.randint(0, VOCAB, (SERVE_B, TRAIN_T)).astype(np.int64)
            for _ in range(FLEET_REQS)]
    want = {}
    for name, d in (("f32", f32), ("int8", int8)):
        mscope = pt.Scope()
        prog, feeds, fetch = pt.io.load_inference_model(d, exe, scope=mscope)
        want[name] = [np.asarray(exe.run(prog, feed={"tokens": r},
                                          fetch_list=fetch,
                                          scope=mscope)[0], np.int64)
                      for r in reqs]
        del mscope
    torch.cuda.empty_cache()
    differ = sum(int((a != b).sum()) for a, b in zip(want["f32"],
                                                     want["int8"]))
    if not differ:
        raise AssertionError("fleet: the f32 and int8 ids are equal, the "
                             "swap check would prove nothing")
    bodies = [json.dumps({"feeds": {"tokens": r.tolist()},
                          "deadline_ms": FLEET_DEADLINE_MS}).encode()
              for r in reqs]
    return f32, int8, bodies, want, differ


def replica_kernels(dvars):
    """{rid: what the replica's own sampled device trace shows}: its
    dispatches, its sampler's captures, and whether the kernels of its
    last capture's top rows include K6 and the quantize kernel. The
    launches themselves are not read (ROADMAP C25)."""
    out = {}
    for rid, dv in dvars.items():
        dp = dv.get("deviceprof") or {}
        names = [r["op"] for r in dp.get("top_ops") or []]
        out[rid] = {"dispatches": dv["engine"]["batches"],
                    "sampled": dp.get("sampled"),
                    "captures": dp.get("captures"),
                    "int8_matmul_kernel_in_trace": any(
                        "int8_matmul_kernel" in n for n in names),
                    "quantize_rows_in_trace": any(
                        "quantize_rows" in n for n in names)}
    return out


def oneshot_fleet_phase(smi):
    """Phase 38: a supervised fleet of real `python -m paddle_tpu_torch
    serve --model_dir ... --fleet` replica processes on the card: (a)
    SIGKILL one, (b) a rolling swap f32 -> int8, (c) the autoscaler over
    a one-replica fleet."""
    t_phase = time.perf_counter()
    flags.set_flag("metrics", True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    report = {}
    sup = router = None
    try:
        t0 = time.perf_counter()
        f32, int8, bodies, want, differ = prepare_fleet_models(tmp)
        free, total = torch.cuda.mem_get_info()
        log(f"fleet: saved f32 and int8 models, {FLEET_REQS} request sets "
            f"of {SERVE_B} x {TRAIN_T} tokens, their ids from Executor.run "
            f"({differ} ids differ between f32 and int8) in "
            f"{time.perf_counter() - t0:.1f} s; card free {free} of {total} "
            f"B before spawning (a replica: weights "
            f"{os.path.getsize(os.path.join(f32, 'params.npz'))} B f32 + "
            f"rung-8 logits {SERVE_B * TRAIN_T * VOCAB * 4} B)")
        replica_args = (f"--max_batch_size={SERVE_B}", f"--buckets={SERVE_B}",
                        "--batch_timeout_ms=0")
        router = FleetRouter(RouterConfig(
            retry_budget=2, probe_interval_s=0.25, probe_timeout_s=2.0,
            probe_down_after=2, breaker_threshold=2, breaker_cooldown_s=4.0))
        # ttl 2 s + a boot of seconds keep the kill schedule ordered: the
        # killed replica's lease expires (one ejection) before its
        # replacement boots and registers again
        sup = ReplicaSupervisor(router, f32, 2, ttl_s=2.0,
                                replica_args=replica_args, log_dir=tmp,
                                restart_backoff_base_s=1.0,
                                ready_timeout_s=300.0)
        router.supervisor = sup
        used0 = card_used_mib()
        sup.start()
        boots = replica_boots(sup, router)
        mem = {"card_used_mib_before": used0,
               "card_used_mib_with_2": card_used_mib(),
               "replicas": replica_memory(sup, replica_vars(sup, router))}
        log(f"fleet: 2 f32 replicas ready, spawn to ready {boots} s; "
            f"memory {mem} | {smi}")
        report["boot_s"], report["memory"] = boots, {"f32": mem}

        # (a) SIGKILL one replica under load
        c0 = fleet_counters()
        load = ClientLoad(infer_send(router.url, bodies, want), 4, "kill")
        wait_for(lambda: load.oks() >= 8, "pre-kill traffic")
        old_url = next(r["url"] for r in router.status()["replicas"]
                       if r["replica_id"] == "replica-1")
        # what the respawned incarnation reports: it registers before
        # its warmup with ready False, and is routable only once ready
        reported = []
        register = router.register

        def recording_register(replica_id, url, *a, **kw):
            if replica_id == "replica-1" and url != old_url:
                reported.append(kw.get("ready"))
            return register(replica_id, url, *a, **kw)

        router.register = recording_register
        sup.procs()["replica-1"].kill()
        t_kill = time.monotonic()
        wait_for(lambda: counter_deltas(c0, ("fleet.restarts",))
                 ["fleet.restarts"] >= 1, "the supervisor's restart")
        wait_for(lambda: router.replica_ready("replica-1"),
                 "the restarted replica readmitted")
        router.register = register
        booting = reported[:1] == [False]
        t_back = time.monotonic()
        n0 = len(load.records)
        wait_for(lambda: load.served("replica-1", n0),
                 "the restarted replica serving")
        res = fleet_summary(load.finish())
        d = counter_deltas(c0, ("fleet.breaker_opens", "fleet.ejections",
                                "fleet.restarts", "fleet.registrations",
                                "fleet.failovers", "fleet.deregistrations"))
        kill = {**{k: v for k, v in res.items() if k != "raw"},
                "counters": d, "kill_to_readmit_s": round(t_back - t_kill, 2),
                "registered_booting": booting}
        log(f"fleet (a) kill: {kill}")
        if res["raw"] or res["typed"] or res["lost_trace"]:
            raise AssertionError(f"fleet (a): raw {res['raw'][:3]}, typed "
                                 f"{res['typed']}, lost trace ids "
                                 f"{res['lost_trace']}")
        if res["served_by"] != ["replica-0", "replica-1"] \
                or res["failovers"] < 1:
            raise AssertionError("fleet (a): the kill was not mid-flight "
                                 "or a replica never served")
        if res["matches"] != {"f32": res["ok"]}:
            raise AssertionError(f"fleet (a): replies not the f32 ids: "
                                 f"{res['matches']}")
        if not booting:
            raise AssertionError(f"fleet (a): the respawned replica did not "
                                 f"register as not ready before its warmup "
                                 f"(its registrations said {reported})")
        want_d = {"fleet.breaker_opens": 1, "fleet.ejections": 1,
                  "fleet.restarts": 1, "fleet.registrations": 1,
                  "fleet.failovers": res["failovers"],
                  "fleet.deregistrations": 0}
        if d != want_d:
            raise AssertionError(f"fleet (a): counters {d} != schedule "
                                 f"{want_d}")
        report["kill"] = kill

        # requests/s through the router against one replica directly
        wait_for(lambda: sup.wait_all_ready(timeout=0.1), "fleet ready")
        direct = next(r["url"] for r in router.status()["replicas"]
                      if r["replica_id"] == "replica-0")
        report["bench"] = {
            "router_2_replicas": fleet_bench(router.url, bodies, want,
                                             "router, 2 f32 replicas", smi),
            "direct_1_replica": fleet_bench(direct, bodies, want,
                                            "replica-0 directly", smi)}

        # (b) a rolling swap to the int8 model under load; the int8
        # replicas sample their dispatches (the f32 bench above ran
        # without a sampler)
        sup.replica_args.append(f"--set=profile_sample_n={FLEET_SAMPLE_N}")
        c0 = fleet_counters()
        load = ClientLoad(infer_send(router.url, bodies, want), 4, "swap")
        wait_for(lambda: load.oks() >= 8, "pre-swap traffic")
        t0 = time.monotonic()
        swap_report = sup.rolling_swap(artifact=int8)
        t_done = time.monotonic()
        n0 = len(load.records)
        # each int8 replica serves after the swap, so each has a trace
        wait_for(lambda: load.oks(n0) >= 8 and load.served("replica-0", n0)
                 and load.served("replica-1", n0), "traffic after the swap")
        records = load.finish()
        res = fleet_summary(records)
        after = [r for r in records if r["outcome"] == "ok"
                 and r["t"] >= t_done]
        d = counter_deltas(c0, ("fleet.swaps", "fleet.restarts",
                                "fleet.ejections", "fleet.registrations",
                                "fleet.deregistrations"))
        dvars = replica_vars(sup, router)
        mem = {"card_used_mib_with_2": card_used_mib(),
               "replicas": replica_memory(sup, dvars)}
        kernels = replica_kernels(dvars)
        swap = {**{k: v for k, v in res.items() if k != "raw"},
                "counters": d, "swap_s": round(t_done - t0, 2),
                "per_replica": swap_report, "after_swap": len(after),
                "int8_replicas": kernels, "int8_launches": FLEET_UNREAD}
        log(f"fleet (b) swap: {swap}; int8 replicas' memory {mem} | {smi}")
        if not all(s.get("ready") for s in swap_report):
            raise AssertionError(f"fleet (b): a swapped replica never came "
                                 f"back ready: {swap_report}")
        if res["raw"] or res["typed"] or res["lost_trace"]:
            raise AssertionError(f"fleet (b): raw {res['raw'][:3]}, typed "
                                 f"{res['typed']}, lost trace ids "
                                 f"{res['lost_trace']}")
        if None in [r["match"] for r in records if r["outcome"] == "ok"] \
                or any(r["match"] != "int8" for r in after) or not after:
            raise AssertionError(f"fleet (b): replies {res['matches']}; "
                                 f"after the swap not all int8 ids")
        want_d = {"fleet.swaps": 2, "fleet.restarts": 0,
                  "fleet.ejections": 0, "fleet.registrations": 2,
                  "fleet.deregistrations": 2}
        if d != want_d:
            raise AssertionError(f"fleet (b): counters {d} != schedule "
                                 f"{want_d}")
        if sorted(kernels) != ["replica-0", "replica-1"] or not all(
                k["int8_matmul_kernel_in_trace"]
                and k["quantize_rows_in_trace"] for k in kernels.values()):
            raise AssertionError(f"fleet (b): an int8 replica's own device "
                                 f"trace does not name K6 and the quantize "
                                 f"kernel: {kernels}")
        report["swap"] = swap
        report["memory"]["int8"] = mem
        sup.stop()
        router.shutdown()
        sup = router = None

        report["autoscale"] = autoscale_fleet(int8, bodies, want, tmp, smi)
    except Exception:
        logs_tail(tmp)
        raise
    finally:
        if sup is not None:
            sup.stop()
        if router is not None:
            router.shutdown()
    shutil.rmtree(tmp, ignore_errors=True)
    report["seconds"] = round(time.perf_counter() - t_phase, 1)
    log(f"fleet: phase 38 in {report['seconds']} s | {smi}")
    return report


def autoscale_fleet(int8, bodies, want, tmp, smi):
    """Phase 38 (c): the reactive autoscaler, min 1, max 2, over a fresh
    one-replica fleet of the int8 model: a 16-client ramp, a plateau,
    then a trickle through the drain."""
    router = FleetRouter(RouterConfig(
        retry_budget=2, probe_interval_s=0.25, probe_timeout_s=2.0,
        probe_down_after=2, breaker_threshold=2, breaker_cooldown_s=4.0,
        scrape_interval_s=0.25))
    sup = ReplicaSupervisor(router, int8, 1, ttl_s=6.0,
                            replica_args=(f"--max_batch_size={SERVE_B}",
                                          f"--buckets={SERVE_B}",
                                          "--batch_timeout_ms=0"),
                            log_dir=tmp, restart_backoff_base_s=0.5,
                            ready_timeout_s=300.0)
    router.supervisor = sup
    acfg = AutoscaleConfig(min_replicas=1, max_replicas=2, mode="reactive",
                           interval_s=0.4, signal_window_s=2.5,
                           queue_high=3.0, queue_low=2.0, up_for_s=1.2,
                           idle_rps=10.0, idle_for_s=2.0, up_cooldown_s=3.0,
                           down_cooldown_s=3.0)
    ctl = AutoscaleController(router, sup, acfg)
    router.autoscaler = ctl
    sup.start()
    try:
        wait_for(lambda: sup.wait_all_ready(timeout=0.1), "one replica")
        c0 = fleet_counters()
        t_wall0 = time.time()
        ctl.start()
        ramp = ClientLoad(infer_send(router.url, bodies, want), 16, "ramp")
        wait_for(lambda: counter_deltas(c0, ("autoscale.scale_ups",))
                 ["autoscale.scale_ups"] >= 1, "the scale-up")
        t_up = time.monotonic()
        wait_for(lambda: router.replica_ready("replica-1"),
                 "the added replica ready")
        n0 = len(ramp.records)
        wait_for(lambda: ramp.served("replica-1", n0),
                 "the added replica serving")
        t_serving = time.monotonic()
        p0 = counter_deltas(c0, ("autoscale.scale_ups",
                                 "autoscale.scale_downs", "autoscale.holds"))
        time.sleep(3.5)                  # the plateau
        p1 = counter_deltas(c0, ("autoscale.scale_ups",
                                 "autoscale.scale_downs", "autoscale.holds"))
        ramp_res = fleet_summary(ramp.finish())
        trickle = ClientLoad(infer_send(router.url, bodies, want), 1,
                             "quiesce", period_s=0.25)
        wait_for(lambda: counter_deltas(c0, ("autoscale.scale_downs",))
                 ["autoscale.scale_downs"] >= 1, "the scale-down")
        wait_for(lambda: sup.live_slots() == 1, "the drained slot leaving")
        n1 = len(trickle.records)
        wait_for(lambda: trickle.oks(n1) >= 5, "traffic after the drain")
        trickle_res = fleet_summary(trickle.finish())
        drained = fleet_summary(trickle.records[n1:])
        ctl.stop()
        # before the fleet stops: its own drain deregisters the survivor
        d = counter_deltas(c0, ("autoscale.scale_ups",
                                "autoscale.scale_downs",
                                "autoscale.backfills", "fleet.slots_added",
                                "fleet.slots_removed", "fleet.ejections",
                                "fleet.restarts", "fleet.deregistrations",
                                "fleet.replica_giveups"))
    finally:
        ctl.stop()
        sup.stop()
        router.shutdown()
    hist = list(ctl.history)
    timeline = [(round(e["t"] - t_wall0, 2), e["action"], e["reason"],
                 e["current"], e["target"]) for e in hist
                if e["action"] != "hold"]
    holds = {}
    for e in hist:
        if e["action"] == "hold":
            holds[e["reason"]] = holds.get(e["reason"], 0) + 1
    downs = [e for e in hist if e["action"] == "down"]
    out = {"counters": d, "ramp": {k: v for k, v in ramp_res.items()
                                   if k != "raw"},
           "plateau": {"before": p0, "after": p1},
           "trickle": {k: v for k, v in trickle_res.items() if k != "raw"},
           "scale_up_to_serving_s": round(t_serving - t_up, 2),
           "timeline": timeline, "holds_by_reason": holds,
           "drain": downs[0].get("actuation") if downs else None}
    log(f"fleet (c) autoscale: {out} | {smi}")
    if ramp_res["raw"] or ramp_res["lost_trace"] \
            or ramp_res["served_by"] != ["replica-0", "replica-1"]:
        raise AssertionError(f"fleet (c) ramp: raw {ramp_res['raw'][:3]}, "
                             f"served by {ramp_res['served_by']}")
    if not (p1["autoscale.scale_ups"] == p0["autoscale.scale_ups"] == 1
            and p1["autoscale.scale_downs"] == 0
            and p1["autoscale.holds"] > p0["autoscale.holds"]):
        raise AssertionError(f"fleet (c) plateau: {p0} -> {p1}")
    if trickle_res["raw"] or trickle_res["typed"] \
            or trickle_res["lost_trace"] \
            or drained["served_by"] != ["replica-0"]:
        raise AssertionError(f"fleet (c) quiesce: {trickle_res}, after the "
                             f"drain {drained['served_by']}")
    if len(downs) != 1 or not (downs[0]["actuation"] or {}).get("drained") \
            or downs[0]["actuation"].get("exit_code") != 0:
        raise AssertionError(f"fleet (c): not one clean drain: {downs}")
    for r in (ramp_res, trickle_res):
        if r["matches"] != {"int8": r["ok"]}:
            raise AssertionError(f"fleet (c): replies not the int8 ids: "
                                 f"{r['matches']}")
    want_d = {"autoscale.scale_ups": 1, "autoscale.scale_downs": 1,
              "autoscale.backfills": 0, "fleet.slots_added": 1,
              "fleet.slots_removed": 1, "fleet.ejections": 0,
              "fleet.restarts": 0, "fleet.deregistrations": 1,
              "fleet.replica_giveups": 0}
    if d != want_d:
        raise AssertionError(f"fleet (c): counters {d} != schedule {want_d}")
    return out


def fleet_phase(smi):
    """Phases 37-38."""
    t0 = time.perf_counter()
    lm_counts, lm = lm_fleet_phase(smi)
    oneshot = oneshot_fleet_phase(smi)
    log(f"serving fleet: phases 37-38 in {time.perf_counter() - t0:.1f} s "
        f"| {smi}")
    return {"serving_lm_fleet": lm_counts}, {"lm": lm, "oneshot": oneshot}


# -- phase 39: detection (SSD300 on VGG16) and the evaluators left -----------

# SSD300 (Liu et al., ECCV 2016): VGG16 conv1_1-conv5_3, fc6 / fc7 as
# convolutions, four extra pairs, conv4_3 l2-normalised, six maps
SSD_HW, SSD_C, SSD_G, SSD_PRIORS = 300, 21, 16, 8732
SSD_MIN = (30.0, 60.0, 111.0, 162.0, 213.0, 264.0)
SSD_MAX = (60.0, 111.0, 162.0, 213.0, 264.0, 315.0)
SSD_AR = ((2.0,), (2.0, 3.0), (2.0, 3.0), (2.0, 3.0), (2.0,), (2.0,))
SSD_MAPS = (38, 19, 10, 5, 3, 1)
# lr 1e-5, not the paper's 1e-3: ssd_loss sums each image's terms (no
# division by the matched count), step 1's loss is ~1850, and 1e-3 / 1e-4
# diverge to NaN within 2 / 25 steps on an H100 (3e-5, 1e-5, 3e-6 fall
# to 0.30 / 0.27 / 0.35 of step 1 in 50 steps)
SSD_B, SSD_CHECK_B, SSD_STEPS, SSD_LR = 32, 2, 50, 1e-5
SSD_FALL = 0.8          # the mean of the last 5 losses below this x step 1's
SSD_INFER_BATCHES = 4
SSD_NMS = {"nms_threshold": 0.45, "nms_top_k": 400, "keep_top_k": 200,
           "score_threshold": 0.01}
SSD_MAP_BUCKETS = 512
# (a): IoU and box codes within DET_TOL of each array's largest element;
# a row of an exact output may differ only where two of its candidates'
# scores or losses lie within DET_TIE (it is then excused and counted)
DET_TOL, DET_TIE = 1e-6, 1e-6
SSD_OP_TOL = 1e-4       # (b): each op on the CPU's values of its inputs
# (e): Fast R-CNN's roi_pool: VGG16 conv5_3 of a 600 x 1000 image
ROI_FEAT, ROI_IMAGE = (2, 512, 38, 63), (600, 1000)
ROI_PER_IMAGE, ROI_BINS, ROI_GRAD_TOL = 128, 7, 1e-6
PNPAIR_N, PNPAIR_Q, PR_N = 16384, 64, 4096


def ssd300_head(img):
    """SSD300 on VGG16 through the port's layers: 3x3 convs (pad 1, relu)
    and 2x2 / stride-2 max pools after stages 1-4 (pool3 in ceil_mode:
    300 -> 150 -> 75 -> 38 -> 19), pool5 3x3 / stride 1 / pad 1, fc6 a 3x3
    conv of 1024 with dilation 6, fc7 a 1x1 of 1024, the extra pairs (1x1
    of 256 / 128 / 128 / 128, then 3x3 of 512 / 256 / 256 / 256, stride 2
    pad 1 twice, pad 0 twice: 10, 5, 3, 1), conv4_3 l2-normalised times
    a learned [512] scale starting at 20, and multi_box_head over the six
    maps. Returns (loc, conf, priors, prior variances)."""
    L = pt.layers
    x = img
    for stage, (n, reps) in enumerate(((64, 2), (128, 2), (256, 3),
                                       (512, 3)), 1):
        for _ in range(reps):
            x = L.conv2d(x, n, 3, padding=1, act="relu")
        if stage == 4:
            conv4_3 = x
        x = L.pool2d(x, 2, "max", 2, ceil_mode=stage == 3)
    for _ in range(3):
        x = L.conv2d(x, 512, 3, padding=1, act="relu")
    x = L.pool2d(x, 3, "max", 1, pool_padding=1)
    x = L.conv2d(x, 1024, 3, padding=6, dilation=6, act="relu")    # fc6
    x = L.conv2d(x, 1024, 1, act="relu")                           # fc7
    maps = [x]
    for n1, n2, stride, pad in ((256, 512, 2, 1), (128, 256, 2, 1),
                                (128, 256, 1, 0), (128, 256, 1, 0)):
        x = L.conv2d(x, n1, 1, act="relu")
        x = L.conv2d(x, n2, 3, stride=stride, padding=pad, act="relu")
        maps.append(x)
    scale = L.create_parameter(
        [512], "float32", name="conv4_3_norm.scale",
        default_initializer=pt.initializer.ConstantInitializer(20.0))
    norm = L.elementwise_mul(L.l2_normalize(conv4_3, axis=1), scale, axis=1)
    return L.detection.multi_box_head(
        [norm] + maps, img, min_sizes=list(SSD_MIN), max_sizes=list(SSD_MAX),
        aspect_ratios=[list(a) for a in SSD_AR], num_classes=SSD_C,
        flip=True, clip=True)


def ssd300_inputs():
    L = pt.layers
    return (L.data("img", [3, SSD_HW, SSD_HW]), L.data("gtb", [SSD_G, 4]),
            L.data("gtl", [SSD_G], dtype="int32"))


def ssd300_programs():
    """The training program (ssd_loss with hard-negative mining at 3:1,
    overlap 0.5, its mean, Momentum(SSD_LR, 0.9)) and the inference
    program over the same parameter names (softmax, detection_output at
    SSD's test settings, InGraphDetectionMAP): (main, startup, cost,
    infer, dmap, (nms out, nms count))."""
    pt.framework.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        img, gtb, gtl = ssd300_inputs()
        loc, conf, priors, pvars = ssd300_head(img)
        if tuple(priors.shape) != (SSD_PRIORS, 4):
            raise AssertionError(f"SSD300: {priors.shape} priors, expected "
                                 f"{SSD_PRIORS}")
        cost = pt.layers.mean(pt.layers.detection.ssd_loss(
            loc, conf, gtb, gtl, priors, pvars, overlap_threshold=0.5,
            neg_pos_ratio=3.0))
        pt.MomentumOptimizer(SSD_LR, 0.9).minimize(cost)
    pt.framework.reset_default_programs()       # the same parameter names
    infer, istart = pt.Program(), pt.Program()
    with pt.program_guard(infer, istart):
        img, gtb, gtl = ssd300_inputs()
        loc, conf, priors, pvars = ssd300_head(img)
        probs = pt.layers.softmax(conf)
        nms = pt.layers.detection.detection_output(loc, probs, priors, pvars,
                                                   **SSD_NMS)
        dmap = pt.evaluator.InGraphDetectionMAP(
            nms[0], gtb, gtl, num_classes=SSD_C, num_buckets=SSD_MAP_BUCKETS,
            overlap_threshold=0.5)
    return main, startup, cost, infer, dmap, nms


def ssd300_feed(rng, B):
    """Uniform images; 16 ground-truth slots an image, 1-8 real boxes
    with sides 0.1-0.6 of the image and labels 1-20, padding rows all
    zero with label 0."""
    gtb = np.zeros((B, SSD_G, 4), np.float32)
    gtl = np.zeros((B, SSD_G), np.int32)
    for b in range(B):
        for g in range(rng.randint(1, 9)):
            side = rng.uniform(0.1, 0.6, 2)
            xy = rng.rand(2) * (1 - side)
            gtb[b, g] = [xy[0], xy[1], xy[0] + side[0], xy[1] + side[1]]
            gtl[b, g] = rng.randint(1, SSD_C)
    return {"img": rng.rand(B, 3, SSD_HW, SSD_HW).astype(np.float32),
            "gtb": gtb, "gtl": gtl}


def card_wall_ms(fn, reps=3):
    """Median host wall of `reps` calls, each synchronised (one warm-up
    call first)."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(walls))


def call_peak_mib(fn):
    """The card memory fn allocates at its peak beyond what was
    allocated before it, in MiB."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def differing_rows(card, cpu):
    """Rows (first axis) on which two arrays differ."""
    card, cpu = np.asarray(card), np.asarray(cpu)
    return [b for b in range(card.shape[0])
            if not np.array_equal(card[b], cpu[b])]


def nms_row_excused(card, cpu):
    """An image's NMS output ([keep_top_k, 6] rows of label, score, box)
    that differs is excused only as a near tie decided the other way:
    at its first differing row the two sides' scores differ, by no more
    than DET_TIE; from that row on the two sides hold the same rows in
    another order; and every row whose scores are bitwise equal on both
    sides is equal in label and box too."""
    k = next(i for i in range(card.shape[0])
             if not np.array_equal(card[i], cpu[i]))
    same_score = card[:, 1] == cpu[:, 1]
    return bool(not same_score[k]
                and abs(float(card[k, 1]) - float(cpu[k, 1])) <= DET_TIE
                and np.array_equal(card[same_score], cpu[same_score])
                and sorted(map(tuple, card[k:])) == sorted(map(tuple,
                                                               cpu[k:])))


def mine_row_excused(loss, match, dist, n_card, n_cpu):
    """A mined row that differs is excused only where the losses of the
    last negative taken and the first one left lie within DET_TIE."""
    eligible = (match == -1) & (dist < 0.5)
    vals = np.sort(loss[eligible])[::-1]
    k = int(min(n_card, n_cpu))
    return k < len(vals) and abs(vals[k - 1] - vals[k]) <= DET_TIE


def det_ops_phase(smi):
    """Phase 39 (a): the detection ops at SSD300's sizes (B SSD_B, G 16,
    8732 priors, 21 classes), the same port code on the card and on the
    CPU over the same seeded inputs: priors within 1 ulp; IoU and the
    three box codes within DET_TOL of each array's largest element;
    bipartite_match, target_assign, mine_hard_examples' mask and
    multiclass_nms' Out and OutCount exactly, each op fed the CPU's
    values of its inputs, a differing row only excused at a near tie.
    Each op's card time; the NMS's kernels, host syncs and peak memory."""
    rng = np.random.RandomState(SEED + 60)
    feed = ssd300_feed(rng, SSD_B)
    B, P = SSD_B, SSD_PRIORS
    res, ms, excused = {}, {}, {"nms": 0, "mine": 0}

    def both(op, ins, attrs, timed=True):
        on_card = {k: [torch.as_tensor(v).cuda() for v in vs]
                   for k, vs in ins.items()}
        cuda = lower_on(op, on_card, attrs, "cuda")
        cpu = lower_on(op, ins, attrs, "cpu")
        if timed:           # the inputs already on the card: no copy timed
            ms[op] = card_wall_ms(lambda: lower_on(op, on_card, attrs,
                                                   "cuda"))
        return ({k: [t.cpu().numpy() for t in v] for k, v in cuda.items()},
                {k: [t.numpy() for t in v] for k, v in cpu.items()})

    boxes, pvars = [], []
    for hw, mn, mx, ar in zip(SSD_MAPS, SSD_MIN, SSD_MAX, SSD_AR):
        ins = {"Input": [torch.zeros(1, 1, hw, hw)],
               "Image": [torch.zeros(1, 1, SSD_HW, SSD_HW)]}
        attrs = {"min_sizes": [mn], "max_sizes": [mx],
                 "aspect_ratios": list(ar), "variances": [0.1, 0.1, 0.2, 0.2],
                 "flip": True, "clip": True, "step_w": 0.0, "step_h": 0.0,
                 "offset": 0.5}
        card, cpu = both("prior_box", ins, attrs)
        for slot in ("Boxes", "Variances"):
            np.testing.assert_array_max_ulp(card[slot][0], cpu[slot][0],
                                            maxulp=1)
        boxes.append(cpu["Boxes"][0].reshape(-1, 4))
        pvars.append(cpu["Variances"][0].reshape(-1, 4))
    priors, pvar = np.concatenate(boxes), np.concatenate(pvars)
    if priors.shape != (P, 4):
        raise AssertionError(f"SSD300 priors {priors.shape}")
    res["priors_bitwise"] = True

    def close(what, card, cpu):
        err = float(np.abs(card - cpu).max()) / max(float(np.abs(cpu).max()),
                                                    1e-30)
        res[what] = err
        if not err <= DET_TOL:
            raise AssertionError(f"SSD300 {what}: the card differs from the "
                                 f"CPU by {err:.3e} of the largest element")

    card, cpu = both("iou_similarity", {"X": [feed["gtb"]], "Y": [priors]},
                     {})
    close("iou", card["Out"][0], cpu["Out"][0])
    iou = cpu["Out"][0]
    res["iou_bitwise"] = bool(np.array_equal(card["Out"][0], iou))
    card, cpu = both("bipartite_match", {"DistMat": [iou]},
                     {"match_type": "per_prediction", "dist_threshold": 0.5})
    for slot in ("ColToRowMatchIndices", "ColToRowMatchDist"):
        if differing_rows(card[slot][0], cpu[slot][0]):
            raise AssertionError(f"SSD300 bipartite_match {slot} differs")
    match, mdist = (cpu[s][0] for s in ("ColToRowMatchIndices",
                                        "ColToRowMatchDist"))
    card, cpu = both("target_assign", {"X": [feed["gtb"]],
                                       "MatchIndices": [match]},
                     {"mismatch_value": 0})
    for slot in ("Out", "OutWeight"):
        if differing_rows(card[slot][0], cpu[slot][0]):
            raise AssertionError(f"SSD300 target_assign {slot} differs")
    matched = cpu["Out"][0]
    card, cpu = both("box_coder", {"PriorBox": [priors],
                                   "PriorBoxVar": [pvar],
                                   "TargetBox": [matched]},
                     {"code_type": "encode_matched"})
    close("box_coder_encode_matched", card["OutputBox"][0],
          cpu["OutputBox"][0])
    card, cpu = both("box_coder", {"PriorBox": [priors],
                                   "PriorBoxVar": [pvar],
                                   "TargetBox": [feed["gtb"][0]]},
                     {"code_type": "encode_center_size"})
    close("box_coder_encode_center_size", card["OutputBox"][0],
          cpu["OutputBox"][0])
    loc = (rng.randn(B, P, 4) * 0.5).astype(np.float32)
    card, cpu = both("box_coder", {"PriorBox": [priors],
                                   "PriorBoxVar": [pvar],
                                   "TargetBox": [loc]},
                     {"code_type": "decode_center_size"})
    close("box_coder_decode", card["OutputBox"][0], cpu["OutputBox"][0])
    decoded = cpu["OutputBox"][0]

    cls_loss = (rng.rand(B, P) * 5).astype(np.float32)
    card, cpu = both("mine_hard_examples",
                     {"ClsLoss": [cls_loss], "MatchIndices": [match],
                      "MatchDist": [mdist]},
                     {"neg_pos_ratio": 3.0, "neg_dist_threshold": 0.5})
    for b in differing_rows(card["NegMask"][0], cpu["NegMask"][0]):
        if not mine_row_excused(cls_loss[b], match[b], mdist[b],
                                card["NegMask"][0][b].sum(),
                                cpu["NegMask"][0][b].sum()):
            raise AssertionError(f"SSD300 mine_hard_examples: image {b} "
                                 f"differs away from a near tie")
        excused["mine"] += 1
    res["negatives"] = int(cpu["NegMask"][0].sum())

    logits = rng.randn(B, P, SSD_C).astype(np.float32) * 2
    probs = torch.softmax(torch.from_numpy(logits), -1)
    scores = probs.transpose(1, 2).contiguous().numpy()     # [B, C, P]
    nms_ins = {"Scores": [scores], "BBoxes": [decoded]}
    card, cpu = both("multiclass_nms", nms_ins, SSD_NMS)
    if differing_rows(card["OutCount"][0], cpu["OutCount"][0]):
        raise AssertionError("SSD300 multiclass_nms: OutCount differs")
    for b in differing_rows(card["Out"][0], cpu["Out"][0]):
        if not nms_row_excused(card["Out"][0][b], cpu["Out"][0][b]):
            raise AssertionError(f"SSD300 multiclass_nms: image {b} differs "
                                 f"away from a near tie")
        excused["nms"] += 1
    res["nms_kept"] = [int(n) for n in cpu["OutCount"][0][:4]]
    # every score tied: each pick is the first maximum, and the padding
    # rows carry the boxes the stable ranking puts there
    card, cpu = both("multiclass_nms",
                     {"Scores": [np.full_like(scores[:4], 0.5)],
                      "BBoxes": [decoded[:4]]}, SSD_NMS, timed=False)
    if differing_rows(card["Out"][0], cpu["Out"][0]):
        raise AssertionError("SSD300 multiclass_nms with every score tied "
                             "differs from the CPU")
    tins = {k: [torch.as_tensor(v).cuda() for v in vs]
            for k, vs in nms_ins.items()}

    def nms_call():
        lower_on("multiclass_nms", tins, SSD_NMS, "cuda")

    res["nms_device_ms"], res["nms_kernels"] = device_time(nms_call)
    res["nms_syncs"] = call_syncs(nms_call)
    res["nms_peak_mib"] = call_peak_mib(nms_call)
    res["ms"] = ms
    res["excused_rows"] = excused
    log(f"SSD300 detection ops, the card against the CPU (B {B}, G "
        f"{SSD_G}, {P} priors, {SSD_C} classes): priors within 1 ulp; IoU "
        f"{res['iou']:.2e} (bitwise {res['iou_bitwise']}), box codes "
        f"{res['box_coder_encode_matched']:.2e} / "
        f"{res['box_coder_encode_center_size']:.2e} / "
        f"{res['box_coder_decode']:.2e} of the largest element (tol "
        f"{DET_TOL:g}); bipartite_match, target_assign, mine_hard_examples "
        f"({res['negatives']} negatives) and multiclass_nms (kept "
        f"{res['nms_kept']}...; and with every score tied) exact, rows "
        f"excused at a near tie "
        f"{excused}; card ms {({k: round(v, 3) for k, v in ms.items()})}; "
        f"one NMS ({SSD_NMS['nms_top_k']} steps): {res['nms_kernels']} "
        f"kernels, {res['nms_device_ms']:.2f} device ms (profiled) in "
        f"{ms['multiclass_nms']:.1f} ms of wall, {res['nms_syncs']} host "
        f"syncs, peak "
        f"{res['nms_peak_mib']:.1f} MiB | {smi}")
    if res["nms_syncs"] != 0:
        raise AssertionError("SSD300: the NMS read the card on the host")
    return res


def ssd_check_phase(main, startup, cost, smi):
    """Phase 39 (b): one training step at B SSD_CHECK_B from one CPU
    initialisation: every op of the forward and backward lowered on the
    card on the CPU's values of its inputs, each float output within
    SSD_OP_TOL of its largest element (held); the step run free on both
    sides (printed, not held: a relu input within rounding of 0 flips
    side, ROADMAP C11)."""
    rng = np.random.RandomState(SEED + 61)
    feed = ssd300_feed(rng, SSD_CHECK_B)
    cpu_scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=cpu_scope)
    state = tensors_of(cpu_scope)
    names = [cost.name] + [n for n in main.global_block().vars
                           if n.endswith("@GRAD_0")
                           and n[:-len("@GRAD_0")] in state]
    card = pt.Executor().run(main, feed=feed, fetch_list=names,
                             scope=scope_of(state, "cuda"),
                             return_numpy=False)
    cpu = pt.Executor(pt.CPUPlace()).run(main, feed=feed, fetch_list=names,
                                         scope=scope_of(state, "cpu"),
                                         return_numpy=False)
    free = {n: max_rel(c, r) for n, c, r in zip(names, card, cpu)}
    worst_free = max(free.items(), key=lambda kv: kv[1])
    errs, _ = op_by_op_step(main, feed, scope_of(state, "cpu"),
                            f"SSD300 B {SSD_CHECK_B}", SSD_OP_TOL)
    worst = max(errs.items(), key=lambda kv: kv[1])
    log(f"SSD300 B {SSD_CHECK_B} step op by op on the card, on the CPU's "
        f"inputs: {len(errs)} outputs of {len(main.global_block().ops)} "
        f"ops, worst {worst[0]} {worst[1]:.2e} of its largest element (tol "
        f"{SSD_OP_TOL:g}); run free (not held): loss "
        f"{free[cost.name]:.2e} relative, the worst of {len(names) - 1} "
        f"gradients {worst_free[0]} {worst_free[1]:.2e} | {smi}")
    return {"outputs": len(errs), "ops": len(main.global_block().ops),
            "worst": list(worst), "free_loss_rel": free[cost.name],
            "free_worst_grad": list(worst_free)}


def ssd_train_phase(main, startup, cost, smi):
    """Phase 39 (c): SSD300 training at B SSD_B, f32 with TF32 off,
    SSD_STEPS Momentum steps over one fixed batch: the mean of the last
    5 losses below SSD_FALL x step 1's; images/s, step wall, device ms
    and busy share, kernels and host syncs a step, peak memory; no TPU
    kernel launched."""
    use_full_f32()
    rng = np.random.RandomState(SEED + 62)
    feed = ssd300_feed(rng, SSD_B)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()                       # the main path starts here
    losses, walls = timed_steps(exe, main, feed, cost, scope, 0, SSD_STEPS)
    counts = read_counts()              # the main path ends here
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_counts(counts, launches_of(), "SSD300 training (no TPU kernel on "
                 "this path)")
    first, last5 = losses[0], float(np.mean(losses[-5:]))
    med, lo, hi = median_lo_hi(walls[1:])
    prof = whole_profile(exe, main, feed, cost, scope, med,
                         "SSD300 training step", smi)
    syncs = ctr_step_syncs(exe, main, feed, scope)
    device = ("not measured" if prof["device_ms"] is None else
              f"{prof['device_ms']:.2f} ms (busy {prof['busy']:.3f})")
    log(f"SSD300 training B {SSD_B}, Momentum({SSD_LR:g}, 0.9), "
        f"{SSD_STEPS} steps on one batch: loss {first:.3f} -> mean of the "
        f"last 5 {last5:.3f} (must be < {SSD_FALL} x step 1); "
        f"{SSD_B / (med / 1e3):.1f} images/s (step {med:.2f} ms median, "
        f"{lo:.2f}-{hi:.2f}, the first {walls[0]:.1f}), device {device}, "
        f"{prof['kernels_per_step']} kernels a step of "
        f"{prof['host_launches']} launched ({prof['kernels_lost']} kernels "
        f"lost in capture {prof['captures']}), {syncs} host syncs a step, "
        f"peak {peak:.2f} GiB; top ops {prof['top_op_types_ms']} | {smi}")
    if not (np.isfinite(losses).all() and last5 < SSD_FALL * first):
        raise AssertionError(f"SSD300: the loss did not fall below "
                             f"{SSD_FALL} x step 1's: {losses}")
    return counts, scope, feed, {
        "B": SSD_B, "steps": SSD_STEPS, "lr": SSD_LR,
        "losses": [first, last5], "images_per_s": SSD_B / (med / 1e3),
        "step_ms": med, "step_ms_lo": lo, "step_ms_hi": hi,
        "device_ms": prof["device_ms"], "busy": prof["busy"],
        "kernels_per_step": prof["kernels_per_step"],
        "profile_captures": prof["captures"],
        "kernels_lost": prof["kernels_lost"],
        "syncs_per_step": syncs, "peak_gib": peak,
        "top_op_types_ms": prof["top_op_types_ms"]}


def ssd_infer_phase(infer, dmap, nms, scope, train_feed, smi):
    """Phase 39 (d): detection_output (softmax, decode, NMS at SSD's
    test settings) and InGraphDetectionMAP over SSD_INFER_BATCHES
    batches of SSD_B (the first the training batch): each batch's
    in-graph TpHist / FpHist / PosCount equal, to the bit,
    detection_map_buckets run on the CPU over the fetched detections,
    and the states their sum; each batch's wall, the NMS's share of it
    (the op alone on the same inputs), syncs a batch; the in-graph mAP
    beside the host DetectionMAP's. No TPU kernel launched."""
    rng = np.random.RandomState(SEED + 63)
    feeds = [train_feed] + [ssd300_feed(rng, SSD_B)
                            for _ in range(SSD_INFER_BATCHES - 1)]
    exe = pt.Executor()
    dmap.reset(exe, scope)
    blk = infer.global_block()
    nms_op = next(op for op in blk.ops if op.type == "multiclass_nms")
    hists = [f"{dmap._prefix}.{s}" for s in ("TpHist", "FpHist", "PosCount")]
    fetch = [nms[0].name, nms[1].name] + hists + [
        nms_op.inputs["Scores"][0], nms_op.inputs["BBoxes"][0]]
    attrs = next(op for op in blk.ops
                 if op.type == "detection_map_buckets").attrs
    host = pt.evaluator.DetectionMAP(overlap_threshold=0.5)
    sums = [0.0, 0.0, 0.0]
    walls, outs, nms_ms, kept = [], [], [], []
    zero_counts()                       # the main path starts here
    for feed in feeds:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(exe.run(infer, feed=feed, fetch_list=fetch, scope=scope,
                            return_numpy=False))
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    counts = read_counts()              # the main path ends here
    check_counts(counts, launches_of(), "SSD300 inference (no TPU kernel "
                 "on this path)")
    # what the batches fetched, checked and timed after the main path
    for feed, out in zip(feeds, outs):
        dets = out[0].cpu().numpy()
        kept.append(int(out[1].sum()))
        ref = lower_on("detection_map_buckets",
                       {"Detections": [dets], "GtBoxes": [feed["gtb"]],
                        "GtLabels": [feed["gtl"]]}, attrs, "cpu")
        for i, slot in enumerate(("TpHist", "FpHist", "PosCount")):
            got = out[2 + i].cpu()
            if not torch.equal(got, ref[slot][0]):
                raise AssertionError(f"SSD300 in-graph mAP {slot} differs "
                                     f"from detection_map_buckets on the CPU")
            sums[i] = sums[i] + ref[slot][0]
        host.update(dets, feed["gtb"], feed["gtl"])
        sc, bx = out[5], out[6]
        nms_ms.append(card_wall_ms(
            lambda: lower_on("multiclass_nms", {"Scores": [sc],
                                                "BBoxes": [bx]},
                             nms_op.attrs, "cuda"), reps=1))
    del outs
    for st, want in zip(dmap.states, sums):
        if not torch.equal(scope.get(st.name).cpu(), want):
            raise AssertionError(f"SSD300: the mAP state {st.name} is not "
                                 f"the sum of the batches' histograms")
    got_map, host_map = dmap.eval(exe, scope), host.eval()
    syncs = ctr_step_syncs(exe, infer, feeds[-1], scope)
    shares = [n / w for n, w in zip(nms_ms, walls)]
    log(f"SSD300 inference B {SSD_B} x {len(feeds)} batches "
        f"(detection_output: NMS {SSD_NMS}): walls "
        f"{[round(w, 1) for w in walls]} ms, the NMS alone "
        f"{[round(n, 1) for n in nms_ms]} ms (share "
        f"{[round(s, 3) for s in shares]}), {syncs} host syncs a batch, "
        f"{kept} detections kept; in-graph histograms == "
        f"detection_map_buckets on the CPU, bitwise; mAP in-graph "
        f"{got_map:.6f}, host DetectionMAP {host_map:.6f} | {smi}")
    return counts, {"B": SSD_B, "batches": len(feeds), "walls_ms": walls,
                    "nms_ms": nms_ms, "nms_share": shares,
                    "syncs_per_batch": syncs, "kept": kept,
                    "map_in_graph": got_map, "map_host": host_map}


def roi_pool_phase(smi):
    """Phase 39 (e): roi_pool at Fast R-CNN's shape (VGG16 conv5_3 of a
    600 x 1000 image: [2, 512, 38, 63], spatial_scale 1/16, 128 ROIs an
    image, 7 x 7 bins): Out and Argmax equal the CPU's exactly, the
    gradient of a weighted sum within ROI_GRAD_TOL of its largest
    element; ms forward and forward + backward, peak memory, syncs."""
    rng = np.random.RandomState(SEED + 64)
    B = ROI_FEAT[0]
    x = np.maximum(rng.randn(*ROI_FEAT), 0).astype(np.float32)
    N = B * ROI_PER_IMAGE
    ih, iw = ROI_IMAGE
    wh = np.stack([rng.uniform(32, 400, N), rng.uniform(32, 300, N)], 1)
    xy = rng.rand(N, 2) * (np.array([iw, ih]) - wh)
    rois = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    lens = np.full(B, ROI_PER_IMAGE, np.int32)
    wsum = rng.randn(N, ROI_FEAT[1], ROI_BINS, ROI_BINS).astype(np.float32)
    attrs = {"spatial_scale": 1.0 / 16, "pooled_height": ROI_BINS,
             "pooled_width": ROI_BINS}
    on = {d: [torch.from_numpy(a).to(d) for a in (x, rois, lens, wsum)]
          for d in ("cuda", "cpu")}

    def run(device, backward=True):
        xd, rd, ld, wd = on[device]
        xt = xd.detach().requires_grad_(backward)
        out = lower_on("roi_pool", {"X": [xt], "ROIs": [rd], "SeqLen": [ld]},
                       attrs, device, grad=backward)
        g = None
        if backward:
            g, = torch.autograd.grad((out["Out"][0] * wd).sum(), [xt])
        return out["Out"][0].detach(), out["Argmax"][0], g

    co, ca, cg = run("cuda")
    ro, ra, rg = run("cpu")
    if not (torch.equal(co.cpu(), ro) and torch.equal(ca.cpu(), ra)):
        raise AssertionError("roi_pool: Out / Argmax on the card differ from "
                             "the CPU's")
    gerr = max_rel(cg, rg)
    if not gerr <= ROI_GRAD_TOL:
        raise AssertionError(f"roi_pool: the gradient differs by {gerr:.3e}")
    fwd_ms = card_wall_ms(lambda: run("cuda", backward=False), reps=5)
    both_ms = card_wall_ms(lambda: run("cuda"), reps=5)
    fwd_mib = call_peak_mib(lambda: run("cuda", backward=False))
    both_mib = call_peak_mib(lambda: run("cuda"))
    syncs = call_syncs(lambda: run("cuda", backward=False))
    dev_ms, kernels = device_time(lambda: run("cuda", backward=False))
    empty = int((ra == -1).sum())
    log(f"roi_pool at Fast R-CNN's shape (features {list(ROI_FEAT)}, "
        f"{N} ROIs, scale 1/16, {ROI_BINS} x {ROI_BINS}): Out and Argmax "
        f"== the CPU's ({empty} empty bins), gradient {gerr:.2e} of its "
        f"largest element (tol {ROI_GRAD_TOL:g}); forward {fwd_ms:.3f} ms "
        f"({dev_ms:.3f} device ms in {kernels} kernels), forward + backward "
        f"{both_ms:.3f} ms, peak {fwd_mib:.1f} / {both_mib:.1f} MiB, "
        f"{syncs} host sync(s) a call | {smi}")
    return {"features": list(ROI_FEAT), "rois": N, "grad_rel_err": gerr,
            "fwd_ms": fwd_ms, "fwd_device_ms": dev_ms, "fwd_kernels": kernels,
            "fwd_bwd_ms": both_ms, "fwd_peak_mib": fwd_mib,
            "fwd_bwd_peak_mib": both_mib, "syncs": syncs,
            "empty_bins": empty}


def evaluators_phase(smi):
    """Phase 39 (f): InGraphPnpair over PNPAIR_N scores in PNPAIR_Q
    queries and InGraphPrecisionRecall over PR_N predictions of 21
    classes, each program run on the card and on the CPU from zeroed
    states: the states equal exactly, and equal the host evaluators'
    counts."""
    rng = np.random.RandomState(SEED + 65)
    res = {}
    for name in ("pnpair", "precision_recall"):
        pt.framework.reset_default_programs()
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup):
            if name == "pnpair":
                s = pt.layers.data("s", [1])
                y = pt.layers.data("y", [1])
                q = pt.layers.data("q", [1], dtype="int64")
                e = pt.evaluator.InGraphPnpair(score=s, label=y, query_id=q)
                feed = {"s": np.round(rng.randn(PNPAIR_N, 1) * 4).astype(
                            np.float32),
                        "y": rng.randint(0, 3, (PNPAIR_N, 1)).astype(
                            np.float32),
                        "q": np.sort(rng.randint(0, PNPAIR_Q, (PNPAIR_N, 1)),
                                     0).astype(np.int64)}
                host = pt.evaluator.PnpairEvaluator()
                host.update(feed["s"], feed["y"], feed["q"])
                want = [host.pos, host.neg, host.spe]
            else:
                p = pt.layers.data("p", [1], dtype="int64")
                lab = pt.layers.data("lab", [1], dtype="int64")
                e = pt.evaluator.InGraphPrecisionRecall(p, lab, SSD_C)
                lab_np = rng.randint(0, SSD_C, (PR_N, 1))
                pred = np.where(rng.rand(PR_N, 1) < 0.6, lab_np,
                                rng.randint(0, SSD_C, (PR_N, 1)))
                feed = {"p": pred.astype(np.int64),
                        "lab": lab_np.astype(np.int64)}
                host = pt.evaluator.PrecisionRecall(SSD_C)
                host.update(pred, lab_np)
                want = [host.tp, host.fp, host.fn]
        got = {}
        for device in ("cuda", "cpu"):
            exe = pt.Executor(None if device == "cuda" else pt.CPUPlace())
            scope = pt.Scope()
            e.reset(exe, scope)
            t0 = time.perf_counter()
            exe.run(main, feed=feed, fetch_list=[], scope=scope)
            if device == "cuda":
                torch.cuda.synchronize()
                res[f"{name}_ms"] = 1e3 * (time.perf_counter() - t0)
            got[device] = [scope.get(st.name).cpu().numpy()
                           for st in e.states]
        for c, r, w in zip(got["cuda"], got["cpu"], want):
            if not (np.array_equal(c, r)
                    and np.array_equal(c.astype(np.float64),
                                       np.asarray(w, np.float64).reshape(
                                           c.shape))):
                raise AssertionError(f"{name}: the card's counts differ from "
                                     f"the CPU's or the host evaluator's")
        res[name] = [np.asarray(v).reshape(-1)[:3].tolist()
                     for v in got["cuda"]]
    log(f"in-graph evaluators on the card == the CPU == the host: "
        f"InGraphPnpair over {PNPAIR_N} scores in {PNPAIR_Q} queries (pos, "
        f"neg, spe {res['pnpair']}) in {res['pnpair_ms']:.1f} ms; "
        f"InGraphPrecisionRecall over {PR_N} predictions of {SSD_C} classes "
        f"in {res['precision_recall_ms']:.1f} ms | {smi}")
    return res


def detection_phase(smi):
    """Phase 39."""
    t0 = time.perf_counter()
    ops = det_ops_phase(smi)
    main, startup, cost, infer, dmap, nms = ssd300_programs()
    check = ssd_check_phase(main, startup, cost, smi)
    train_counts, scope, feed, train = ssd_train_phase(main, startup, cost,
                                                       smi)
    infer_counts, inference = ssd_infer_phase(infer, dmap, nms, scope, feed,
                                              smi)
    del scope
    roi = roi_pool_phase(smi)
    evals = evaluators_phase(smi)
    secs = time.perf_counter() - t0
    log(f"detection: phase 39 in {secs:.1f} s | {smi}")
    return ({"ssd300_training": train_counts,
             "ssd300_inference": infer_counts},
            {"ops": ops, "step_check": check, "training": train,
             "inference": inference, "roi_pool": roi, "evaluators": evals,
             "seconds": secs})


# -- phase 40: the rest of the op corpus ---------------------------------------

# (a) tolerances: forward within OPS_FWD_TOL of each output's largest
# element, gradients within OPS_GRAD_TOL of each gradient's largest
OPS_FWD_TOL, OPS_GRAD_TOL = 1e-5, 1e-4
# chi-square tests of the random ops' draws: the 0.999 quantile
CHI2_Z = 3.09
# (b) word2vec's N-gram model at the book's widths (test_word2vec.py):
# 4 context words, embedding 32, hidden 256, B 100, over imikolov's
# dictionary at min_word_freq 50 (2073 words); 10 NCE negatives (the
# reference default); Adam, W2V_STEPS steps over W2V_BATCHES batches
W2V_V, W2V_EMB, W2V_HID, W2V_B = 2073, 32, 256, 100
W2V_NEG, W2V_STEPS, W2V_BATCHES, W2V_LR = 10, 200, 8, 1e-3
W2V_HEADS = ("softmax", "nce", "hsigmoid")
CARD = "cuda"                    # phase 40's device
# (d) published shapes: C3D (Tran et al., 2015) clips 3 x 16 x 112 x 112
# at B C3D_B; SegNet's first encoder / last decoder stage on CamVid
# (360 x 480, 64 channels) at B SEGNET_B; VGG16's conv5 map (224 input)
# at B SPP_B; a [B, 21, 64, 64] score map x 2 at B INTERP_B; the CPU
# check of each at batch 1
C3D_B, SEGNET_B, SPP_B, INTERP_B = 8, 4, 32, 32


def _u(rng, shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def corpus_cases(rng):
    """(a)'s cases: (op, inputs, attrs, output slot, gradient slots,
    exact output slots). Shapes: a [256, 1024] f32 plane for the
    elementwise ops, the stated ones for the rest."""
    E = (256, 1024)
    pos = _u(rng, E, 0.5, 2.0)
    ties = np.zeros((2, 4, 8, 8), np.float32)
    ties[:, :, 0:2, 0:2] = 1.0          # a window of four tied maxima
    ties[:, :, 4:6, 2:4] = 2.0
    lens = rng.randint(1, 33, (64,)).astype(np.int32)
    return [
        ("elementwise_pow", {"X": [pos], "Y": [_u(rng, E, -2, 2)]}, {},
         "Out", ("X", "Y"), ()),
        ("rsqrt", {"X": [pos]}, {}, "Out", ("X",), ()),
        ("abs", {"X": [_u(rng, E)]}, {}, "Out", ("X",), ()),
        ("log", {"X": [pos]}, {}, "Out", ("X",), ()),
        ("ceil", {"X": [_u(rng, E, -8, 8)]}, {}, "Out", (), ("Out",)),
        ("round", {"X": [np.round(_u(rng, E, -8, 8) * 2) / 2]}, {}, "Out",
         (), ("Out",)),
        ("reciprocal", {"X": [pos]}, {}, "Out", ("X",), ()),
        ("cos", {"X": [_u(rng, E, -4, 4)]}, {}, "Out", ("X",), ()),
        ("sin", {"X": [_u(rng, E, -4, 4)]}, {}, "Out", ("X",), ()),
        ("reduce_mean", {"X": [_u(rng, (64, 128, 32))]}, {"dim": [1]},
         "Out", ("X",), ()),
        ("reduce_min", {"X": [np.round(_u(rng, (64, 128, 32)) * 4)]},
         {"dim": [0, 2]}, "Out", ("X",), ()),
        ("reduce_prod", {"X": [_u(rng, (4096, 8), 0.5, 1.5)]}, {"dim": [1]},
         "Out", ("X",), ()),
        ("split", {"X": [_u(rng, E)]}, {"axis": 1,
                                        "sections": [256, 512, 256]},
         "Out", ("X",), ()),
        ("stack", {"X": [_u(rng, E), _u(rng, E)]}, {"axis": 1}, "Out",
         ("X",), ()),
        ("expand", {"X": [_u(rng, (256, 64))]}, {"expand_times": [2, 16]},
         "Out", ("X",), ()),
        ("pad", {"X": [_u(rng, (64, 32, 32))]},
         {"paddings": [0, 0, 1, 2, 3, 0], "pad_value": 0.5}, "Out", ("X",),
         ()),
        ("isfinite", {"X": [_u(rng, E), np.asarray([1.0, np.inf],
                                                    np.float32)]}, {},
         "Out", (), ("Out",)),
        ("gather", {"X": [_u(rng, (4096, 256))],
                    "Index": [rng.randint(0, 4096, (1024, 1))]}, {}, "Out",
         ("X",), ("Out",)),
        ("scatter", {"X": [_u(rng, (4096, 256))],
                     "Ids": [rng.permutation(4096)[:1024]],
                     "Updates": [_u(rng, (1024, 256))]}, {}, "Out",
         ("X", "Updates"), ("Out",)),
        ("cumsum", {"X": [_u(rng, (256, 1024))]},
         {"axis": 1, "reverse": True, "exclusive": True}, "Out", ("X",),
         ()),
        ("range", {}, {"start": 3, "end": 100003, "step": 7}, "Out", (),
         ("Out",)),
        ("multiplex", {"X": [_u(rng, E), _u(rng, E), _u(rng, E)],
                       "Ids": [rng.randint(0, 3, (256, 1))]}, {}, "Out",
         ("X",), ("Out",)),
        ("print", {"X": [_u(rng, (4, 8))]}, {"message": "phase 40 print",
                                              "summarize": 8}, "Out", ("X",),
         ("Out",)),
        ("hard_shrink", {"X": [_u(rng, E, -2, 2)]}, {"threshold": 0.5},
         "Out", ("X",), ()),
        ("tanh_shrink", {"X": [_u(rng, E, -3, 3)]}, {}, "Out", ("X",), ()),
        ("soft_relu", {"X": [_u(rng, E, -50, 50)]}, {"threshold": 40.0},
         "Out", ("X",), ()),
        ("prelu", {"X": [_u(rng, (32, 64, 16, 16))],
                   "Alpha": [_u(rng, (64,), 0, 0.5)]}, {"mode": "channel"},
         "Out", ("X", "Alpha"), ()),
        ("minus", {"X": [_u(rng, E)], "Y": [_u(rng, E)]}, {}, "Out",
         ("X", "Y"), ()),
        ("log_loss", {"Predicted": [_u(rng, (4096, 1), 0.01, 0.99)],
                      "Labels": [(rng.rand(4096, 1) > 0.5).astype(
                          np.float32)]}, {}, "Loss", ("Predicted",), ()),
        ("margin_rank_loss", {"X1": [_u(rng, (4096, 1))],
                              "X2": [_u(rng, (4096, 1))],
                              "Label": [np.sign(_u(rng, (4096, 1)))]},
         {"margin": 0.1}, "Out", ("X1", "X2"), ()),
        ("modified_huber_loss", {"X": [_u(rng, (4096, 1), -3, 3)],
                                 "Y": [(rng.rand(4096, 1) > 0.5).astype(
                                     np.float32)]}, {}, "Out", ("X",), ()),
        ("squared_l2_distance", {"X": [_u(rng, (512, 256))],
                                 "Y": [_u(rng, (1, 256))]}, {}, "Out",
         ("X", "Y"), ()),
        ("l1_norm", {"X": [_u(rng, E)]}, {}, "Out", ("X",), ()),
        ("squared_l2_norm", {"X": [_u(rng, E)]}, {}, "Out", ("X",), ()),
        ("label_smooth", {"X": [np.eye(1000, dtype=np.float32)[
            rng.randint(0, 1000, 512)]]}, {"epsilon": 0.1}, "Out", ("X",),
         ()),
        ("assign_value", {}, {"shape": [4, 4],
                              "fp32_values": _u(rng, (16,)).tolist()},
         "Out", (), ("Out",)),
        ("fill", {}, {"shape": [2, 3], "value": [1, 2, 3, 4, 5, 6],
                      "dtype": "int64"}, "Out", (), ("Out",)),
        ("bilinear_tensor_product", {"X": [_u(rng, (256, 128))],
                                     "Y": [_u(rng, (256, 64))],
                                     "Weight": [_u(rng, (32, 128, 64),
                                                   -0.1, 0.1)],
                                     "Bias": [_u(rng, (1, 32))]}, {}, "Out",
         ("X", "Y", "Weight", "Bias"), ()),
        ("conv_shift", {"X": [_u(rng, (256, 128))],
                        "Y": [_u(rng, (256, 5))]}, {}, "Out", ("X", "Y"),
         ()),
        ("lambda_rank_cost", {"Score": [_u(rng, (64, 32))],
                              "Label": [rng.randint(0, 4, (64, 32)).astype(
                                  np.float32)], "SeqLen": [lens]},
         {"NDCG_num": 5, "max_sort_size": -1}, "Out", ("Score",), ()),
        ("conv3d", {"Input": [_u(rng, (4, 8, 8, 16, 16))],
                    "Filter": [_u(rng, (16, 8, 3, 3, 3), -0.2, 0.2)]},
         {"paddings": [1, 1, 1]}, "Output", ("Input", "Filter"), ()),
        ("conv3d_transpose", {"Input": [_u(rng, (4, 16, 4, 8, 8))],
                              "Filter": [_u(rng, (16, 8, 2, 2, 2), -0.2,
                                            0.2)]},
         {"strides": [2, 2, 2]}, "Output", ("Input", "Filter"), ()),
        ("pool3d", {"X": [_u(rng, (4, 16, 8, 16, 16))]},
         {"pooling_type": "avg", "ksize": [2, 3, 3], "strides": [2, 2, 2],
          "paddings": [0, 1, 1]}, "Out", ("X",), ()),
        ("max_pool2d_with_index", {"X": [_u(rng, (8, 16, 32, 32))]},
         {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]}, "Out",
         ("X",), ("Mask",)),
        ("max_pool2d_with_index", {"X": [ties]},
         {"ksize": [2, 2], "strides": [2, 2]}, "Out", ("X",),
         ("Out", "Mask", "grad")),
        ("max_pool3d_with_index", {"X": [_u(rng, (4, 8, 8, 16, 16))]},
         {"ksize": [2, 2, 2], "strides": [2, 2, 2]}, "Out", ("X",),
         ("Mask",)),
        ("unpool", {"X": [_u(rng, (8, 16, 16, 16))],
                    "Indices": [(np.arange(16 * 16).reshape(16, 16) // 16
                                 * 64 + np.arange(16) * 2)[None, None]
                                .repeat(8, 0).repeat(16, 1)]},
         {"ksize": [2, 2], "strides": [2, 2]}, "Out", ("X",), ()),
        ("spp", {"X": [_u(rng, (8, 64, 14, 14))]},
         {"pyramid_height": 3, "pooling_type": "max"}, "Out", ("X",), ()),
        ("crop", {"X": [_u(rng, (8, 16, 64, 64))]},
         {"shape": [48, 40], "offsets": [5, 9]}, "Out", ("X",), ("Out",)),
        ("norm", {"X": [_u(rng, (8, 512, 38, 38))],
                  "Scale": [np.full((512,), 20.0, np.float32)]}, {}, "Out",
         ("X", "Scale"), ()),
        ("bilinear_interp", {"X": [_u(rng, (8, 21, 32, 32))]},
         {"out_h": 64, "out_w": 64}, "Out", ("X",), ()),
        ("rotate", {"X": [_u(rng, (8, 16, 32, 48))]}, {}, "Out", ("X",),
         ("Out",)),
        ("scale_sub_region", {"X": [_u(rng, (8, 16, 32, 32))],
                              "Indices": [np.tile(np.asarray(
                                  [[2, 9, 3, 20, 5, 30]], np.int32),
                                  (8, 1))]}, {"value": 2.0}, "Out", ("X",),
         ()),
        ("dynamic_conv2d", {"X": [_u(rng, (16, 8, 32, 32))],
                            "Filter": [_u(rng, (16, 16 * 8 * 3 * 3), -0.2,
                                          0.2)]},
         {"num_filters": 16, "num_channels": 8, "kh": 3, "kw": 3, "ph": 1,
          "pw": 1}, "Out", ("X", "Filter"), ()),
        ("nce", {"Input": [_u(rng, (W2V_B, W2V_HID))],
                 "Label": [rng.randint(0, W2V_V, (W2V_B, 1))],
                 "Weight": [_u(rng, (W2V_V, W2V_HID), -0.1, 0.1)],
                 "Bias": [_u(rng, (W2V_V,), -0.1, 0.1)],
                 "CustomSamples": [rng.randint(0, W2V_V, (W2V_B, W2V_NEG))]},
         {"num_total_classes": W2V_V, "num_neg_samples": W2V_NEG}, "Cost",
         ("Input", "Weight", "Bias"), ()),
        ("hsigmoid", {"X": [_u(rng, (W2V_B, W2V_HID))],
                      "Label": [rng.randint(0, W2V_V, (W2V_B, 1))],
                      "W": [_u(rng, (W2V_V - 1, W2V_HID), -0.1, 0.1)],
                      "Bias": [_u(rng, (W2V_V - 1,), -0.1, 0.1)]},
         {"num_classes": W2V_V}, "Cost", ("X", "W", "Bias"), ()),
        ("sampling_id", {"X": [np.eye(1000, dtype=np.float32)[
            rng.randint(0, 1000, 4096)]]}, {}, "Out", (), ("Out",)),
    ]


def corpus_run(dev, op, ins, attrs, slot, grad, cot_seed):
    """One op's lowering on `dev` over the numpy inputs, and with `grad`
    the gradients of output slot `slot` (every tensor of it) under
    seeded cotangents: (outputs, {input slot: [grads]})."""
    tins = {k: [torch.as_tensor(np.asarray(v)).to(dev) for v in vs]
            for k, vs in ins.items()}
    leaves = []
    for s in grad:
        tins[s] = [t.clone().requires_grad_(True) for t in tins[s]]
        leaves += tins[s]
    out = lower_on(op, tins, attrs, dev, grad=bool(grad))
    grads = {}
    if grad:
        ys = out[slot]
        crng = np.random.RandomState(cot_seed)
        cots = [torch.from_numpy(crng.randn(*y.shape).astype(np.float32))
                .to(dev) for y in ys]
        gs = torch.autograd.grad(ys, leaves, cots, allow_unused=True)
        i = 0
        for s in grad:
            n = len(tins[s])
            grads[s] = [torch.zeros_like(t) if g is None else g.detach()
                        for t, g in zip(tins[s], gs[i:i + n])]
            i += n
    return ({k: [v.detach() for v in vs] for k, vs in out.items()}, grads)


def chi2_ok(counts, probs):
    """Pearson's chi-square statistic of `counts` against `probs` below
    the distribution's 0.999 quantile (Wilson-Hilferty):
    (ok, statistic, quantile)."""
    counts = np.asarray(counts, np.float64)
    exp = counts.sum() * np.asarray(probs, np.float64)
    stat = float(np.sum((counts - exp) ** 2 / exp))
    k = len(probs) - 1
    q = k * (1 - 2 / (9 * k) + CHI2_Z * np.sqrt(2 / (9 * k))) ** 3
    return stat < q, stat, float(q)


def corpus_sweep_phase(smi):
    """Phase 40 (a): each of the 57 ops on the card against the same
    lowering on the CPU over the same seeded inputs: every output within
    OPS_FWD_TOL of its largest element (exactly where the op is integer
    or selecting), each listed gradient within OPS_GRAD_TOL of its
    largest; `where` raises on the card as in the reference; the random
    ops by their distributions."""
    rng = np.random.RandomState(SEED + 80)
    res, worst_fwd, worst_grad = {}, 0.0, 0.0
    ops = set()
    for i, (op, ins, attrs, slot, grad, exact) in enumerate(
            corpus_cases(rng)):
        name = op if op not in res else f"{op}_ties"
        card, gcard = corpus_run(CARD, op, ins, attrs, slot, grad, i)
        cpu, gcpu = corpus_run("cpu", op, ins, attrs, slot, grad, i)
        fwd = {}
        for s, vals in cpu.items():
            for j, (c, r) in enumerate(zip(card[s], vals)):
                c = c.cpu()
                if tuple(c.shape) != tuple(r.shape) or c.dtype != r.dtype:
                    raise AssertionError(f"{op} {s}: {tuple(c.shape)} "
                                         f"{c.dtype} on the card, "
                                         f"{tuple(r.shape)} {r.dtype} on "
                                         f"the CPU")
                if s in exact or not r.is_floating_point():
                    if not torch.equal(c, r):
                        raise AssertionError(f"{op} {s}: not equal to the "
                                             f"CPU's")
                    fwd[f"{s}{j}"] = 0.0
                else:
                    fwd[f"{s}{j}"] = max_rel(c, r)
        gerr = {}
        for s in grad:
            for j, (c, r) in enumerate(zip(gcard[s], gcpu[s])):
                if "grad" in exact:
                    if not torch.equal(c.cpu(), r):
                        raise AssertionError(f"{op} {s} gradient: not "
                                             f"equal to the CPU's")
                gerr[f"{s}{j}"] = max_rel(c, r)
        f, g = max(fwd.values(), default=0.0), max(gerr.values(),
                                                    default=0.0)
        if not (f <= OPS_FWD_TOL and g <= OPS_GRAD_TOL):
            raise AssertionError(f"{op}: the card differs from the CPU: "
                                 f"forward {fwd}, gradients {gerr}")
        worst_fwd, worst_grad = max(worst_fwd, f), max(worst_grad, g)
        shapes = {k: [list(np.shape(v)) for v in vs]
                  for k, vs in ins.items()}
        res[name] = {"shapes": shapes, "fwd_err": f, "grad_err": g,
                     "exact": sorted(exact)}
        ops.add(op)
    # the tied window: each of the four maxima gets a quarter
    x = torch.zeros((1, 1, 4, 4), device=CARD)
    x[0, 0, :2, :2] = 1.0
    x.requires_grad_(True)
    out = lower_on("max_pool2d_with_index", {"X": [x]},
                   {"ksize": [2, 2], "strides": [2, 2]}, CARD, grad=True)
    g, = torch.autograd.grad(out["Out"][0].sum(), [x])
    if not (torch.all(g[0, 0, :2, :2] == 0.25)
            and int(out["Mask"][0].reshape(-1)[0]) == 0):
        raise AssertionError("max_pool2d_with_index: a tied window's "
                             f"gradient {g[0, 0, :2, :2].tolist()}")
    # where raises on the card as the reference does
    try:
        lower_on("where", {"Condition": [torch.ones(4, dtype=torch.bool,
                                                      device=CARD)]}, {},
                 CARD)
        raise AssertionError("where did not raise")
    except NotImplementedError:
        ops.add("where")
    # print reads its values on the host: one sync
    prints = call_syncs(lambda: lower_on(
        "print", {"X": [torch.ones(3, device=CARD)]},
        {"message": "phase 40 print sync"}, CARD))
    res["print"]["syncs"] = prints
    random = random_ops_phase(rng, smi)
    ops.update(("nce", "sampling_id"))
    if len(ops) != 57:
        raise AssertionError(f"phase 40 (a) held {len(ops)} ops, not 57")
    log(f"corpus ops: {len(ops)} ops held on the card against the CPU, the "
        f"worst forward {worst_fwd:.2e} of the largest element (tol "
        f"{OPS_FWD_TOL:g}), the worst gradient {worst_grad:.2e} (tol "
        f"{OPS_GRAD_TOL:g}); exact: the integer and selecting outputs, the "
        f"with_index Masks, a tied window's gradient split in quarters; "
        f"where raised; print {prints} sync a call | {smi}")
    return {"ops": res, "random": random, "worst_fwd": worst_fwd,
            "worst_grad": worst_grad, "n_ops": len(ops)}


def random_ops_phase(rng, smi):
    """(a)'s random ops: nce without CustomSamples draws its negatives
    from the generator on the card, in [0, V) and uniform by chi-square,
    its cost the CPU's with them given as CustomSamples; with
    CustomSamples it draws nothing (the generator's state unchanged);
    sampling_id: one-hot rows give their class exactly, a fixed
    probability row's draws pass a chi-square test."""
    B, V, k = 4096, 1000, W2V_NEG
    ins = {"Input": [_u(rng, (B, 64))],
           "Label": [rng.randint(0, V, (B, 1))],
           "Weight": [_u(rng, (V, 64), -0.1, 0.1)]}
    attrs = {"num_total_classes": V, "num_neg_samples": k}
    gen = torch.Generator(device=CARD).manual_seed(SEED + 81)
    twin = torch.Generator(device=CARD).set_state(gen.get_state())
    tins = {s: [torch.as_tensor(v[0]).to(CARD)] for s, v in ins.items()}
    cost = lower_on("nce", tins, attrs, CARD, generator=gen)["Cost"][0]
    neg = torch.randint(0, V, (B, k), generator=twin, dtype=torch.int64,
                        device=CARD).cpu().numpy()
    ok_range = neg.min() >= 0 and neg.max() < V
    ok, stat, q = chi2_ok(np.bincount(neg.reshape(-1), minlength=V),
                          [1.0 / V] * V)
    ref = lower_on("nce", {**ins, "CustomSamples": [neg]}, attrs,
                   "cpu")["Cost"][0]
    nce_err = max_rel(cost.cpu(), ref)
    state = gen.get_state()
    lower_on("nce", {**tins, "CustomSamples": [neg]}, attrs, CARD,
             generator=gen)
    untouched = torch.equal(state, gen.get_state())
    probs = np.asarray([0.02, 0.08, 0.1, 0.2, 0.25, 0.35], np.float32)
    n = 100000
    ids = lower_on("sampling_id", {"X": [np.tile(probs, (n, 1))]}, {},
                   CARD, generator=gen)["Out"][0].cpu().numpy()
    sok, sstat, sq = chi2_ok(np.bincount(ids, minlength=6), probs)
    log(f"random ops: nce without CustomSamples, B {B} x {k} negatives of "
        f"V {V} drawn on the card: in range {ok_range}, chi-square "
        f"{stat:.1f} < {q:.1f} ({ok}), the cost vs the CPU's on the same "
        f"negatives {nce_err:.2e}; with CustomSamples the generator is "
        f"untouched ({untouched}); sampling_id over {n} rows of "
        f"{probs.tolist()}: chi-square {sstat:.2f} < {sq:.2f} ({sok}) | "
        f"{smi}")
    if not (ok_range and ok and nce_err <= OPS_FWD_TOL and untouched
            and sok):
        raise AssertionError("phase 40 (a): a random op's draws fail")
    return {"nce_chi2": stat, "nce_chi2_q": q, "nce_cost_err": nce_err,
            "sampling_id_chi2": sstat, "sampling_id_chi2_q": sq}


def w2v_program(head, custom=False):
    """The book's N-gram model (models/word2vec.py::ngram_lm's body) with
    one of three heads, Adam: (main, startup, cost)."""
    pt.framework.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        words = [pt.layers.data(f"w{i}", [1], dtype="int64")
                 for i in range(4)]
        nxt = pt.layers.data("next", [1], dtype="int64")
        embs = [pt.layers.embedding(
            input=w, size=[W2V_V, W2V_EMB],
            param_attr=pt.ParamAttr(name="shared_w")) for w in words]
        hidden = pt.layers.fc(input=pt.layers.concat(input=embs, axis=1),
                              size=W2V_HID, act="sigmoid")
        if head == "softmax":
            probs = pt.layers.fc(input=hidden, size=W2V_V, act="softmax")
            cost = pt.layers.cross_entropy(probs, nxt)
        elif head == "nce":
            neg = (pt.layers.data("neg", [W2V_NEG], dtype="int64")
                   if custom else None)
            cost = pt.layers.nce(hidden, nxt, W2V_V,
                                 num_neg_samples=W2V_NEG,
                                 custom_samples=neg)
        else:
            cost = pt.layers.hsigmoid(hidden, nxt, W2V_V)
        avg = pt.layers.mean(cost)
        pt.AdamOptimizer(W2V_LR).minimize(avg)
    main.seed = startup.seed = SEED + 90
    return main, startup, avg


def w2v_feeds(rng):
    """W2V_BATCHES synthetic batches: the next word is the sum of the
    four context ids modulo V (a learnable rule, as
    tests/test_book_models.py's word2vec)."""
    feeds = []
    for _ in range(W2V_BATCHES):
        ctx = [rng.randint(0, W2V_V, (W2V_B, 1)).astype(np.int64)
               for _ in range(4)]
        f = {f"w{i}": c for i, c in enumerate(ctx)}
        f["next"] = (sum(c[:, 0] for c in ctx) % W2V_V).astype(
            np.int64)[:, None]
        feeds.append(f)
    return feeds


def w2v_head_phase(head, feeds, smi):
    """Phase 40 (b), one head: step 1 op by op against the CPU (NCE with
    the same negatives given as CustomSamples), then W2V_STEPS Adam
    steps on the card (the mean loss of the last 10 below that of the
    first 10); examples/s, device ms, busy share and syncs a step; no
    TPU kernel launched."""
    use_full_f32()
    what = f"word2vec {head}"
    main, startup, avg = w2v_program(head)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    # step 1 op by op on the CPU's values, from the same state
    cmain, _, _ = w2v_program(head, custom=True) if head == "nce" else (
        main, None, None)
    feed1 = dict(feeds[0])
    if head == "nce":
        feed1["neg"] = np.random.RandomState(SEED + 91).randint(
            0, W2V_V, (W2V_B, W2V_NEG)).astype(np.int64)
    errs, _ = op_by_op_step(cmain, feed1, scope_of(tensors_of(scope), "cpu"),
                            what, SEQ_CPU_TOL)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()                       # the main path starts here
    losses, walls = [], []
    for i in range(W2V_STEPS):
        t0 = time.perf_counter()
        loss, = exe.run(main, feed=feeds[i % W2V_BATCHES], fetch_list=[avg],
                        scope=scope)
        walls.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(loss.ravel()[0]))
    counts = read_counts()              # the main path ends here
    peak = torch.cuda.max_memory_allocated() / 2**20
    check_counts(counts, launches_of(), f"{what} (no TPU kernel on this "
                 "path)")
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    med, lo, hi = median_lo_hi(walls[10:])
    prof = whole_profile(exe, main, feeds[0], avg, scope, med,
                         f"{what} step", smi)
    syncs = ctr_step_syncs(exe, main, feeds[0], scope)
    device = ("not measured" if prof["device_ms"] is None else
              f"{prof['device_ms']:.3f} ms (busy {prof['busy']:.3f})")
    log(f"{what}: V {W2V_V}, emb {W2V_EMB}, hidden {W2V_HID}, B {W2V_B}, "
        f"Adam({W2V_LR:g}), {W2V_STEPS} steps: mean loss of the first 10 "
        f"{first:.4f} -> of the last 10 {last:.4f}; "
        f"{W2V_B / (med / 1e3):.1f} examples/s (step {med:.3f} ms median, "
        f"{lo:.3f}-{hi:.3f}), device {device}, "
        f"{prof['kernels_per_step']} kernels a step ({prof['kernels_lost']}"
        f" lost, capture {prof['captures']}), {syncs} syncs a step, peak "
        f"{peak:.1f} MiB; step 1 op by op: the worst of {len(errs)} outputs "
        f"{max(errs.values()):.2e} (tol {SEQ_CPU_TOL:g}); top ops "
        f"{prof['top_op_types_ms']} | {smi}")
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError(f"{what}: the loss did not fall: {first} -> "
                             f"{last}")
    return counts, {
        "V": W2V_V, "B": W2V_B, "steps": W2V_STEPS, "lr": W2V_LR,
        "loss_first10": first, "loss_last10": last,
        "examples_per_s": W2V_B / (med / 1e3), "step_ms": med,
        "step_ms_lo": lo, "step_ms_hi": hi, "device_ms": prof["device_ms"],
        "busy": prof["busy"], "kernels_per_step": prof["kernels_per_step"],
        "kernels_lost": prof["kernels_lost"],
        "profile_captures": prof["captures"], "syncs_per_step": syncs,
        "peak_mib": peak, "op_by_op_worst": max(errs.values()),
        "top_op_types_ms": prof["top_op_types_ms"]}


def nets_phase(smi):
    """Phase 40 (c): nets.glu over [512, 2 x 512] and
    nets.scaled_dot_product_attention over q [64, 128, 64], k / v [64,
    256, 64], forward and their input gradients, on the card against
    the CPU; K1 is launched no time (matmul, softmax, matmul)."""
    pt.framework.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        a = pt.layers.data("a", [1024], dtype="float32",
                           stop_gradient=False)
        q = pt.layers.data("q", [128, 64], dtype="float32",
                           stop_gradient=False)
        k = pt.layers.data("k", [256, 64], dtype="float32",
                           stop_gradient=False)
        v = pt.layers.data("v", [256, 64], dtype="float32",
                           stop_gradient=False)
        g = pt.nets.glu(a, dim=-1)
        att = pt.nets.scaled_dot_product_attention(q, k, v)
        loss = pt.layers.elementwise_add(
            pt.layers.reduce_sum(pt.layers.square(g)),
            pt.layers.reduce_sum(pt.layers.square(att)))
        grads = pt.backward.calc_gradient(loss, [a, q, k, v])
    rng = np.random.RandomState(SEED + 92)
    feed = {"a": _u(rng, (512, 1024)), "q": _u(rng, (64, 128, 64)),
            "k": _u(rng, (64, 256, 64)), "v": _u(rng, (64, 256, 64))}
    fetch = [g, att] + grads
    zero_counts()                       # the main path starts here
    card = pt.Executor().run(main, feed=feed, fetch_list=fetch)
    counts = read_counts()              # the main path ends here
    check_counts(counts, launches_of(), "nets.glu / nets."
                 "scaled_dot_product_attention (no TPU kernel)")
    cpu = pt.Executor(pt.CPUPlace()).run(main, feed=feed, fetch_list=fetch)
    names = ["glu", "sdpa", "d_a", "d_q", "d_k", "d_v"]
    errs = {n: max_rel(c, r) for n, c, r in zip(names, card, cpu)}
    log(f"nets: glu [512, 1024] and scaled_dot_product_attention q [64, "
        f"128, 64] k / v [64, 256, 64] on the card against the CPU "
        f"{ {n: f'{e:.2e}' for n, e in errs.items()} } (tol forward "
        f"{OPS_FWD_TOL:g}, gradients {OPS_GRAD_TOL:g}); K1 launched "
        f"{counts['flash_attn_fwd']} times | {smi}")
    if not (errs["glu"] <= OPS_FWD_TOL and errs["sdpa"] <= OPS_FWD_TOL
            and all(errs[n] <= OPS_GRAD_TOL for n in names[2:])):
        raise AssertionError(f"nets: the card differs from the CPU: {errs}")
    return counts, errs


def vision_fwd_bwd(case, ins, dev):
    """(d): one case's op forward + backward on `dev` under a ones
    cotangent: (outputs, the differentiated output, the gradients of the
    `grad` inputs). `then`: a second op fed by the first's outputs (the
    pool's Mask into unpool)."""
    tins = {k: [torch.as_tensor(v).to(dev) for v in vs]
            for k, vs in ins.items()}
    leaves = [t.requires_grad_(True) for s in case["grad"]
              for t in tins[s]]
    out = lower_on(case["op"], tins, case["attrs"], dev, grad=True)
    y = out[case["slot"]][0]
    if case.get("then") is not None:
        top, tattrs = case["then"]
        y = lower_on(top, {"X": [y], "Indices": [out["Mask"][0]]}, tattrs,
                     dev, grad=True)["Out"][0]
    gs = torch.autograd.grad(y, leaves, torch.ones_like(y))
    return out, y, gs


def legacy_vision_case(case, card_ins, smi):
    """(d): one case at its published shape on the card (forward +
    backward ms median of 3, peak MiB), and at batch 1 against the CPU
    (forward OPS_FWD_TOL of the largest element, gradients OPS_GRAD_TOL,
    Mask exactly)."""
    name = case["name"]
    ms = card_wall_ms(lambda: vision_fwd_bwd(case, card_ins, CARD))
    peak = call_peak_mib(lambda: vision_fwd_bwd(case, card_ins, CARD))
    c_out, c_y, c_g = vision_fwd_bwd(case, case["cpu"], CARD)
    r_out, r_y, r_g = vision_fwd_bwd(case, case["cpu"], "cpu")
    fwd = max_rel(c_y.detach(), r_y.detach())
    gerr = max(max_rel(c, r) for c, r in zip(c_g, r_g))
    mask_ok = ("Mask" not in r_out
               or torch.equal(c_out["Mask"][0].cpu(), r_out["Mask"][0]))
    shape = list(np.shape(next(iter(case["card"].values()))[0]))
    log(f"{name}: {shape} forward + backward {ms:.3f} ms, peak "
        f"{peak:.1f} MiB; batch 1 against the CPU: forward {fwd:.2e}, "
        f"gradient {gerr:.2e}, Mask exact {mask_ok} | {smi}")
    if not (fwd <= OPS_FWD_TOL and gerr <= OPS_GRAD_TOL and mask_ok):
        raise AssertionError(f"{name}: the card differs from the CPU")
    return {"shape": shape, "ms": ms, "peak_mib": peak, "fwd_err": fwd,
            "grad_err": gerr}


def legacy_vision_phase(smi):
    """Phase 40 (d): C3D's conv1 / pool1 / conv2 / pool2 and the inverse
    of conv2, SegNet's first pool with index into its last unpool, spp
    on VGG16's conv5 map, bilinear_interp x 2 on a 21-class score map;
    no TPU kernel launched. The launch counts hold one forward + backward
    of each case at its published shape and nothing else; the timing,
    the peak and the CPU check run after."""
    use_full_f32()
    rng = np.random.RandomState(SEED + 93)

    gen = np.random.default_rng(SEED + 93)

    def two(shape, b):
        """A [b, ...] f32 input in [-1, 1) and its first sample."""
        x = gen.random((b,) + shape[1:], dtype=np.float32) * 2 - 1
        return x, x[:1].copy()

    c1x, c1s = two((0, 3, 16, 112, 112), C3D_B)
    c1w = _u(rng, (64, 3, 3, 3, 3), -0.2, 0.2)
    p1x, p1s = two((0, 64, 16, 112, 112), C3D_B)
    c2x, c2s = two((0, 64, 16, 56, 56), C3D_B)
    c2w = _u(rng, (128, 64, 3, 3, 3), -0.05, 0.05)
    p2x, p2s = two((0, 128, 16, 56, 56), C3D_B)
    tx, ts = two((0, 128, 16, 56, 56), C3D_B)
    tw = _u(rng, (128, 64, 3, 3, 3), -0.05, 0.05)
    sx, ss = two((0, 64, 360, 480), SEGNET_B)
    vx, vs = two((0, 512, 14, 14), SPP_B)
    bx, bs = two((0, 21, 64, 64), INTERP_B)
    conv = {"paddings": [1, 1, 1]}
    conv_grad = ("Input", "Filter")

    def case(name, op, card, cpu, attrs, slot, grad, then=None):
        return {"name": name, "op": op, "card": card, "cpu": cpu,
                "attrs": attrs, "slot": slot, "grad": grad, "then": then}

    cases = {
        "c3d_conv1": case(
            "C3D conv1 (conv3d 3 -> 64, 3 x 3 x 3)", "conv3d",
            {"Input": [c1x], "Filter": [c1w]},
            {"Input": [c1s], "Filter": [c1w]}, conv, "Output", conv_grad),
        "c3d_pool1": case(
            "C3D pool1 (pool3d max 1 x 2 x 2)", "pool3d", {"X": [p1x]},
            {"X": [p1s]}, {"pooling_type": "max", "ksize": [1, 2, 2],
                           "strides": [1, 2, 2]}, "Out", ("X",)),
        "c3d_conv2": case(
            "C3D conv2 (conv3d 64 -> 128, 3 x 3 x 3)", "conv3d",
            {"Input": [c2x], "Filter": [c2w]},
            {"Input": [c2s], "Filter": [c2w]}, conv, "Output", conv_grad),
        "c3d_pool2": case(
            "C3D pool2 (pool3d max 2 x 2 x 2)", "pool3d", {"X": [p2x]},
            {"X": [p2s]}, {"pooling_type": "max", "ksize": [2, 2, 2],
                           "strides": [2, 2, 2]}, "Out", ("X",)),
        "c3d_conv2_transpose": case(
            "C3D conv2 inverse (conv3d_transpose 128 -> 64)",
            "conv3d_transpose", {"Input": [tx], "Filter": [tw]},
            {"Input": [ts], "Filter": [tw]}, conv, "Output", conv_grad),
        "segnet_pool_unpool": case(
            "SegNet pool1 with index -> unpool (64 x 360 x 480, 2 x 2 "
            "stride 2)", "max_pool2d_with_index", {"X": [sx]}, {"X": [ss]},
            {"ksize": [2, 2], "strides": [2, 2]}, "Out", ("X",),
            then=("unpool", {"ksize": [2, 2], "strides": [2, 2]})),
        "vgg16_spp": case(
            "spp on VGG16 conv5 (512 x 14 x 14, pyramid 3)", "spp",
            {"X": [vx]}, {"X": [vs]}, {"pyramid_height": 3,
                                       "pooling_type": "max"}, "Out",
            ("X",)),
        "bilinear_interp_x2": case(
            "bilinear_interp x 2 (21 x 64 x 64 -> 128 x 128)",
            "bilinear_interp", {"X": [bx]}, {"X": [bs]},
            {"out_h": 128, "out_w": 128}, "Out", ("X",)),
    }
    card_ins = {key: {k: [torch.as_tensor(v).to(CARD) for v in vs]
                      for k, vs in c["card"].items()}
                for key, c in cases.items()}
    zero_counts()                       # the main path starts here
    for key, c in cases.items():
        vision_fwd_bwd(c, card_ins[key], CARD)
    torch.cuda.synchronize()
    counts = read_counts()              # the main path ends here
    check_counts(counts, launches_of(), "the legacy vision ops (no TPU "
                 "kernel)")
    res = {key: legacy_vision_case(c, card_ins[key], smi)
           for key, c in cases.items()}
    return counts, res


def corpus_phase(smi):
    """Phase 40."""
    t0 = time.perf_counter()
    use_full_f32()
    sweep = corpus_sweep_phase(smi)
    paths, w2v = {}, {}
    feeds = w2v_feeds(np.random.RandomState(SEED + 94))
    for head in W2V_HEADS:
        paths[f"word2vec_{head}"], w2v[head] = w2v_head_phase(head, feeds,
                                                              smi)
    paths["nets_glu_sdpa"], nets = nets_phase(smi)
    paths["legacy_vision"], vision = legacy_vision_phase(smi)
    secs = time.perf_counter() - t0
    log(f"corpus: phase 40 in {secs:.1f} s | {smi}")
    return paths, {"sweep": sweep, "word2vec": w2v, "nets": nets,
                   "legacy_vision": vision, "seconds": secs}


# -- phase 41: the legacy front end ------------------------------------------

# (a) a legacy config after the published benchmark config
# benchmark/paddle/image/alexnet.py: 227 x 227 x 3, 1000 classes, B 128,
# Momentum(0.9), lr 0.01 / B, L2 0.0005 x B; its provider draws images and
# labels from a seed
LEGACY_ALEXNET = """\
from paddle.trainer_config_helpers import *

height = width = get_config_arg('height', int, 227)
num_class = get_config_arg('num_class', int, 1000)
batch_size = get_config_arg('batch_size', int, 128)
gp = get_config_arg('layer_num', int, 1)
num_samples = get_config_arg('num_samples', int, 1280)
drop_rate = get_config_arg('drop_rate', float, 0.5)

define_py_data_sources2(
    "train.list", "test.list", module="alexnet_provider", obj="process",
    args={"height": height, "width": width, "num_class": num_class,
          "num_samples": num_samples, "num_test_samples": 256})

settings(batch_size=batch_size, learning_rate=0.01 / batch_size,
         learning_method=MomentumOptimizer(0.9),
         regularization=L2Regularization(0.0005 * batch_size))

net = data_layer('data', size=height * width * 3)
net = img_conv_layer(input=net, filter_size=11, num_channels=3,
                     num_filters=96, stride=4, padding=1)
net = img_cmrnorm_layer(input=net, size=5, scale=0.0001, power=0.75)
net = img_pool_layer(input=net, pool_size=3, stride=2)
net = img_conv_layer(input=net, filter_size=5, num_filters=256, stride=1,
                     padding=2, groups=gp)
net = img_cmrnorm_layer(input=net, size=5, scale=0.0001, power=0.75)
net = img_pool_layer(input=net, pool_size=3, stride=2)
net = img_conv_layer(input=net, filter_size=3, num_filters=384, stride=1,
                     padding=1)
net = img_conv_layer(input=net, filter_size=3, num_filters=384, stride=1,
                     padding=1, groups=gp)
net = img_conv_layer(input=net, filter_size=3, num_filters=256, stride=1,
                     padding=1, groups=gp)
net = img_pool_layer(input=net, pool_size=3, stride=2)
net = fc_layer(input=net, size=4096, act=ReluActivation(),
               layer_attr=ExtraAttr(drop_rate=drop_rate))
net = fc_layer(input=net, size=4096, act=ReluActivation(),
               layer_attr=ExtraAttr(drop_rate=drop_rate))
net = fc_layer(input=net, size=num_class, act=SoftmaxActivation())
lab = data_layer('label', num_class)
outputs(cross_entropy(input=net, label=lab))
"""
LEGACY_ALEXNET_PROVIDER = """\
import numpy as np
from paddle.trainer.PyDataProvider2 import *


def hook(settings, height, width, num_class, num_samples, num_test_samples,
         is_train, **kwargs):
    settings.dim = height * width * 3
    settings.num_class = num_class
    settings.count = num_samples if is_train else num_test_samples
    settings.seed = 0 if is_train else 1
    settings.slots = [dense_vector(settings.dim), integer_value(num_class)]


@provider(init_hook=hook)
def process(settings, file_list):
    rng = np.random.default_rng(settings.seed)
    for _ in range(settings.count):
        yield (rng.random(settings.dim, dtype=np.float32),
               int(rng.integers(settings.num_class)))
"""
LEGACY_SIDE, LEGACY_CLASSES, LEGACY_B = 227, 1000, 128
LEGACY_SAMPLES, LEGACY_TIME_BATCHES = 1280, 20
LEGACY_LOSS_RTOL, LEGACY_OP_TOL = 1e-5, 1e-4
LEGACY_TIMED_STEPS = 5
# (c) the book's recognize-digits conv net through the v2 API: B 128, one
# pass of the synthetic mnist train set (8192), Momentum(0.1 / 128, 0.9);
# the first V2_CHECKED costs against the CPU's from the same weights
V2_B, V2_SAMPLES, V2_LR, V2_CHECKED, V2_TOL = 128, 8192, 0.1 / 128, 3, 1e-5
# (d) the memory decoder of tests/test_legacy_generation.py at the widths
# of the reference's v1 seqToseq demo (512 wide, a 30000-word dictionary,
# beam 3); max_length 50, cut from the demo's 250
GEN_B, GEN_DIM, GEN_VOCAB, GEN_BEAM, GEN_MAX_LEN = 64, 512, 30000, 3, 50
GEN_SCORE_RTOL, GEN_TIE, GEN_MAX_TIE_ROWS = 1e-5, 1e-5, 2
LEGACY_GEN = """\
from paddle.trainer_config_helpers import *

dim = get_config_arg('dim', int, 512)
vocab = get_config_arg('vocab', int, 30000)
beam = get_config_arg('beam', int, 3)
max_length = get_config_arg('max_length', int, 50)
settings(batch_size=64, learning_rate=0)
ctx = data_layer(name='ctx', size=dim)
gen_in = [StaticInput(input=ctx, size=dim),
          GeneratedInput(size=vocab, embedding_name='gen_emb',
                         embedding_size=dim)]


def step(ctx_in, word_emb):
    state = memory(name='dec', size=dim)
    merged = mixed_layer(size=3 * dim,
                         input=[full_matrix_projection(input=ctx_in),
                                full_matrix_projection(input=word_emb)])
    h = gru_step_layer(input=merged, output_mem=state, size=dim,
                       name='dec')
    with mixed_layer(size=vocab, act=SoftmaxActivation()) as out:
        out += full_matrix_projection(input=h)
    return out


outputs(beam_search(name='gen', step=step, input=gen_in, bos_id=0,
                    eos_id=1, beam_size=beam, max_length=max_length))
"""
# (e) the beam cost: B 64 sequences of 3 to 8 sentences of 3 to 8 words
# and spans of 8 to 24 scores, 3 expansions, beam 3
BC_B, BC_S, BC_T, BC_K, BC_TOL = 64, 8, 8, 3, 1e-6


def run_cli(args):
    """`python -m paddle_tpu_torch <args>` in this process (runpy runs
    the package's __main__ as the interpreter would), so the kernel
    wrappers' launch counters see its work. Returns (exit code, stdout)."""
    import contextlib
    import io
    import runpy
    buf, argv = io.StringIO(), sys.argv
    sys.argv = ["paddle_tpu_torch", *args]
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_module("paddle_tpu_torch", run_name="__main__",
                             alter_sys=True)
        rc = 0
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else (0 if e.code is None
                                                     else 1)
    finally:
        sys.argv = argv
    return rc, buf.getvalue()


def last_json(out, what):
    for line in reversed(out.strip().splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    raise AssertionError(f"{what}: no JSON record in its output")


def legacy_args(**args):
    """The AlexNet config's args at this phase's sizes."""
    return {"height": LEGACY_SIDE, "num_class": LEGACY_CLASSES,
            "batch_size": LEGACY_B, **args}


def cli_config_args(**args):
    return "--config_args=" + ",".join(
        f"{k}={v}" for k, v in legacy_args(**args).items())


def legacy_cli_phase(tmp, smi):
    """(a) train, time and test through the CLI, on the card."""
    cfg = os.path.join(tmp, "alexnet.py")
    save = os.path.join(tmp, "alexnet_out")
    args = cli_config_args(layer_num=1, num_samples=LEGACY_SAMPLES)
    zero_counts()                       # the main path starts here
    t0 = time.perf_counter()
    rc, out = run_cli(["train", f"--config={cfg}", "--num_passes=1",
                       "--log_period=1", f"--save_dir={save}", args])
    train_s = time.perf_counter() - t0
    costs = [float(ln.split("Cost ")[1].split(",")[0])
             for ln in out.splitlines() if ", Cost " in ln]
    rates = [float(ln.rsplit(", ", 1)[1].split()[0])
             for ln in out.splitlines() if ", Cost " in ln]
    if rc != 0 or len(costs) != LEGACY_SAMPLES // LEGACY_B \
            or not np.isfinite(costs).all() \
            or not os.path.isdir(os.path.join(save, "pass-00000")):
        raise AssertionError(f"legacy train job: rc {rc}, costs {costs}, "
                             f"output tail {out[-800:]}")
    test_line = next(ln for ln in out.splitlines() if "test cost" in ln)
    n_time = LEGACY_TIME_BATCHES * LEGACY_B
    rc, out = run_cli(["time", f"--config={cfg}",
                       f"--num_batches={LEGACY_TIME_BATCHES}",
                       cli_config_args(layer_num=1, num_samples=n_time)])
    timed = last_json(out, "legacy time job")
    if rc != 0 or timed.get("batches") != LEGACY_TIME_BATCHES:
        raise AssertionError(f"legacy time job: rc {rc}, {out[-800:]}")
    rc, out = run_cli(["test", f"--config={cfg}", args,
                       f"--init_model_path={save}/pass-00000"])
    tested = last_json(out, "legacy test job")
    if rc != 0 or not np.isfinite(tested.get("cost", np.nan)):
        raise AssertionError(f"legacy test job: rc {rc}, {out[-800:]}")
    counts = read_counts()              # the main path ends here
    check_counts(counts, launches_of(), "legacy AlexNet through the CLI "
                 "(no TPU kernel on this path)")
    log(f"legacy AlexNet (layer_num 1, {LEGACY_SIDE} x {LEGACY_SIDE}, "
        f"{LEGACY_CLASSES} classes, B {LEGACY_B}) through python -m paddle_tpu_torch on the card: train "
        f"{len(costs)} batches in {train_s:.1f} s, costs {costs[0]:.6f} -> "
        f"{costs[-1]:.6f}, the job's last rate {rates[-1]:.1f} samples/s, "
        f"'{test_line}', pass-00000 saved; time: "
        f"{timed['ms_per_batch']} ms a batch, {timed['samples_per_sec']} "
        f"samples/s over {timed['batches']} batches; test on pass-00000: "
        f"cost {tested['cost']:.6f} | {smi}")
    return counts, {"train_costs": costs, "train_s": train_s,
                    "train_samples_per_s_logged": rates[-1],
                    "ms_per_batch": timed["ms_per_batch"],
                    "samples_per_sec": timed["samples_per_sec"],
                    "test_cost": tested["cost"]}


def legacy_feed(rec, provider_dir):
    """The first batch of the config's provider, fed as the trainer feeds
    it."""
    from paddle_tpu_torch.trainer_config_helpers import import_provider_module
    ds = rec.data_sources
    prov = getattr(import_provider_module(ds["module"], provider_dir),
                   ds["obj"]).bind(ds["args"], file_list=["train"],
                                   is_train=True)
    batch = next(pt.reader.batch(prov.reader(None), LEGACY_B)())
    block = rec.program.global_block()
    return pt.DataFeeder([block.var(n) for n in rec.feed_order]).feed(batch)


@contextlib.contextmanager
def cudnn_weight_gradient():
    """nn_ops's C39 rule off for the block: every f32 conv2d on the card
    takes cuDNN's weight gradient, the wrong ones too (a timing
    comparison only)."""
    from paddle_tpu_torch.ops import nn_ops
    rule = nn_ops.cudnn_wgrad_faulty
    nn_ops.cudnn_wgrad_faulty = lambda w, stride: False
    try:
        yield
    finally:
        nn_ops.cudnn_wgrad_faulty = rule


def legacy_step_phase(tmp, smi):
    """(a) in process: step 1 at layer_num 1 and 2 (dropout off: the
    card's and the CPU's generators draw different masks) from the same
    weights on the card and on the CPU, the loss within 1e-5 relative,
    each op on the CPU's values of its inputs within 1e-4 of each
    output's largest element; then the CLI's program (layer_num 1,
    dropout 0.5): step wall, a profiled step's device ms, busy share and
    kernels, peak memory, and the step wall with cuDNN's weight gradient
    at C39's shapes too."""
    from paddle_tpu_torch.trainer_config_helpers import parse_config
    cfg = os.path.join(tmp, "alexnet.py")
    parity, counts = {}, launches_of()
    for gp, drop in ((1, 0.0), (2, 0.0), (1, 0.5)):
        pt.framework.reset_default_programs()
        rec = parse_config(cfg, config_args=legacy_args(layer_num=gp,
                                                        drop_rate=drop))
        loss, = rec.outputs
        rec.create_optimizer().minimize(loss)
        main = rec.program
        feed = legacy_feed(rec, tmp)
        exe, scope = pt.Executor(), pt.Scope()
        exe.run(pt.framework.default_startup_program(), scope=scope)
        what = f"legacy AlexNet layer_num {gp}"
        if drop == 0.0:
            state = tensors_of(scope)
            zero_counts()               # the main path starts here
            card, = exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope_of(state, "cuda"),
                            return_numpy=False)
            c = read_counts()           # the main path ends here
            counts = {k: counts[k] + c[k] for k in counts}
            errs, pairs = op_by_op_step(main, feed, scope_of(state, "cpu"),
                                        what, LEGACY_OP_TOL)
            cpu = pairs[loss.name][1]
            loss_err = max_rel(card, cpu)
            worst = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
            log(f"{what} step 1 on the card against the CPU from the same "
                f"weights: loss {float(card):.6f} vs {float(cpu):.6f} "
                f"({loss_err:.2e} relative, tol {LEGACY_LOSS_RTOL:g}); op by "
                f"op, the worst of {len(errs)} outputs "
                f"{[(n, f'{e:.2e}') for n, e in worst]} (tol "
                f"{LEGACY_OP_TOL:g}) | {smi}")
            if not loss_err <= LEGACY_LOSS_RTOL:
                raise AssertionError(f"{what}: step 1's loss differs from "
                                     "the CPU's")
            parity[f"layer_num_{gp}"] = {"loss_rel_err": loss_err,
                                         "worst_op_err": worst[0][1]}
            continue
        feed = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
                for k, v in feed.items()}
        zero_counts()                   # the main path starts here
        walls = []
        for _ in range(LEGACY_TIMED_STEPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        c = read_counts()               # the main path ends here
        counts = {k: counts[k] + c[k] for k in counts}
        med, lo, hi = median_lo_hi(walls[1:])
        torch.cuda.reset_peak_memory_stats()
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        prof = whole_profile(exe, main, feed, loss, scope, med, what, smi)
        device = ("not measured" if prof["device_ms"] is None else
                  f"{prof['device_ms']:.2f} ms (busy {prof['busy']:.3f})")
        walls = []
        with cudnn_weight_gradient():
            for _ in range(LEGACY_TIMED_STEPS + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
                torch.cuda.synchronize()
                walls.append(1e3 * (time.perf_counter() - t0))
        cmed, clo, chi = median_lo_hi(walls[1:])
        log(f"the same step with cuDNN's weight gradient at C39's shapes "
            f"too (wrong there; timed only): {cmed:.2f} ms median "
            f"({clo:.2f}-{chi:.2f}) against {med:.2f} | {smi}")
        log(f"legacy AlexNet training step (layer_num 1, dropout 0.5, B "
            f"{LEGACY_B}, fed from device tensors): {med:.2f} ms median "
            f"({lo:.2f}-{hi:.2f}), {LEGACY_B / med * 1e3:.1f} samples/s, "
            f"device {device}, {prof['kernels_per_step']} kernels a step, "
            f"peak {peak:.2f} GiB; top ops {prof['top_op_types_ms']} | {smi}")
        parity["step"] = {"step_ms": med, "step_ms_lo": lo,
                          "step_ms_hi": hi, "device_ms": prof["device_ms"],
                          "busy": prof["busy"],
                          "kernels_per_step": prof["kernels_per_step"],
                          "peak_gib": peak,
                          "top_op_types_ms": prof["top_op_types_ms"],
                          "cudnn_wgrad_step_ms": cmed,
                          "cudnn_wgrad_step_ms_lo": clo,
                          "cudnn_wgrad_step_ms_hi": chi}
    check_counts(counts, launches_of(), "legacy AlexNet in process (no TPU "
                 "kernel on this path)")
    return counts, parity


def legacy_checkgrad_phase(tmp, smi):
    """(b) checkgrad on the CLI fixture config, on the card."""
    here = os.path.dirname(os.path.abspath(__file__))
    for name in ("tiny_config.py", "tiny_provider.py"):
        shutil.copy(os.path.join(here, "tests", "fixtures", "cli", name),
                    os.path.join(tmp, name))
    zero_counts()                       # the main path starts here
    rc, out = run_cli(["checkgrad",
                       f"--config={os.path.join(tmp, 'tiny_config.py')}"])
    counts = read_counts()              # the main path ends here
    check_counts(counts, launches_of(), "legacy checkgrad (no TPU kernel)")
    lines = [ln for ln in out.splitlines() if "max relative diff" in ln]
    diff = float(lines[-1].split("= ")[1]) if lines else float("nan")
    log(f"legacy checkgrad on the card (tiny_config, f32, TF32 off, eps "
        f"1e-3): rc {rc}, max relative diff {diff:.3g} (limit 5e-2) | {smi}")
    if rc != 0 or not diff < 5e-2:
        raise AssertionError(f"legacy checkgrad: rc {rc}, {out[-800:]}")
    return counts, {"max_relative_diff": diff}


def v2_digits(paddle, init=None, samples=None):
    """The book's recognize-digits conv net through the v2 API, trained
    one pass over `samples` of the synthetic mnist train set from `init`
    (else the startup's weights). Returns (the net's output, its
    Parameters, the initial weights, the costs, the wall of train)."""
    from paddle_tpu_torch import event as events
    images = paddle.layer.data(name="pixel",
                               type=paddle.data_type.dense_vector(784))
    label = paddle.layer.data(name="label",
                              type=paddle.data_type.integer_value(10))
    x = pt.layers.reshape(images, [-1, 1, 28, 28])
    c1 = paddle.networks.simple_img_conv_pool(
        input=x, filter_size=5, num_filters=20, pool_size=2, pool_stride=2,
        act=paddle.activation.Relu())
    c2 = paddle.networks.simple_img_conv_pool(
        input=c1, filter_size=5, num_filters=50, pool_size=2,
        pool_stride=2, act=paddle.activation.Relu())
    predict = paddle.layer.fc(input=c2, size=10,
                              act=paddle.activation.Softmax())
    cost = paddle.layer.classification_cost(input=predict, label=label)
    parameters = paddle.parameters.create(cost)
    if init is None:
        init = {n: parameters.get(n) for n in parameters.names()}
    for n, v in init.items():
        parameters.set(n, v)
    trainer = paddle.trainer.SGD(
        cost=cost, parameters=parameters,
        update_equation=paddle.optimizer.Momentum(learning_rate=V2_LR,
                                                  momentum=0.9))
    costs = []
    t0 = time.perf_counter()
    trainer.train(
        reader=paddle.batch(paddle.reader.firstn(
            paddle.dataset.mnist.train(), samples or V2_SAMPLES), V2_B),
        num_passes=1,
        event_handler=lambda e: costs.append(e.cost)
        if isinstance(e, events.EndIteration) else None)
    return predict, parameters, init, costs, time.perf_counter() - t0


def legacy_v2_phase(smi):
    """(c) the v2 API on the card: init(use_gpu=True), one pass of the
    recognize-digits conv net, infer on 128 test images; the first costs
    and the probabilities against the CPU."""
    import paddle_tpu_torch.v2 as paddle
    paddle.init(use_gpu=True)
    zero_counts()                       # the main path starts here
    predict, params, init, costs, wall = v2_digits(paddle)
    rows = [(x,) for x, _ in paddle.reader.firstn(
        paddle.dataset.mnist.test(), V2_B)()]
    probs = np.asarray(paddle.infer(output_layer=predict, parameters=params,
                                    input=rows))
    counts = read_counts()              # the main path ends here
    check_counts(counts, launches_of(), "v2 recognize-digits (no TPU "
                 "kernel on this path)")
    final = {n: params.get(n) for n in params.names()}
    paddle.init(use_gpu=False)
    cpu_predict, cpu_params, _, cpu_costs, _ = v2_digits(
        paddle, init, samples=V2_CHECKED * V2_B)
    for n, v in final.items():
        cpu_params.set(n, v)
    cpu_probs = np.asarray(paddle.infer(output_layer=cpu_predict,
                                        parameters=cpu_params, input=rows))
    paddle.init(use_gpu=True)
    cost_err = float(np.max(np.abs(np.subtract(costs[:V2_CHECKED],
                                               cpu_costs))
                            / np.abs(cpu_costs)))
    prob_err = float(np.abs(probs - cpu_probs).max())
    acc = float(np.mean(probs.argmax(1) == [
        y for _, y in paddle.reader.firstn(paddle.dataset.mnist.test(),
                                           V2_B)()]))
    rate = len(costs) * V2_B / wall
    log(f"v2 recognize-digits conv net on the card (init(use_gpu=True), "
        f"SGD Momentum, B {V2_B}, {len(costs)} batches): {wall:.2f} s, "
        f"{rate:.1f} samples/s, costs {costs[0]:.4f} -> {costs[-1]:.4f}; "
        f"the first {V2_CHECKED} costs against the CPU's from the same "
        f"weights {cost_err:.2e} relative (tol {V2_TOL:g}); infer on "
        f"{len(rows)} test images: probabilities within {prob_err:.2e} of "
        f"the CPU's (tol {V2_TOL:g}), accuracy {acc:.3f} | {smi}")
    if not (len(costs) == V2_SAMPLES // V2_B and np.isfinite(costs).all()
            and costs[-1] < costs[0] and cost_err <= V2_TOL
            and prob_err <= V2_TOL):
        raise AssertionError("v2 recognize-digits: the card differs from "
                             "the CPU, or did not train")
    return counts, {"samples_per_s": rate, "train_s": wall,
                    "costs_first_last": [costs[0], costs[-1]],
                    "cost_rel_err": cost_err, "prob_abs_err": prob_err,
                    "accuracy": acc}


def legacy_generation_phase(tmp, smi):
    """(d) legacy_beam_generate at the seqToseq demo's widths: ms and
    kernels a generation, device -> host syncs of a generation fed from
    the card (none), the ids and lengths against the CPU's from the same
    weights, a differing row excused only at a near tie."""
    from paddle_tpu_torch.trainer_config_helpers import parse_config
    cfg = os.path.join(tmp, "generate.py")
    with open(cfg, "w") as f:
        f.write(LEGACY_GEN)
    pt.framework.reset_default_programs()
    rec = parse_config(cfg, config_args={
        "dim": GEN_DIM, "vocab": GEN_VOCAB, "beam": GEN_BEAM,
        "max_length": GEN_MAX_LEN})
    ids = rec.outputs[-1]
    main = rec.program
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(pt.framework.default_startup_program(), scope=scope)
    ctx = np.random.RandomState(SEED + 41).randn(GEN_B, GEN_DIM).astype(
        np.float32)
    feed = {"ctx": torch.from_numpy(ctx).cuda()}
    fetch = [ids, ids.scores_var, ids.lens_var]
    zero_counts()                       # the main path starts here
    walls = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                      return_numpy=False)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    counts = read_counts()              # the main path ends here
    check_counts(counts, launches_of(), "legacy generation (no TPU kernel "
                 "on this path)")
    med, lo, hi = median_lo_hi(walls[1:])
    syncs = call_syncs(lambda: exe.run(main, feed=feed, fetch_list=[],
                                       scope=scope))
    prof = whole_profile(exe, main, {"ctx": ctx}, ids, scope, med,
                         "legacy generation", smi)
    card_ids, card_scores, card_lens = (t.cpu() for t in out)
    record = []
    mod, real, wrapped = decode_leads(record)
    mod.beam_step = wrapped
    try:
        t0 = time.perf_counter()
        cpu_ids, cpu_scores, cpu_lens = (
            torch.as_tensor(v) for v in pt.Executor(pt.CPUPlace()).run(
                main, feed={"ctx": ctx}, fetch_list=fetch,
                scope=scope_of(tensors_of(scope), "cpu")))
        cpu_s = time.perf_counter() - t0
    finally:
        mod.beam_step = real
    lead = torch.stack(record).amin(dim=0)          # [B]
    near = lead < GEN_TIE
    same = ((card_ids == cpu_ids).flatten(1).all(1)
            & (card_lens == cpu_lens).all(1))
    differ = ~same
    excused = differ & near
    rel = ((card_scores - cpu_scores).abs()
           / cpu_scores.abs().clamp_min(1e-30))[same]
    rel_max = float(rel.max()) if rel.numel() else 0.0
    device = ("not measured" if prof["device_ms"] is None else
              f"{prof['device_ms']:.2f} ms (busy {prof['busy']:.3f})")
    log(f"legacy generation (memory decoder, width {GEN_DIM}, vocab "
        f"{GEN_VOCAB}, beam {GEN_BEAM}, B {GEN_B}, max_length "
        f"{GEN_MAX_LEN}): {med:.1f} ms a generation median of 3 "
        f"({lo:.1f}-{hi:.1f}), device {device}, "
        f"{prof['kernels_per_step']} kernels a generation, {syncs} device "
        f"-> host syncs a generation; card vs CPU ({cpu_s:.1f} s): scores "
        f"{rel_max:.2e} relative (tol {GEN_SCORE_RTOL:g}) on the "
        f"{int(same.sum())} equal rows, rows differing "
        f"{int(differ.sum())}, excused by a near tie {int(excused.sum())} "
        f"(at most {GEN_MAX_TIE_ROWS}), rows with a lead under {GEN_TIE:g} "
        f"{int(near.sum())}, smallest lead {float(lead.min()):.3e}; mean "
        f"length {float(card_lens[:, 0].float().mean()):.1f} | {smi}")
    if syncs != 0 or rel_max > GEN_SCORE_RTOL \
            or bool((differ & ~near).any()) \
            or int(excused.sum()) > GEN_MAX_TIE_ROWS:
        raise AssertionError("legacy generation: the card differs from the "
                             "CPU, or it read the device from the host")
    return counts, {"ms_per_generation": med, "ms_lo": lo, "ms_hi": hi,
                    "device_ms": prof["device_ms"], "busy": prof["busy"],
                    "kernels_per_generation": prof["kernels_per_step"],
                    "syncs_per_generation": syncs,
                    "scores_rel_err": rel_max,
                    "differing_rows": int(differ.sum()),
                    "excused_rows": int(excused.sum()),
                    "near_tie_rows": int(near.sum()),
                    "smallest_lead": float(lead.min())}


def beam_cost_program(B, K):
    """Three chained expansions: the sentence scores and kmax over them;
    sub_nested_seq picks the selected sentences' word scores, kmax over
    those; seq_slice cuts a span from each selected word on, kmax over
    the spans; cross_entropy_over_beam over the three, and its gradients
    to the three score inputs."""
    from paddle_tpu_torch import trainer_config_helpers as tch
    L = pt.layers
    sent = L.data("sent", shape=[1], dtype="float32", lod_level=1,
                  stop_gradient=False)
    word = L.data("word", shape=[1], dtype="float32", lod_level=2,
                  stop_gradient=False)
    span = L.data("span", shape=[1], dtype="float32", lod_level=1,
                  stop_gradient=False)
    golds = [L.data(f"g{i}", shape=[1], dtype="int64") for i in range(3)]
    top_s = tch.kmax_seq_score_layer(input=sent, beam_size=K)
    picked = tch.sub_nested_seq_layer(input=word, selected_indices=top_s)
    top_w = tch.kmax_seq_score_layer(input=picked, beam_size=K)
    sliced = tch.seq_slice_layer(input=span,
                                 starts=L.reshape(top_w, [-1, K * K]),
                                 ends=None)
    top_e = tch.kmax_seq_score_layer(input=sliced, beam_size=K)
    cost = tch.cross_entropy_over_beam(input=[
        tch.BeamInput(candidate_scores=sent, selected_candidates=top_s,
                      gold=golds[0]),
        tch.BeamInput(candidate_scores=picked, selected_candidates=top_w,
                      gold=golds[1]),
        tch.BeamInput(candidate_scores=sliced, selected_candidates=top_e,
                      gold=golds[2])])
    return [cost] + list(pt.backward.calc_gradient(cost, [sent, word, span]))


def beam_cost_feed(rng, B, S, T, K):
    """Every expansion but the last selects K candidates in every row
    (the cost's bookkeeping maps a row to a slot of the previous
    expansion): at least K sentences and K words; a span from a word on
    is never empty."""
    outer = rng.randint(K, S + 1, size=B).astype(np.int64)
    inner = np.zeros((B, S), np.int64)
    for b in range(B):
        inner[b, :outer[b]] = rng.randint(K, T + 1, size=outer[b])
    return {"sent": rng.randn(B, S, 1).astype(np.float32),
            "sent@SEQLEN": outer,
            "word": rng.randn(B, S, T, 1).astype(np.float32),
            "word@SEQLEN": outer, "word@SEQLEN@SUB": inner,
            "span": rng.randn(B, 3 * T, 1).astype(np.float32),
            "span@SEQLEN": rng.randint(T, 3 * T + 1,
                                       size=B).astype(np.int64),
            **{f"g{i}": rng.randint(0, 2, size=(B, 1)).astype(np.int64)
               for i in range(3)}}


def beam_cost_oracle_cases():
    """tests/test_beam_training.py's cases: (ids0, gold0, scores1 rows,
    ids1, gold1)."""
    return [([1, 3, 0], 3, [[0.5, 0.1, 0.4], [0.9, 0.2], [0.3, 0.6, 0.7]],
             [[0, 2, -1], [1, -1, -1], [2, 0, -1]], 1),
            ([1, 3, 0], 2, [[0.5, 0.1], [0.9, 0.2], [0.3, 0.6]],
             [[0, -1, -1], [1, -1, -1], [0, 1, -1]], 0)]


def oracle_program_and_feed(case):
    from paddle_tpu_torch import trainer_config_helpers as tch
    ids0, gold0, rows1, ids1, gold1 = case
    K, S1, T1 = len(ids0), len(rows1), max(len(r) for r in rows1)
    L = pt.layers
    s0 = L.data("s0", shape=[1], dtype="float32", lod_level=1,
                stop_gradient=False)
    i0 = L.data("i0", shape=[K], dtype="float32")
    g0 = L.data("g0", shape=[1], dtype="int64")
    s1 = L.data("s1", shape=[1], dtype="float32", lod_level=2,
                stop_gradient=False)
    i1 = L.data("i1", shape=[S1, K], dtype="float32")
    g1 = L.data("g1", shape=[1], dtype="int64")
    cost = tch.cross_entropy_over_beam(input=[
        tch.BeamInput(candidate_scores=s0, selected_candidates=i0,
                      gold=g0),
        tch.BeamInput(candidate_scores=s1, selected_candidates=i1,
                      gold=g1)])
    fetch = [cost] + list(pt.backward.calc_gradient(cost, [s0, s1]))
    s1v = np.zeros((1, S1, T1, 1), np.float32)
    inner = np.zeros((1, S1), np.int64)
    for r, row in enumerate(rows1):
        s1v[0, r, :len(row), 0] = row
        inner[0, r] = len(row)
    feed = {"s0": np.random.RandomState(7).randn(1, 5, 1).astype(np.float32),
            "s0@SEQLEN": np.asarray([5], np.int64),
            "i0": np.asarray([ids0], np.float32),
            "g0": np.asarray([[gold0]], np.int64), "s1": s1v,
            "s1@SEQLEN": np.asarray([S1], np.int64),
            "s1@SEQLEN@SUB": inner, "i1": np.asarray([ids1], np.float32),
            "g1": np.asarray([[gold1]], np.int64)}
    return fetch, feed


def beam_cost_card(main, feed, fetch):
    """The card's run with the monitor on (beam.host_syncs); returns
    (card outputs, host syncs)."""
    exe = pt.Executor()
    monitor.reset()
    monitor.set_enabled(True)
    try:
        card = exe.run(main, feed=feed, fetch_list=fetch, return_numpy=False)
        torch.cuda.synchronize()
        syncs = int(monitor.snapshot().get("counters", {}).get(
            "beam.host_syncs", 0))
    finally:
        monitor.set_enabled(False)
        monitor.reset()
    return card, syncs


def beam_cost_errors(main, feed, fetch, card):
    """The CPU's run of the same program and feed; the largest absolute
    difference of each fetch from the card's."""
    cpu = pt.Executor(pt.CPUPlace()).run(main, feed=feed, fetch_list=fetch,
                                         return_numpy=False)
    return [float((c.double().cpu() - r.double()).abs().max())
            for c, r in zip(card, cpu)]


def legacy_beam_cost_phase(smi):
    """(e) cross_entropy_over_beam on the card: the oracle cases and a
    batch of BC_B through kmax -> sub_nested_seq -> seq_slice; loss and
    gradients against the CPU's, one device -> host copy a run (the
    forward's; the backward reads nothing), step wall."""
    results, counts = [], launches_of()
    cases = [(f"oracle {i}", None, c)
             for i, c in enumerate(beam_cost_oracle_cases())]
    cases.append((f"B {BC_B}, 3 expansions, beam {BC_K}",
                  beam_cost_feed(np.random.RandomState(SEED + 42), BC_B,
                                 BC_S, BC_T, BC_K), None))
    for what, feed, case in cases:
        pt.framework.reset_default_programs()
        if case is None:
            fetch = beam_cost_program(BC_B, BC_K)
        else:
            fetch, feed = oracle_program_and_feed(case)
        main = pt.framework.default_main_program()
        zero_counts()                   # the main path starts here
        card, syncs = beam_cost_card(main, feed, fetch)
        c = read_counts()               # the main path ends here
        counts = {k: counts[k] + c[k] for k in counts}
        errs = beam_cost_errors(main, feed, fetch, card)
        results.append({"case": what, "host_syncs": syncs,
                        "max_abs_err": max(errs)})
        log(f"beam cost ({what}) on the card against the CPU: loss "
            f"{float(card[0].mean()):.6f}, loss and gradients within "
            f"{max(errs):.2e} (tol {BC_TOL:g}); beam.host_syncs {syncs} "
            f"a forward + backward | {smi}")
        if max(errs) > BC_TOL or syncs != 1:
            raise AssertionError(f"beam cost ({what}): the card differs "
                                 "from the CPU, or it synced other than "
                                 "once")
    exe = pt.Executor()
    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=fetch, return_numpy=False)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    med, lo, hi = median_lo_hi(walls[1:])
    syncs = call_syncs(lambda: exe.run(main, feed=feed, fetch_list=[]))
    log(f"beam cost B {BC_B} step (kmax, sub_nested_seq, seq_slice, the "
        f"cost, its backward): {med:.2f} ms median ({lo:.2f}-{hi:.2f}), "
        f"{syncs} device -> host syncs a step in all (torch's sync debug "
        f"mode) | {smi}")
    check_counts(counts, launches_of(), "the beam cost (no TPU kernel)")
    return counts, {"cases": results, "step_ms": med, "step_ms_lo": lo,
                    "step_ms_hi": hi, "syncs_per_step": syncs}


def legacy_phase(smi):
    """Phase 41."""
    t0 = time.perf_counter()
    use_full_f32()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_legacy_")
    try:
        with open(os.path.join(tmp, "alexnet.py"), "w") as f:
            f.write(LEGACY_ALEXNET)
        with open(os.path.join(tmp, "alexnet_provider.py"), "w") as f:
            f.write(LEGACY_ALEXNET_PROVIDER)
        paths, out = {}, {}
        paths["legacy_alexnet_cli"], out["alexnet_cli"] = \
            legacy_cli_phase(tmp, smi)
        paths["legacy_alexnet_step"], out["alexnet_step"] = \
            legacy_step_phase(tmp, smi)
        paths["legacy_checkgrad"], out["checkgrad"] = \
            legacy_checkgrad_phase(tmp, smi)
        paths["legacy_v2_digits"], out["v2"] = legacy_v2_phase(smi)
        paths["legacy_generation"], out["generation"] = \
            legacy_generation_phase(tmp, smi)
        paths["legacy_beam_cost"], out["beam_cost"] = \
            legacy_beam_cost_phase(smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    log(f"legacy: phase 41 in {out['seconds']:.1f} s | {smi}")
    return paths, out


# -- phase 42: the pb model format, recordio and the dataset loaders ---------

# (b): seq2seq at phase 27's card config, fed from wmt16 through recordio
WMT_STEPS, WMT_FILES = 8, 4
# later losses of the recordio route against the direct feed, absolute.
# Two runs of one route gave the same bits at every step on the H100
# (the spread is measured and printed beside this every run); the
# embedding gradients' atomic adds may still sum in another order, which
# the recommender's f32 losses showed at 2.4e-7: 1e-5 is ten f32 ulps of
# a loss near 10
WMT_LOSS_TOL = 1e-5
# (c): the book's recommender at its widths (movielens ids, embedding 32,
# towers of 200), B 256
REC_B, REC_STEPS, REC_LR = 256, 6, 1e-2
REC_SIZES = {"max_uid": 6041, "max_gender": 2, "max_age": 7, "max_job": 21,
             "max_movie": 3953, "max_category": 18, "max_title": 5000}
REC_ORDER = ("uid", "gender", "age", "job", "movie", "cats", "titles",
             "rating")


def f32_attr(v):
    """An attr value as the pb format keeps it: floats rounded to
    float32, lists element by element."""
    if isinstance(v, float):
        with np.errstate(over="ignore"):
            return float(np.float32(v))
    if isinstance(v, (list, tuple)):
        return [f32_attr(x) for x in v]
    return v


def program_signature(prog):
    """Per block: the vars (shape, dtype, persistable, lod level) and the
    ops (type, slots, attrs with floats rounded to float32)."""
    return [({n: (tuple(v.shape or ()), v.dtype, bool(v.persistable),
                  int(v.lod_level or 0)) for n, v in blk.vars.items()},
             [(op.type, op.inputs, op.outputs,
               {k: f32_attr(a) for k, a in op.attrs.items()
                if k != "fwd_op_id"}) for op in blk.ops])
            for blk in prog.blocks]


def programs_alike(pb_prog, json_prog, what):
    """Raise unless the pb-loaded program has the json-loaded one's ops,
    slots, var shapes, dtypes and persistables, float attrs equal after
    rounding to float32. Returns the float attrs the rounding moved."""
    if program_signature(pb_prog) != program_signature(json_prog):
        raise AssertionError(f"{what}: the pb-loaded program differs from "
                             "the json-loaded one")
    return sorted({f"{op.type}.{k}" for blk in json_prog.blocks
                   for op in blk.ops for k, a in op.attrs.items()
                   if f32_attr(a) != a})


def timed_loads(dirs, exe, reps=2):
    """load_inference_model of each dir in turns (json, pb, pb, json, ...):
    {fmt: [wall s]}; each load puts the weights on the card."""
    walls = {fmt: [] for fmt in dirs}
    order = list(dirs) + list(dirs)[::-1]
    for _ in range(reps):
        for fmt in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pt.io.load_inference_model(dirs[fmt], exe, scope=pt.Scope())
            torch.cuda.synchronize()
            walls[fmt].append(time.perf_counter() - t0)
    return walls


def parse_walls(dirs, reps=5):
    """The program's parse alone, from the file's bytes: {fmt: [s]}."""
    from paddle_tpu_torch import proto_io
    with open(os.path.join(dirs["json"], "__model__.json")) as f:
        text = f.read()
    with open(os.path.join(dirs["pb"], "__model__"), "rb") as f:
        blob = f.read()
    walls = {"json": [], "pb": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        pt.Program.from_dict(json.loads(text)["program"])
        walls["json"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        proto_io.program_from_bytes(blob)
        walls["pb"].append(time.perf_counter() - t0)
    return walls


def model_sizes(dirs):
    return {fmt: os.path.getsize(os.path.join(
        d, "__model__.json" if fmt == "json" else "__model__"))
        for fmt, d in dirs.items()}


def pb_serving_phase(smi):
    """Phase 42 (a): phase 10's GPT-2-small inference program and weights
    saved as pb and as json, loaded both ways; the pb directory quantized
    (read through the auto-detect), written again as pb and served
    one-shot behind make_server with phase 10's requests."""
    torch.cuda.empty_cache()
    flags.set_flag("metrics", True)
    t0 = time.perf_counter()
    main, startup, logits, ids = build_gpt2_lm()
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pb_")
    try:
        f32 = {fmt: os.path.join(tmp, f"f32_{fmt}") for fmt in ("json", "pb")}
        for fmt, d in f32.items():
            pt.io.save_inference_model(d, ["tokens"], [ids], exe,
                                       main_program=main, scope=scope,
                                       format=fmt)
        del scope
        loads = timed_loads(f32, exe)
        parses = parse_walls(f32)
        sizes = model_sizes(f32)
        progs = {fmt: pt.io.load_inference_model(d, exe, scope=pt.Scope())[0]
                 for fmt, d in f32.items()}
        moved = programs_alike(progs["pb"], progs["json"], "f32 GPT-2")
        log(f"pb serving: GPT-2-small saved as json and pb in "
            f"{time.perf_counter() - t0:.1f} s; __model__ {sizes['pb']} B "
            f"vs __model__.json {sizes['json']} B; load_inference_model "
            f"(program + weights to the card) pb "
            f"{[round(x, 4) for x in loads['pb']]} s vs json "
            f"{[round(x, 4) for x in loads['json']]} s; the program's parse "
            f"alone pb {np.median(parses['pb']) * 1e3:.2f} ms vs json "
            f"{np.median(parses['json']) * 1e3:.2f} ms (median of 5); the "
            f"programs alike ({len(progs['pb'].global_block().ops)} ops); "
            f"float attrs the format rounds: {moved} | {smi}")
        del progs

        qjson, qpb = os.path.join(tmp, "int8_json"), os.path.join(tmp,
                                                                  "int8_pb")
        _, report = quant.quantize_inference_model(f32["pb"], qjson)
        jscope = pt.Scope()
        jprog, feeds, fetch = pt.io.load_inference_model(qjson, exe,
                                                         scope=jscope)
        pt.io.save_inference_model(qpb, feeds, fetch, exe,
                                   main_program=jprog, scope=jscope,
                                   format="pb")
        qsizes = model_sizes({"json": qjson, "pb": qpb})
        fallback0 = monitor.snapshot()["counters"].get("quant.fallback_ops",
                                                       0)
        qscope = pt.Scope()
        prog, feeds, fetch = pt.io.load_inference_model(qpb, exe,
                                                        scope=qscope)
        fallbacks = monitor.snapshot()["counters"].get(
            "quant.fallback_ops", 0) - fallback0
        qmoved = programs_alike(prog, jprog, "int8 GPT-2")
        dot_weights = {op.input("Y")[0] for op in prog.global_block().ops
                       if op.type == "quant_mul"}
        row_major = sorted(n for n in dot_weights
                           if not qo.is_column_major(qscope.get(n)))
        log(f"pb serving: the pb directory quantized "
            f"({report['quantized_ops']} ops, "
            f"{report['quantized_weights']} weights), written again "
            f"as pb (__model__ {qsizes['pb']} B vs __model__.json "
            f"{qsizes['json']} B), loaded with {fallbacks} fallback ops; "
            f"the pb and json programs alike; {len(dot_weights)} int8 "
            f"matmul weights, {len(dot_weights) - len(row_major)} "
            f"column-major on the card; float attrs rounded: {qmoved}")
        if report["quantized_ops"] != 4 * LAYERS + 2 or fallbacks != 0:
            raise AssertionError(f"expected {4 * LAYERS + 2} quantized ops "
                                 "and no fallback")
        if row_major or len(dot_weights) != 4 * LAYERS + 1:
            raise AssertionError(f"int8 weights not column-major on the "
                                 f"card: {row_major}")

        engine = InferenceEngine.from_program(
            prog, feeds, fetch, executor=exe, scope=qscope,
            config=EngineConfig(max_batch_size=SERVE_B, buckets=(1, 2, 4, 8),
                                batch_timeout_ms=20))
        engine.warmup()
        server = make_server(engine, port=0)
        port = server.server_address[1]
        threading.Thread(target=server.serve_forever, daemon=True).start()
        rng = np.random.RandomState(SEED + 5)         # phase 10's requests
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
        zero_counts()                       # the main path starts here
        t_start = time.perf_counter()
        threads = [threading.Thread(target=client, args=((c, c + 4),))
                   for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t_start
        counts = read_counts()              # the main path ends here
        server.shutdown()
        engine.shutdown(drain=True, timeout=600)
        if errors:
            raise AssertionError(f"/v1/infer requests failed: {errors}")
        st = engine.stats()
        batches = st["batches"] - before["batches"]
        done = st["completed"] - before["completed"]
        log(f"pb serving: {done} requests ({sum(len(r) for r in reqs)} "
            f"rows) in {batches} dispatches over {wall:.2f} s, launches "
            f"{counts}")
        if done != len(reqs):
            raise AssertionError("requests lost")
        check_counts(counts, launches_of(
            int8_matmul=INT8_PER_DISPATCH * batches,
            quantize_activations=INT8_PER_DISPATCH * batches,
            flash_attn_fwd=LAYERS * batches),
            f"pb int8 serving ({batches} dispatches)")
        for i, x in enumerate(reqs):
            want, = exe.run(jprog, feed={"tokens": x}, fetch_list=fetch,
                            scope=jscope)
            if not np.array_equal(replies[i], want):
                raise AssertionError(
                    f"request {i}: the pb-saved model's ids differ from "
                    f"the json-saved one's (float attrs the pb format "
                    f"rounds: {qmoved})")
        log(f"pb serving: every reply's ids bitwise those of the json-saved "
            f"int8 model (Executor.run) | {smi}")
        del engine, qscope, jscope
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return {k: n for k, n in counts.items() if n}, {
        "model_bytes": {"f32": sizes, "int8": qsizes},
        "load_s": loads, "parse_s": parses, "dispatches": batches,
        "requests": done, "serve_wall_s": wall, "rounded_attrs": moved,
        "rounded_attrs_int8": qmoved, "quantized_ops":
            report["quantized_ops"]}


def write_recordio(examples, root, files):
    """`examples` pickled one a record (the CLI's convention) into
    `files` recordio files, in order; their paths."""
    import pickle
    paths, per = [], -(-len(examples) // files)
    for k in range(files):
        path = os.path.join(root, f"part-{k:05d}.rec")
        pt.recordio.write_records(path, [pickle.dumps(e) for e in
                                         examples[k * per:(k + 1) * per]])
        paths.append(path)
    return paths


def recordio_batches(paths, B):
    import pickle
    return pt.reader.batch(pt.reader.map_readers(
        pickle.loads, pt.recordio.sharded_reader(paths, 1, 0)), B)


def trainer_run(main, startup, cost, weights, reader, order, record):
    """One pass of `reader` through the port's Trainer from a copy of
    `weights`: (losses, the host clock at each step's end, the feeds the
    executor got as numpy when `record`, the scope)."""
    scope = scope_of(weights, "cuda")
    trainer = pt.Trainer(cost, main_program=main, startup_program=startup,
                         scope=scope)
    losses, ends, feeds = [], [], []
    run = trainer.exe.run

    def recording(program, feed=None, **kw):
        if program is main:
            feeds.append({k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                              else np.array(v)) for k, v in feed.items()})
        return run(program, feed=feed, **kw)

    if record:
        trainer.exe.run = recording

    def handler(ev):
        if type(ev).__name__ == "EndIteration":
            losses.append(float(ev.cost))
            ends.append(time.perf_counter())
    trainer.train(reader, 1, list(order), handler)
    return losses, ends, feeds, scope


def same_feeds(got, want, what):
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} feeds, {len(want)} direct")
    for i, (g, w) in enumerate(zip(got, want)):
        if sorted(g) != sorted(w) or not all(
                g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k])
                for k in w):
            raise AssertionError(f"{what}: step {i + 1}'s feed differs from "
                                 "the direct feed's")


def host_batch_costs(paths, B, feed_vars, steps):
    """Host seconds a batch spends in the record read, unpickling,
    batching and the DataFeeder's conversion, timed stage by stage."""
    import pickle
    t0 = time.perf_counter()
    raw = list(pt.recordio.sharded_reader(paths, 1, 0)())
    t1 = time.perf_counter()
    examples = [pickle.loads(r) for r in raw]
    t2 = time.perf_counter()
    batches = list(pt.reader.batch(lambda: iter(examples), B)())
    t3 = time.perf_counter()
    feeder = pt.DataFeeder(feed_vars, pt.CPUPlace())
    for b in batches:
        feeder.feed(b)
    t4 = time.perf_counter()
    return {"read": (t1 - t0) / steps, "unpickle": (t2 - t1) / steps,
            "batch": (t3 - t2) / steps, "convert": (t4 - t3) / steps}


def wmt16_recordio_phase(smi, s2s27):
    """Phase 42 (b): phase 27's seq2seq amp program trained by the port's
    Trainer from wmt16 through recordio (4 files, sharded_reader(paths,
    1, 0), reader.batch), against the same steps fed straight from
    wmt16.train; a second run of the recordio route measures the
    spread."""
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    main, startup, cost = seq2seq_program(S2S_VOCAB, S2S_EMB, S2S_HID,
                                          S2S_LR, True)
    exe, scope0 = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope0)
    weights = tensors_of(scope0)
    del scope0
    n = S2S_B * WMT_STEPS
    order = ("src", "tgt", "nxt")
    examples = list(pt.reader.firstn(
        pt.dataset.wmt16.train(S2S_VOCAB, S2S_VOCAB), n)())
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rec_")
    try:
        t0 = time.perf_counter()
        paths = write_recordio(examples, tmp, WMT_FILES)
        write_s = time.perf_counter() - t0
        zero_counts()                       # the main path starts here
        losses, _, feeds, _ = trainer_run(main, startup, cost, weights,
                                          recordio_batches(paths, S2S_B),
                                          order, True)
        counts = read_counts()              # the main path ends here
        check_counts(counts, launches_of(), "seq2seq from recordio (no "
                     "TPU kernel on this path)")
        d_losses, _, d_feeds, _ = trainer_run(
            main, startup, cost, weights, pt.reader.batch(pt.reader.firstn(
                pt.dataset.wmt16.train(S2S_VOCAB, S2S_VOCAB), n), S2S_B),
            order, True)
        same_feeds(feeds, d_feeds, "seq2seq from recordio")
        r_losses, ends, _, scope = trainer_run(
            main, startup, cost, weights, recordio_batches(paths, S2S_B),
            order, False)
        if not (losses[0] == d_losses[0] == r_losses[0]):
            raise AssertionError(f"step 1's loss: recordio {losses[0]!r}, "
                                 f"direct {d_losses[0]!r}, again "
                                 f"{r_losses[0]!r}")
        vs_direct = float(np.max(np.abs(np.subtract(losses, d_losses))))
        spread = float(np.max(np.abs(np.subtract(losses, r_losses))))
        walls = np.diff(ends) * 1e3
        med, lo, hi = median_lo_hi(list(walls))
        pad_tokens = sum(f["tgt"].size for f in feeds) / len(feeds)
        real_tokens = sum(int(f["tgt@SEQLEN"].sum()) for f in feeds) / len(
            feeds)
        rep = monitor.deviceprof.profile_program(
            main, feeds[-1], [cost.name], scope, exe, steps=1, warmup=0)
        device_ms = rep["total_us"] / 1e3
        host = host_batch_costs(paths, S2S_B, [main.global_block().var(k)
                                               for k in order], WMT_STEPS)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lens = [len(e[0]) for e in examples]
    log(f"wmt16 via recordio: {n} examples (source lengths {min(lens)}-"
        f"{max(lens)}) pickled into {WMT_FILES} files in {write_s:.3f} s; "
        f"{WMT_STEPS} Trainer steps at B {S2S_B}: losses "
        f"{[round(x, 4) for x in losses]}; direct feed: feeds (ids and "
        f"@SEQLEN) bitwise equal, step 1's loss bitwise, later max |diff| "
        f"{vs_direct:.3e} (tol {WMT_LOSS_TOL:g}); a second recordio run: "
        f"step 1 bitwise, later max |diff| {spread:.3e}; launches {counts}")
    log(f"wmt16 via recordio: step {med:.2f} ms median ({lo:.2f}-{hi:.2f}, "
        f"steps 2-{WMT_STEPS}), {real_tokens:.0f} target tokens a batch "
        f"({pad_tokens:.0f} padded): {real_tokens / med * 1e3:.0f} tokens/s "
        f"({pad_tokens / med * 1e3:.0f} padded); device {device_ms:.2f} ms "
        f"a profiled step, busy share {device_ms / med:.3f}; host a batch: "
        f"read {host['read'] * 1e3:.2f} ms, unpickle "
        f"{host['unpickle'] * 1e3:.2f}, batch {host['batch'] * 1e3:.3f}, "
        f"DataFeeder {host['convert'] * 1e3:.2f}; beside phase 27's one "
        f"fixed batch (T 64): {s2s27['tokens_per_s']:.0f} tokens/s, step "
        f"{s2s27['step_ms']:.2f} ms, device "
        f"{s2s27['profile']['device_ms']:.2f} ms | {smi}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"seq2seq losses not finite and falling: "
                             f"{losses}")
    if not vs_direct <= WMT_LOSS_TOL:
        raise AssertionError(f"the recordio route's losses differ from the "
                             f"direct feed's by {vs_direct:.3e}")
    return counts, {
        "losses": losses, "direct_losses": d_losses, "again_losses":
            r_losses, "vs_direct": vs_direct, "spread": spread,
        "loss_tol": WMT_LOSS_TOL, "step_ms": med, "step_ms_lo": lo,
        "step_ms_hi": hi, "tokens_per_s": real_tokens / med * 1e3,
        "padded_tokens_per_s": pad_tokens / med * 1e3,
        "device_ms": device_ms, "busy": device_ms / med,
        "host_s_per_batch": host, "write_s": write_s,
        "seconds": time.perf_counter() - t_phase}


def recommender_program():
    pt.framework.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        ids = {k: pt.layers.data(k, [1], dtype="int64")
               for k in ("uid", "gender", "age", "job", "movie")}
        cats = pt.layers.data("cats", [1], dtype="int64", lod_level=1)
        titles = pt.layers.data("titles", [1], dtype="int64", lod_level=1)
        rating = pt.layers.data("rating", [1])
        R = pt.models.recommender
        usr = R.user_net(ids["uid"], ids["gender"], ids["age"], ids["job"],
                         REC_SIZES)
        mov = R.movie_net(ids["movie"], cats, titles, REC_SIZES)
        cost = R.recommender_cost(usr, mov, rating)
        pt.AdamOptimizer(REC_LR).minimize(cost)
    return main, startup, cost


def movielens_recordio_phase(smi):
    """Phase 42 (c): the book's recommender trained by the Trainer from
    movielens through recordio, against the direct feed."""
    use_full_f32()
    t_phase = time.perf_counter()
    main, startup, cost = recommender_program()
    exe, scope0 = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope0)
    weights = tensors_of(scope0)
    del scope0
    n = REC_B * REC_STEPS
    examples = list(pt.reader.firstn(pt.dataset.movielens.train(), n)())
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rec_")
    try:
        paths = write_recordio(examples, tmp, WMT_FILES)
        zero_counts()                       # the main path starts here
        losses, ends, feeds, _ = trainer_run(
            main, startup, cost, weights, recordio_batches(paths, REC_B),
            REC_ORDER, True)
        counts = read_counts()              # the main path ends here
        check_counts(counts, launches_of(), "recommender from recordio (no "
                     "TPU kernel on this path)")
        d_losses, _, d_feeds, _ = trainer_run(
            main, startup, cost, weights, pt.reader.batch(pt.reader.firstn(
                pt.dataset.movielens.train(), n), REC_B), REC_ORDER, True)
        same_feeds(feeds, d_feeds, "recommender from recordio")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    walls = np.diff(ends) * 1e3
    log(f"movielens via recordio: recommender (book widths) {REC_STEPS} "
        f"Trainer steps at B {REC_B}: losses {[round(x, 4) for x in losses]}"
        f" (direct feed {[round(x, 4) for x in d_losses]}); feeds bitwise "
        f"equal; step {np.median(walls):.2f} ms median (recorded feeds, a "
        f"copy back a step); launches {counts} | {smi}")
    if not all(np.isfinite(losses)) or not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"recommender losses not finite and falling: "
                             f"{losses}")
    return counts, {"losses": losses, "direct_losses": d_losses,
                    "step_ms": float(np.median(walls)),
                    "seconds": time.perf_counter() - t_phase}


def installed(dist):
    """The version of an installed distribution, read from its metadata
    (nothing is imported), or None."""
    from importlib import metadata
    try:
        return metadata.version(dist)
    except metadata.PackageNotFoundError:
        return None


def pb_recordio_phase(smi, s2s27):
    """Phase 42."""
    t0 = time.perf_counter()
    paths, out = {}, {}
    out["packages"] = {d: installed(d) for d in ("protobuf", "pillow")}
    log(f"pb and recordio: this Python's protobuf and Pillow (the port "
        f"needs neither here): {out['packages']}")
    paths["pb_serving_int8"], out["pb_serving"] = pb_serving_phase(smi)
    paths["wmt16_recordio_seq2seq_amp"], out["wmt16_recordio"] = \
        wmt16_recordio_phase(smi, s2s27)
    paths["movielens_recordio_recommender"], out["movielens_recordio"] = \
        movielens_recordio_phase(smi)
    out["seconds"] = time.perf_counter() - t0
    log(f"pb and recordio: phase 42 in {out['seconds']:.1f} s | {smi}")
    return paths, out


def main():
    name, smi = device_phase()
    t0 = time.perf_counter()
    _build.build_libraries(_build.KERNEL_SOURCES)
    log(f"build: {', '.join(_build.KERNEL_SOURCES)} (nvcc, sm_90a, in "
        f"parallel) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lib = native_build.build()
    log(f"build: native/recordio.cpp (g++) -> {os.path.basename(lib)} in "
        f"{time.perf_counter() - t0:.1f} s")
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
    telemetry_paths, telemetry = telemetry_phase(smi)
    sequence_paths, sequence = sequence_phase(smi)
    ctr_paths, ctr = ctr_phase(smi)
    book_paths, book = book_phase(smi)
    fleet_paths, fleet = fleet_phase(smi)
    det_paths, detection = detection_phase(smi)
    corpus_paths, corpus = corpus_phase(smi)
    legacy_paths, legacy = legacy_phase(smi)
    pbrec_paths, pbrec = pb_recordio_phase(
        smi, sequence["seq2seq_training_amp"])
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
             "resnet50_serving_int8": resnet_serving_counts["int8"],
             **telemetry_paths, **sequence_paths, **ctr_paths,
             **book_paths, **fleet_paths, **det_paths, **corpus_paths,
             **legacy_paths, **pbrec_paths}
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
        "launches_unread": FLEET_UNREAD,
        "max_abs_err": 0.0, "case": dispatch, **k6, "cases": k6_cases})
    kernels.append({
        "name": "quantize_activations", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/int8_matmul.cu",
        "design": QUANTIZE_DESIGN,
        "replaces": "paddle_tpu/ops/quant_ops.py:173-179 (the activation "
                    "quantize of int8_matmul: XLA ops, not a Pallas kernel)",
        "launches": launches["quantize_activations"],
        "launches_by_path": by_path["quantize_activations"],
        "launches_unread": FLEET_UNREAD,
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
                                   "serving": resnet_serving},
                      "telemetry": telemetry, "sequence": sequence,
                      "ctr": ctr, "book": book, "fleet": fleet,
                      "detection": detection, "corpus": corpus,
                      "legacy": legacy, "pb_recordio": pbrec}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
