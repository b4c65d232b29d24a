"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for an NVIDIA
H100 (Hopper, sm_90a).

It stands beside the JAX package, which stays the reference it is held
against, and imports nothing of it. Entry points run on the CUDA card
unless the caller passes `device="cpu"` (or `CPUPlace()`); every TPU
kernel on a ported path is a hand-written Hopper kernel under `csrc/`,
built with nvcc at first use. Ported so far:

LM serving (slice 1):

    from paddle_tpu_torch.serving import (GenerationConfig,
                                          GenerationEngine, LMSpec,
                                          init_lm_weights)
    engine = GenerationEngine(spec, init_lm_weights(spec), config)
    ids, reason = engine.generate(prompt)

    python -m paddle_tpu_torch serve --generate --artifact lm.pdmodel

Training through the fluid-style front end (slice 2: Program ->
Executor -> Adam, GPT-2 with the flash-attention forward and backward
and the lm-head log-sum-exp as Hopper kernels):

    import paddle_tpu_torch as pt
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        tok = pt.layers.data("tok", [T, 1], dtype="int64")
        nxt = pt.layers.data("nxt", [T, 1], dtype="int64")
        cost = pt.models.transformer.transformer_lm_cost(
            tok, nxt, vocab, hid=768, num_layers=12, num_heads=12,
            max_len=T)
        pt.AdamOptimizer(1e-4).minimize(cost)
    exe = pt.Executor()                 # the card; CPUPlace() for the CPU
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    loss, = exe.run(main, feed={"tok": ..., "nxt": ...},
                    fetch_list=[cost], scope=scope)

int8 one-shot serving (slice 3: quantize a saved inference model, serve
it with the micro-batching engine; every quantized matmul runs the int8
matmul as a Hopper kernel):

    pt.io.save_inference_model("m", ["tokens"], [ids], exe, main, scope)
    pt.quant.quantize_inference_model("m", "m.int8")
    python -m paddle_tpu_torch serve --model_dir m.int8   # POST /v1/infer

bf16 mixed-precision training (slice 6: the reference's explicit role
casts, f32 master weights and Adam; the flash-attention forward and
split backward and the lm-head log-sum-exp as bf16 Hopper kernels):

    pt.amp.enable(main)                 # before the first exe.run(main)

The supervised trainer (slice 15): `Trainer` with events, passes, atomic
npz checkpoints that resume across packages, retry / skip / rollback /
preemption, the optimizer suite with LR schedules and gradient clipping,
and the `DeviceFeeder` input pipeline:

    pt.clip.set_gradient_clip(pt.clip.GradientClipByGlobalNorm(1.0))
    lr = pt.learning_rate_decay.exponential_decay(1e-4, 100, 0.9)
    trainer = pt.Trainer(cost, pt.AdamOptimizer(lr), checkpoint_dir="ck")
    trainer.train(pt.reader.batch(examples, 8), num_passes=2,
                  feed_order=["tok", "nxt"], event_handler=handler)

Sequence (LoD) programs (slice 19): `layers.data(..., lod_level=1|2)`
with the `<name>@SEQLEN` lengths the DataFeeder pads and fills, the
sequence, recurrent and beam-search ops, and the book's sequence models
(`models.seq2seq`, `lstm_text`, `word2vec`, `recommender`).

CTR with SelectedRows sparse gradients (slice 20): `models.ctr.wide_deep`
and `deepfm` over is_sparse embeddings, whose gradients are SelectedRows
(`selected_rows.py`; the `sparse_grad` flag picks dense or sparse) that
the sgd / momentum / adam / adagrad ops apply row by row; scored by the
evaluators (`evaluator.InGraphAuc`, `InGraphAccuracy`, `Auc`,
`Accuracy`).
"""

from . import framework
from .framework import (CPUPlace, CUDAPlace, Program, default_main_program,
                        default_startup_program, program_guard,
                        reset_default_programs)
from .executor import Executor, Scope, global_scope, scope_guard
from .backward import append_backward
from . import amp, flags, initializer, layers, nets, models, optimizer
from . import regularizer
from . import clip, event, io, learning_rate_decay, quant, reader, resilience
from . import monitor, profiler
from . import evaluator, selected_rows
from .data_feeder import DataFeeder
from .optimizer import (AdadeltaOptimizer, AdagradOptimizer,
                        AdamaxOptimizer, AdamOptimizer,
                        DecayedAdagradOptimizer, FtrlOptimizer, ModelAverage,
                        MomentumOptimizer, RMSPropOptimizer, SGDOptimizer)
from .param_attr import HookAttribute, ParamAttr
from .trainer import Trainer

__all__ = ["amp", "framework", "CPUPlace", "CUDAPlace", "Program",
           "default_main_program", "default_startup_program",
           "program_guard", "reset_default_programs", "Executor", "Scope",
           "global_scope", "scope_guard", "append_backward", "initializer",
           "layers", "nets", "models", "optimizer", "regularizer",
           "AdamOptimizer", "SGDOptimizer", "MomentumOptimizer",
           "AdagradOptimizer", "DecayedAdagradOptimizer", "AdamaxOptimizer",
           "AdadeltaOptimizer",
           "RMSPropOptimizer", "FtrlOptimizer", "ModelAverage", "ParamAttr",
           "HookAttribute", "flags", "io", "monitor", "ops", "quant",
           "serving", "weights", "clip", "event", "learning_rate_decay",
           "reader", "resilience", "DataFeeder", "Trainer", "profiler",
           "evaluator", "selected_rows"]
