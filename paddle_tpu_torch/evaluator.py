"""Evaluators: metric accumulation across minibatches (fluid evaluator.py).

The port's copy of the part of `paddle_tpu/evaluator.py` that scores
the classifiers, the CTR models, sequence labelling and the OCR model:

  * host evaluators (`Accuracy`, `ChunkEvaluator`, `Auc`,
    `EditDistance`): fetch a batch's metric, tags, scores or distances,
    `update()` on the host, `eval()` at the pass end;
  * in-graph evaluators (`InGraphAccuracy`, `InGraphAuc`,
    `InGraphChunkEvaluator`): the
    accumulators are persistable program vars updated by ops inside the
    training step, so a pass loop fetches only scalars — raw
    predictions never cross to the host. `eval()` runs a small eval
    program over the states, `reset()` a program of fill ops.

Program text and state names equal the JAX package's.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Evaluator", "Accuracy", "ChunkEvaluator", "Auc",
           "EditDistance", "InGraphEvaluator", "InGraphAccuracy",
           "InGraphAuc", "InGraphChunkEvaluator"]


class Evaluator:
    def reset(self):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class Accuracy(Evaluator):
    """Usage: acc = evaluator.Accuracy(input=logits, label=label);
    fetch acc.metrics each run, call update(); eval() at pass end."""

    def __init__(self, input, label, k=1):
        from .layers import nn
        self.metric_var = nn.accuracy(input, label, k=k)
        self.metrics = [self.metric_var]
        self.reset()

    def reset(self, executor=None, reset_program=None):
        self._correct = 0.0
        self._total = 0

    def update(self, batch_acc, batch_size):
        self._correct += float(np.asarray(batch_acc).reshape(-1)[0]) \
            * batch_size
        self._total += batch_size

    def eval(self, executor=None, eval_program=None):
        return self._correct / max(self._total, 1)


class ChunkEvaluator(Evaluator):
    """Chunk F1 for sequence labelling (reference evaluator.py
    ChunkEvaluator / gserver ChunkEvaluator.cpp). Host-side IOB decoding.

    Tag encoding (IOB): tags 2k / 2k+1 are B-type-k / I-type-k for
    k < num_chunk_types; any tag >= 2*num_chunk_types is O (outside).
    """

    def __init__(self, num_chunk_types, chunk_scheme="IOB"):
        self.scheme = chunk_scheme
        self.num_chunk_types = num_chunk_types
        self.reset()

    def reset(self, *a, **k):
        self.tp = 0
        self.label_chunks = 0
        self.inferred_chunks = 0

    def _extract_chunks(self, tags):
        chunks = []
        start, ctype = None, None
        for i, t in enumerate(tags):
            t = int(t)
            is_o = t >= 2 * self.num_chunk_types
            is_b = (not is_o) and (t % 2 == 0)
            typ = None if is_o else t // 2
            if start is not None and (is_o or is_b or typ != ctype):
                chunks.append((start, i, ctype))
                start, ctype = None, None
            if is_b:
                start, ctype = i, typ
        if start is not None:
            chunks.append((start, len(tags), ctype))
        return set(chunks)

    def update(self, inferred_tags, label_tags):
        inf = self._extract_chunks(inferred_tags)
        lab = self._extract_chunks(label_tags)
        self.tp += len(inf & lab)
        self.inferred_chunks += len(inf)
        self.label_chunks += len(lab)

    def eval(self, *a, **k):
        p = self.tp / max(self.inferred_chunks, 1)
        r = self.tp / max(self.label_chunks, 1)
        f1 = 2 * p * r / max(p + r, 1e-12)
        return p, r, f1


class Auc(Evaluator):
    """ROC AUC via score histograms (the rankauc evaluator,
    Evaluator.cpp). update() takes positive-class scores in [0, 1] and
    binary labels."""

    def __init__(self, num_thresholds=200):
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self, *a, **k):
        self.pos = np.zeros(self.num_thresholds + 1, np.int64)
        self.neg = np.zeros(self.num_thresholds + 1, np.int64)

    def update(self, scores, labels):
        s = np.clip(np.ravel(np.asarray(scores, np.float64)), 0.0, 1.0)
        y = np.ravel(np.asarray(labels)).astype(bool)
        idx = (s * self.num_thresholds).astype(np.int64)
        np.add.at(self.pos, idx[y], 1)
        np.add.at(self.neg, idx[~y], 1)

    def eval(self, *a, **k):
        # sweep thresholds high -> low accumulating TP / FP; trapezoid AUC
        tp = np.cumsum(self.pos[::-1])
        fp = np.cumsum(self.neg[::-1])
        P = max(int(tp[-1]), 1)
        N = max(int(fp[-1]), 1)
        tpr = np.concatenate([[0.0], tp / P])
        fpr = np.concatenate([[0.0], fp / N])
        return float(np.trapezoid(tpr, fpr)) if hasattr(np, "trapezoid") \
            else float(np.trapz(tpr, fpr))


class EditDistance(Evaluator):
    """Sequence-error metric (the ctc_error evaluator, Evaluator.cpp;
    fluid edit_distance op feeds it). Accumulates mean edit distance and
    sequence error rate from per-batch fetches of layers.edit_distance."""

    def __init__(self):
        self.reset()

    def reset(self, *a, **k):
        self.total_distance = 0.0
        self.seq_count = 0
        self.error_seqs = 0

    def update(self, distances, seq_num=None):
        d = np.ravel(np.asarray(distances, np.float64))
        self.total_distance += float(d.sum())
        self.seq_count += d.size if seq_num is None else int(seq_num)
        self.error_seqs += int((d > 0).sum())

    def eval(self, *a, **k):
        n = max(self.seq_count, 1)
        return self.total_distance / n, self.error_seqs / n


class InGraphEvaluator:
    """Base: `_create_state` carves persistable accumulator vars into the
    main program, seeds them in the startup program, and builds a reset
    program (fill ops) and an eval program (the metric from the states).

    Usage::

        acc = evaluator.InGraphAccuracy(input=probs, label=label)
        exe.run(startup)                # states seeded
        for batch in pass_data:
            exe.run(main, feed=..., fetch_list=[cost])   # states accumulate
        value = acc.eval(exe, scope)    # scalar fetch from the states
        acc.reset(exe, scope)           # next pass
    """

    def __init__(self, name):
        from . import framework
        self.main_program = framework.default_main_program()
        self.startup_program = framework.default_startup_program()
        self.reset_program = framework.Program()
        self.eval_program = framework.Program()
        self._prefix = framework.unique_name(name)
        self.states = []

    def _create_state(self, suffix, shape, dtype="float32"):
        """The state var exists (same name) in the main, startup, reset
        and eval programs; fill ops seed it in startup and re-zero it in
        reset."""
        from . import framework
        from .layers import tensor as T
        name = f"{self._prefix}.{suffix}"
        main_var = self.main_program.global_block().create_var(
            name=name, shape=list(shape), dtype=dtype, persistable=True)
        for prog, fill in ((self.startup_program, True),
                           (self.reset_program, True),
                           (self.eval_program, False)):
            blk = prog.global_block()
            blk.create_var(name=name, shape=list(shape), dtype=dtype,
                           persistable=True)
            if fill:
                with framework.program_guard(prog):
                    T.fill_constant(shape, dtype, 0.0, out=blk.var(name))
        self.states.append(main_var)
        return main_var

    def _accumulate(self, state, delta):
        """state += delta inside the main program (the executor carries a
        written persistable across runs)."""
        blk = self.main_program.current_block()
        blk.append_op("elementwise_add",
                      {"X": [state.name], "Y": [delta.name]},
                      {"Out": [state.name]}, {})
        self.main_program.bump()

    def _build_state_reads(self, states):
        """Eval program that READS the given states (the executor's
        state threading needs a consuming op) via assign into fetchable
        '.read' vars; returns the fetch names."""
        from . import framework
        fetches = []
        with framework.program_guard(self.eval_program):
            eblk = self.eval_program.global_block()
            for st in states:
                out = eblk.create_var(name=st.name + ".read",
                                      dtype="float32")
                eblk.append_op("assign", {"X": [st.name]},
                               {"Out": [out.name]}, {})
                fetches.append(out.name)
            self.eval_program.bump()
        return fetches

    def reset(self, executor, scope=None):
        executor.run(self.reset_program, scope=scope)

    def eval(self, executor, scope=None):
        """The scalar var `_metric_name` of the eval program."""
        out, = executor.run(self.eval_program,
                            fetch_list=[self._metric_name], scope=scope)
        return float(np.ravel(out)[0])


class InGraphAccuracy(InGraphEvaluator):
    """Top-k accuracy with in-graph correct / total accumulators (the
    reference fluid Accuracy evaluator)."""

    def __init__(self, input, label, k=1):
        super().__init__("acc_state")
        from . import framework
        from .layers import nn, tensor as T
        correct = self._create_state("correct", [1], "float32")
        total = self._create_state("total", [1], "float32")
        with framework.program_guard(self.main_program,
                                     self.startup_program):
            batch_acc = nn.accuracy(input, label, k=k)
            # the accuracy op's Correct / Total outputs are tmp vars
            blk = self.main_program.current_block()
            op = blk.ops[-1]
            c_f = T.cast(blk.var(op.outputs["Correct"][0]), "float32")
            t_f = T.cast(blk.var(op.outputs["Total"][0]), "float32")
            self._accumulate(correct, c_f)
            self._accumulate(total, t_f)
        self.batch_accuracy = batch_acc
        with framework.program_guard(self.eval_program):
            blk = self.eval_program.global_block()
            ratio = blk.create_var(name=f"{self._prefix}.value",
                                   dtype="float32")
            one = T.fill_constant([1], "float32", 1.0)
            denom = blk.create_var(name=f"{self._prefix}.denom",
                                   dtype="float32")
            blk.append_op("elementwise_max",
                          {"X": [total.name], "Y": [one.name]},
                          {"Out": [denom.name]}, {})
            blk.append_op("elementwise_div",
                          {"X": [correct.name], "Y": [denom.name]},
                          {"Out": [ratio.name]}, {})
            self.eval_program.bump()
        self._metric_name = ratio.name


class InGraphAuc(InGraphEvaluator):
    """Bucketed ROC AUC with in-graph histogram states (rankauc): each
    batch adds its scores into `num_thresholds + 1` buckets, the
    positives into `.pos` and the negatives into `.neg`."""

    def __init__(self, scores, labels, num_thresholds=200):
        super().__init__("auc_state")
        from . import framework
        from .layers import tensor as T
        n = num_thresholds
        pos = self._create_state("pos", [n + 1], "float32")
        neg = self._create_state("neg", [n + 1], "float32")
        with framework.program_guard(self.main_program,
                                     self.startup_program):
            blk = self.main_program.current_block()
            # idx = floor(clip(score, 0, 1) * n)
            clipped = blk.create_var(name=f"{self._prefix}.clip")
            blk.append_op("clip", {"X": [scores.name]},
                          {"Out": [clipped.name]},
                          {"min": 0.0, "max": 1.0})
            scaled = blk.create_var(name=f"{self._prefix}.scaled")
            blk.append_op("scale", {"X": [clipped.name]},
                          {"Out": [scaled.name]}, {"scale": float(n)})
            idx = blk.create_var(name=f"{self._prefix}.idx")
            blk.append_op("floor", {"X": [scaled.name]},
                          {"Out": [idx.name]}, {})
            lab_f = T.cast(labels, "float32")
            one = T.fill_constant([1], "float32", 1.0)
            inv = blk.create_var(name=f"{self._prefix}.inv")
            blk.append_op("elementwise_sub",
                          {"X": [one.name], "Y": [lab_f.name]},
                          {"Out": [inv.name]}, {})
            blk.append_op("scatter_add_1d",
                          {"X": [pos.name], "Index": [idx.name],
                           "Weight": [lab_f.name]},
                          {"Out": [pos.name]}, {})
            blk.append_op("scatter_add_1d",
                          {"X": [neg.name], "Index": [idx.name],
                           "Weight": [inv.name]},
                          {"Out": [neg.name]}, {})
            self.main_program.bump()
        with framework.program_guard(self.eval_program):
            blk = self.eval_program.global_block()
            auc = blk.create_var(name=f"{self._prefix}.value",
                                 dtype="float32")
            blk.append_op("auc_from_histograms",
                          {"Pos": [pos.name], "Neg": [neg.name]},
                          {"Auc": [auc.name]}, {})
            self.eval_program.bump()
        self._metric_name = auc.name


class InGraphChunkEvaluator(InGraphEvaluator):
    """Chunk F1 with IN-GRAPH accumulators (reference fluid
    ChunkEvaluator, evaluator.py:145, over operators/chunk_eval_op.cc):
    the chunk_eval op counts inferred/label/correct chunks ON DEVICE
    each batch and three scalar states accumulate them — evaluating a
    pass fetches three scalars, never the [B, T] predictions.
    Host twin (golden reference in tests): evaluator.ChunkEvaluator.

    `input`/`label` are int tag tensors [B, T] or [B, T, 1] in the IOB
    encoding (2k = B-type-k, 2k+1 = I-type-k, >= 2*num_chunk_types =
    O); `seq_len` optionally masks padded positions."""

    def __init__(self, input, label, num_chunk_types, seq_len=None):
        super().__init__("chunk_state")
        from . import framework
        n_inf = self._create_state("num_infer", [1], "float32")
        n_lab = self._create_state("num_label", [1], "float32")
        n_cor = self._create_state("num_correct", [1], "float32")
        with framework.program_guard(self.main_program,
                                     self.startup_program):
            blk = self.main_program.current_block()
            outs = {}
            for slot in ("NumInferChunks", "NumLabelChunks",
                         "NumCorrectChunks", "Precision", "Recall",
                         "F1Score"):
                v = blk.create_var(name=f"{self._prefix}.{slot}",
                                   dtype="float32")
                outs[slot] = [v.name]
            ins = {"Inference": [input.name], "Label": [label.name]}
            # padding mask: an explicit seq_len wins; else either
            # operand's @SEQLEN companion (predictions may come from ops
            # that do not propagate it — the label data var usually does)
            auto_sl = (getattr(input, "seq_len_var", None)
                       or getattr(label, "seq_len_var", None))
            if seq_len is not None:
                ins["SeqLen"] = [seq_len if isinstance(seq_len, str)
                                 else seq_len.name]
            elif auto_sl:
                ins["SeqLen"] = [auto_sl]
            blk.append_op("chunk_eval", ins, outs,
                          {"num_chunk_types": int(num_chunk_types)})
            self._accumulate(n_inf, blk.var(outs["NumInferChunks"][0]))
            self._accumulate(n_lab, blk.var(outs["NumLabelChunks"][0]))
            self._accumulate(n_cor, blk.var(outs["NumCorrectChunks"][0]))
            self.main_program.bump()
        self.batch_f1 = outs["F1Score"][0]
        self._fetches = self._build_state_reads((n_cor, n_inf, n_lab))

    def eval(self, executor, scope=None):
        """(precision, recall, f1) over everything accumulated since the
        last reset — same contract as the host ChunkEvaluator.eval."""
        cor, inf, lab = (float(np.ravel(v)[0]) for v in executor.run(
            self.eval_program, fetch_list=self._fetches, scope=scope))
        p = cor / max(inf, 1.0)
        r = cor / max(lab, 1.0)
        f1 = 2 * p * r / max(p + r, 1e-12)
        return p, r, f1
