"""Evaluators: metric accumulation across minibatches (fluid evaluator.py).

The port's copy of `paddle_tpu/evaluator.py`, which scores the
classifiers, the CTR models, sequence labelling, the OCR model, ranking
and detection:

  * host evaluators (`Accuracy`, `ChunkEvaluator`, `PrecisionRecall`,
    `Auc`, `EditDistance`, `DetectionMAP`, `PnpairEvaluator`): fetch a
    batch's metric, ids, tags, scores, distances or detections,
    `update()` on the host, `eval()` at the pass end;
  * in-graph evaluators (`InGraphAccuracy`, `InGraphAuc`,
    `InGraphPrecisionRecall`, `InGraphChunkEvaluator`, `InGraphPnpair`,
    `InGraphDetectionMAP`): the
    accumulators are persistable program vars updated by ops inside the
    training step, so a pass loop fetches only scalars — raw
    predictions never cross to the host. `eval()` runs a small eval
    program over the states, `reset()` a program of fill ops.

Program text and state names equal the JAX package's.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Evaluator", "Accuracy", "ChunkEvaluator", "PrecisionRecall",
           "Auc", "EditDistance", "DetectionMAP", "PnpairEvaluator",
           "InGraphEvaluator", "InGraphAccuracy", "InGraphAuc",
           "InGraphPrecisionRecall", "InGraphChunkEvaluator",
           "InGraphPnpair", "InGraphDetectionMAP"]


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


class PrecisionRecall(Evaluator):
    """Multi-class precision/recall/F1 (reference
    gserver/evaluators/Evaluator.cpp precision_recall registry entry,
    :172-1153 family): per-class confusion counts accumulated across
    batches; eval() returns (macro_p, macro_r, macro_f1) plus per-class
    rows via `stats()`."""

    def __init__(self, num_classes):
        self.num_classes = num_classes
        self.reset()

    def reset(self, *a, **k):
        self.tp = np.zeros(self.num_classes, np.int64)
        self.fp = np.zeros(self.num_classes, np.int64)
        self.fn = np.zeros(self.num_classes, np.int64)

    def update(self, pred_ids, label_ids):
        pred = np.ravel(np.asarray(pred_ids)).astype(np.int64)
        lab = np.ravel(np.asarray(label_ids)).astype(np.int64)
        C = self.num_classes
        tp = np.bincount(lab[pred == lab], minlength=C)[:C]
        self.tp += tp
        self.fp += np.bincount(pred, minlength=C)[:C] - tp
        self.fn += np.bincount(lab, minlength=C)[:C] - tp

    def stats(self):
        p = self.tp / np.maximum(self.tp + self.fp, 1)
        r = self.tp / np.maximum(self.tp + self.fn, 1)
        f1 = 2 * p * r / np.maximum(p + r, 1e-12)
        return p, r, f1

    def eval(self, *a, **k):
        p, r, f1 = self.stats()
        return float(p.mean()), float(r.mean()), float(f1.mean())


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


class DetectionMAP(Evaluator):
    """VOC-style mean average precision (the detection_map evaluator,
    reference operators/detection_map_op.* and gserver
    DetectionMAPEvaluator). update() consumes the padded NMS output
    (layers.multiclass_nms): detections [B, K, 6] (label, score, box)
    with -1-label padding, gt boxes [B, G, 4] with per-image counts."""

    def __init__(self, overlap_threshold=0.5, ap_version="integral",
                 background_label=0):
        assert ap_version in ("integral", "11point")
        self.overlap_threshold = overlap_threshold
        self.ap_version = ap_version
        self.background_label = background_label
        self.reset()

    def reset(self, *a, **k):
        self._dets = {}      # class -> list of (score, is_tp)
        self._gt_count = {}  # class -> total gt boxes

    @staticmethod
    def _iou(a, b):
        ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
        iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
        inter = ix * iy
        ua = ((a[2] - a[0]) * (a[3] - a[1])
              + (b[2] - b[0]) * (b[3] - b[1]) - inter)
        return inter / ua if ua > 0 else 0.0

    def update(self, detections, gt_boxes, gt_labels, gt_counts=None):
        detections = np.asarray(detections)
        gt_boxes = np.asarray(gt_boxes)
        gt_labels = np.asarray(gt_labels)
        B = detections.shape[0]
        for b in range(B):
            n_gt = (int(gt_counts[b]) if gt_counts is not None
                    else gt_boxes.shape[1])
            # background-labelled gt rows are padding (the ssd_loss
            # padded-gt contract), never real objects — skip them so
            # padded input without gt_counts cannot deflate mAP
            gt_valid = [g for g in range(n_gt)
                        if int(gt_labels[b, g]) != self.background_label]
            for g in gt_valid:
                c = int(gt_labels[b, g])
                self._gt_count[c] = self._gt_count.get(c, 0) + 1
            matched = set()
            dets = [d for d in detections[b]
                    if d[0] >= 0 and int(d[0]) != self.background_label]
            dets.sort(key=lambda d: -d[1])
            for d in dets:
                c = int(d[0])
                best, best_g = 0.0, -1
                for g in range(n_gt):
                    if int(gt_labels[b, g]) != c or g in matched:
                        continue
                    ov = self._iou(d[2:6], gt_boxes[b, g])
                    if ov > best:
                        best, best_g = ov, g
                tp = best >= self.overlap_threshold and best_g >= 0
                if tp:
                    matched.add(best_g)
                self._dets.setdefault(c, []).append((float(d[1]), tp))

    def eval(self, *a, **k):
        aps = []
        for c, total_gt in self._gt_count.items():
            dets = sorted(self._dets.get(c, []), key=lambda x: -x[0])
            if not dets or total_gt == 0:
                aps.append(0.0)
                continue
            tps = np.cumsum([1.0 if tp else 0.0 for _, tp in dets])
            fps = np.cumsum([0.0 if tp else 1.0 for _, tp in dets])
            recall = tps / total_gt
            precision = tps / np.maximum(tps + fps, 1e-12)
            if self.ap_version == "11point":
                ap = float(np.mean([
                    max([p for p, r in zip(precision, recall) if r >= t],
                        default=0.0)
                    for t in np.linspace(0, 1, 11)]))
            else:
                # integral: sum precision at each new recall point
                ap = 0.0
                prev_r = 0.0
                for p, r in zip(precision, recall):
                    ap += p * (r - prev_r)
                    prev_r = r
                ap = float(ap)
            aps.append(ap)
        return float(np.mean(aps)) if aps else 0.0


class PnpairEvaluator(Evaluator):
    """Positive-negative pair ratio for ranking (the pnpair evaluator,
    reference gserver/evaluators/Evaluator.cpp registry): within each
    query, counts score-ordered pairs whose labels agree vs disagree.
    update() takes (scores, labels, query_ids)."""

    def __init__(self):
        self.reset()

    def reset(self, *a, **k):
        self.pos = 0.0   # correctly ordered pairs
        self.neg = 0.0   # inverted pairs
        self.spe = 0.0   # ties (split evenly, like the reference)

    def update(self, scores, labels, query_ids=None):
        s = np.ravel(np.asarray(scores, np.float64))
        y = np.ravel(np.asarray(labels, np.float64))
        q = (np.ravel(np.asarray(query_ids)) if query_ids is not None
             else np.zeros_like(y))
        for qid in np.unique(q):
            sel = q == qid
            ss, yy = s[sel], y[sel]
            n = len(ss)
            # vectorized pair counting: sign agreement of score and
            # label differences over the upper triangle
            iu, ju = np.triu_indices(n, 1)
            dy = yy[iu] - yy[ju]
            rel = dy != 0
            agree = np.sign(ss[iu] - ss[ju])[rel] * np.sign(dy[rel])
            self.pos += int((agree > 0).sum())
            self.neg += int((agree < 0).sum())
            self.spe += int((agree == 0).sum())

    def eval(self, *a, **k):
        """pos:neg ratio (ties split)."""
        return ((self.pos + 0.5 * self.spe)
                / max(self.neg + 0.5 * self.spe, 1e-12))


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


class InGraphPrecisionRecall(InGraphEvaluator):
    """Per-class confusion counts (tp/fp/fn) as in-graph histogram
    states; eval() returns (macro_p, macro_r, macro_f1) like the host
    PrecisionRecall (gserver precision_recall evaluator)."""

    def __init__(self, pred_ids, label_ids, num_classes):
        super().__init__("pr_state")
        from . import framework
        from .layers import tensor as T
        C = num_classes
        tp = self._create_state("tp", [C], "float32")
        fp = self._create_state("fp", [C], "float32")
        fn = self._create_state("fn", [C], "float32")
        with framework.program_guard(self.main_program,
                                     self.startup_program):
            blk = self.main_program.current_block()
            # flatten both id tensors: argmax yields [B] while data
            # labels are [B, 1] — elementwise compare must not broadcast
            flat_p = blk.create_var(name=f"{self._prefix}.pred_flat")
            flat_l = blk.create_var(name=f"{self._prefix}.label_flat")
            blk.append_op("reshape", {"X": [pred_ids.name]},
                          {"Out": [flat_p.name]}, {"shape": [-1]})
            blk.append_op("reshape", {"X": [label_ids.name]},
                          {"Out": [flat_l.name]}, {"shape": [-1]})
            pred_ids, label_ids = flat_p, flat_l
            hit = blk.create_var(name=f"{self._prefix}.hit")
            blk.append_op("equal", {"X": [pred_ids.name],
                                    "Y": [label_ids.name]},
                          {"Out": [hit.name]}, {})
            hit_f = T.cast(blk.var(hit.name), "float32")
            one = T.fill_constant([1], "float32", 1.0)
            miss = blk.create_var(name=f"{self._prefix}.miss")
            blk.append_op("elementwise_sub",
                          {"X": [one.name], "Y": [hit_f.name]},
                          {"Out": [miss.name]}, {})
            blk.append_op("scatter_add_1d",
                          {"X": [tp.name], "Index": [label_ids.name],
                           "Weight": [hit_f.name]},
                          {"Out": [tp.name]}, {})
            blk.append_op("scatter_add_1d",
                          {"X": [fp.name], "Index": [pred_ids.name],
                           "Weight": [miss.name]},
                          {"Out": [fp.name]}, {})
            blk.append_op("scatter_add_1d",
                          {"X": [fn.name], "Index": [label_ids.name],
                           "Weight": [miss.name]},
                          {"Out": [fn.name]}, {})
            self.main_program.bump()
        self._fetches = self._build_state_reads((tp, fp, fn))

    def eval(self, executor, scope=None):
        tp, fp, fn = executor.run(self.eval_program,
                                  fetch_list=self._fetches, scope=scope)
        tp, fp, fn = (np.asarray(x, np.float64) for x in (tp, fp, fn))
        p = tp / np.maximum(tp + fp, 1)
        r = tp / np.maximum(tp + fn, 1)
        f1 = 2 * p * r / np.maximum(p + r, 1e-12)
        return float(p.mean()), float(r.mean()), float(f1.mean())


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


class InGraphPnpair(InGraphEvaluator):
    """Positive-negative ranking pair ratio with in-graph accumulators
    (gserver pnpair evaluator; host twin: PnpairEvaluator): the
    pnpair_eval op counts query-grouped ordered pairs on device each
    batch; eval() is a three-scalar fetch."""

    def __init__(self, score, label, query_id=None, weight=None):
        super().__init__("pnpair_state")
        from . import framework
        pos = self._create_state("pos", [1], "float32")
        neg = self._create_state("neg", [1], "float32")
        spe = self._create_state("spe", [1], "float32")
        with framework.program_guard(self.main_program,
                                     self.startup_program):
            blk = self.main_program.current_block()
            outs = {}
            for slot in ("Pos", "Neg", "Spe"):
                v = blk.create_var(name=f"{self._prefix}.{slot}",
                                   dtype="float32")
                outs[slot] = [v.name]
            ins = {"Score": [score.name], "Label": [label.name]}
            if query_id is not None:
                ins["QueryId"] = [query_id.name]
            if weight is not None:
                ins["Weight"] = [weight.name]
            blk.append_op("pnpair_eval", ins, outs, {})
            self._accumulate(pos, blk.var(outs["Pos"][0]))
            self._accumulate(neg, blk.var(outs["Neg"][0]))
            self._accumulate(spe, blk.var(outs["Spe"][0]))
            self.main_program.bump()
        self._fetches = self._build_state_reads((pos, neg, spe))

    def eval(self, executor, scope=None):
        """pos:neg ratio with ties split — PnpairEvaluator.eval."""
        pos, neg, spe = (float(np.ravel(v)[0]) for v in executor.run(
            self.eval_program, fetch_list=self._fetches, scope=scope))
        return (pos + 0.5 * spe) / max(neg + 0.5 * spe, 1e-12)


class InGraphDetectionMAP(InGraphEvaluator):
    """Detection mAP with in-graph accumulators (reference
    operators/detection_map_op.*; host twin: DetectionMAP).

    Divergence from the reference, by design: the reference op carries
    exact per-class (score, tp) lists that GROW across batches —
    dynamic state a captured step cannot hold. Here the state is a fixed
    [num_classes, num_buckets] tp/fp score-histogram pair plus
    per-class positive counts (the AUC trade); AP from the bucketed
    curve equals the exact AP whenever scores sit on bucket boundaries
    and converges as num_buckets grows. The host DetectionMAP remains
    the exact offline tool."""

    def __init__(self, detections, gt_boxes, gt_labels, gt_count=None,
                 num_classes=21, num_buckets=512, overlap_threshold=0.5,
                 ap_version="integral", background_label=0):
        assert ap_version in ("integral", "11point")
        super().__init__("detmap_state")
        from . import framework
        self.ap_version = ap_version
        C, Nb = num_classes, num_buckets
        tp_h = self._create_state("tp_hist", [C, Nb], "float32")
        fp_h = self._create_state("fp_hist", [C, Nb], "float32")
        npos = self._create_state("pos_count", [C], "float32")
        with framework.program_guard(self.main_program,
                                     self.startup_program):
            blk = self.main_program.current_block()
            outs = {}
            for slot in ("TpHist", "FpHist", "PosCount"):
                v = blk.create_var(name=f"{self._prefix}.{slot}",
                                   dtype="float32")
                outs[slot] = [v.name]
            ins = {"Detections": [detections.name],
                   "GtBoxes": [gt_boxes.name],
                   "GtLabels": [gt_labels.name]}
            if gt_count is not None:
                ins["GtCount"] = [gt_count.name]
            blk.append_op("detection_map_buckets", ins, outs,
                          {"num_classes": C, "num_buckets": Nb,
                           "overlap_threshold": float(overlap_threshold),
                           "background_label": int(background_label)})
            self._accumulate(tp_h, blk.var(outs["TpHist"][0]))
            self._accumulate(fp_h, blk.var(outs["FpHist"][0]))
            self._accumulate(npos, blk.var(outs["PosCount"][0]))
            self.main_program.bump()
        self._fetches = self._build_state_reads((tp_h, fp_h, npos))

    def eval(self, executor, scope=None):
        tp_h, fp_h, npos = (np.asarray(v, np.float64)
                            for v in executor.run(
                                self.eval_program,
                                fetch_list=self._fetches, scope=scope))
        aps = []
        for c in range(tp_h.shape[0]):
            if npos[c] <= 0:
                continue
            # sweep buckets high score -> low: cumulative tp/fp curve
            tps = np.cumsum(tp_h[c][::-1])
            fps = np.cumsum(fp_h[c][::-1])
            keep = (tp_h[c][::-1] + fp_h[c][::-1]) > 0
            if not keep.any():
                aps.append(0.0)
                continue
            recall = tps[keep] / npos[c]
            precision = tps[keep] / np.maximum(tps[keep] + fps[keep],
                                               1e-12)
            if self.ap_version == "11point":
                ap = float(np.mean([
                    max([p for p, r in zip(precision, recall)
                         if r >= t], default=0.0)
                    for t in np.linspace(0, 1, 11)]))
            else:
                ap, prev_r = 0.0, 0.0
                for p, r in zip(precision, recall):
                    ap += p * (r - prev_r)
                    prev_r = r
            aps.append(float(ap))
        return float(np.mean(aps)) if aps else 0.0
