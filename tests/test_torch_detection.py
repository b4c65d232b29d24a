"""The SSD op set and detection layers in the port, on the CPU.

Port twins of the ten tests of tests/test_detection.py (the same
golden values, numpy references, synthetic data, steps and thresholds,
including the SSD head that trains and detects and its hard-negative
variant), and each op against the JAX package's lowering on the same
seeded numpy inputs:

  * prior_box within 1 ulp (f32 from Python-float steps in both);
  * iou_similarity and box_coder (all three code types) within 1e-6 of
    each output's largest element, and their gradients and
    target_assign's within 1e-5 of each gradient's largest element;
  * bipartite_match (both match types), target_assign,
    mine_hard_examples' mask and multiclass_nms' Out and OutCount
    exactly, ties included: a case where every score ties, so that the
    padding rows carry the boxes the tie order puts there.

Then the tiny SSD twin (64 x 64 images, two conv stages, three feature
maps, the first l2-normalised times a learned scale): its main and
startup Program dicts equal the JAX front end's, one step on the JAX
package's parameters gives the loss within 1e-5 relative and every
parameter gradient within 1e-4 of its largest element, program_flops
equals the reference auditor's tally, and the hard-negative mask equals
the JAX op's on the JAX side's own conf_loss, match indices and match
distances. On a feed where the normalised map has an all-zero position
the reference's gradients below the normalisation are NaN and the
port's finite (ROADMAP C26); the rest is held as above.
"""

import math

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.monitor import introspect as jintrospect
import paddle_tpu_torch as pt
from paddle_tpu_torch.layers import detection as det
from paddle_tpu_torch.monitor import introspect
from paddle_tpu_torch.weights import scope_from_numpy
from torch_parity_helpers import run_both
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

VAL_REL = 1e-6      # IoU and box codes: of each output's largest element
GRAD_REL = 1e-5     # the differentiable ops' gradients
STEP_LOSS_REL = 1e-5
STEP_GRAD_REL = 1e-4


@pytest.fixture(autouse=True)
def _fresh_programs():
    for P in (jpt, pt):
        P.framework.reset_default_programs()
    yield


def _run(fetch_list, feed=None, startup=False):
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    if startup:
        exe.run(pt.default_startup_program(), scope=scope)
    return exe.run(pt.default_main_program(), feed=feed or {},
                   fetch_list=fetch_list, scope=scope)


def np_iou(a, b):
    out = np.zeros((len(a), len(b)))
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            iw = max(0, min(x[2], y[2]) - max(x[0], y[0]))
            ih = max(0, min(x[3], y[3]) - max(x[1], y[1]))
            inter = iw * ih
            ua = ((x[2] - x[0]) * (x[3] - x[1])
                  + (y[2] - y[0]) * (y[3] - y[1]) - inter)
            out[i, j] = inter / ua if ua > 0 else 0.0
    return out


# -- twins of tests/test_detection.py ----------------------------------------

def test_prior_box_matches_reference_formula():
    fmap = pt.layers.data(name="f", shape=[8, 4, 4],
                          append_batch_size=False)
    fmap.shape = (1, 8, 4, 4)
    img = pt.layers.data(name="img", shape=[3, 64, 64],
                         append_batch_size=False)
    img.shape = (1, 3, 64, 64)
    boxes, var = det.prior_box(fmap, img, min_sizes=[16.0],
                               max_sizes=[32.0], aspect_ratios=[2.0],
                               flip=True, clip=False)
    b, v = _run([boxes, var],
                feed={"f": np.zeros((1, 8, 4, 4), np.float32),
                      "img": np.zeros((1, 3, 64, 64), np.float32)})
    assert b.shape == (4, 4, 4, 4)
    cx = cy = 8.0
    np.testing.assert_allclose(
        b[0, 0, 0], [(cx - 8) / 64, (cy - 8) / 64,
                     (cx + 8) / 64, (cy + 8) / 64], rtol=1e-5)
    s = math.sqrt(16 * 32) / 2
    np.testing.assert_allclose(
        b[0, 0, 1], [(cx - s) / 64, (cy - s) / 64,
                     (cx + s) / 64, (cy + s) / 64], rtol=1e-5)
    w, h = 16 * math.sqrt(2) / 2, 16 / math.sqrt(2) / 2
    np.testing.assert_allclose(
        b[0, 0, 2], [(cx - w) / 64, (cy - h) / 64,
                     (cx + w) / 64, (cy + h) / 64], rtol=1e-5)
    np.testing.assert_allclose(v[0, 0, 0], [0.1, 0.1, 0.2, 0.2])


def test_iou_similarity_golden():
    a = np.array([[0, 0, 2, 2], [1, 1, 3, 3]], np.float32)
    b = np.array([[0, 0, 2, 2], [2, 2, 4, 4], [10, 10, 11, 11]],
                 np.float32)
    x = pt.layers.data(name="x", shape=[4], dtype="float32",
                       append_batch_size=False)
    x.shape = (2, 4)
    y = pt.layers.data(name="y", shape=[4], dtype="float32",
                       append_batch_size=False)
    y.shape = (3, 4)
    o, = _run([det.iou_similarity(x, y)], feed={"x": a, "y": b})
    np.testing.assert_allclose(o, np_iou(a, b), rtol=1e-5)


def test_box_coder_encode_decode_roundtrip():
    rng = np.random.RandomState(0)
    M = 6
    priors = np.sort(rng.rand(M, 2, 2), axis=1).reshape(M, 4) \
        .astype(np.float32)
    pvar = np.full((M, 4), 0.1, np.float32)
    targets = np.sort(rng.rand(M, 2, 2), axis=1).reshape(M, 4) \
        .astype(np.float32) + 0.05
    pb = pt.layers.data(name="pb", shape=[4], append_batch_size=False)
    pb.shape = (M, 4)
    pv = pt.layers.data(name="pv", shape=[4], append_batch_size=False)
    pv.shape = (M, 4)
    tb = pt.layers.data(name="tb", shape=[4], append_batch_size=False)
    tb.shape = (M, 4)
    enc = det.box_coder(pb, pv, tb, code_type="encode_matched")
    dec = det.box_coder(pb, pv, enc, code_type="decode_center_size")
    d, = _run([dec], feed={"pb": priors, "pv": pvar, "tb": targets})
    np.testing.assert_allclose(d, targets, rtol=1e-4, atol=1e-5)


def test_bipartite_match_greedy_golden():
    dist = np.array([[[0.9, 0.2, 0.6],
                      [0.8, 0.7, 0.1]]], np.float32)
    x = pt.layers.data(name="d", shape=[2, 3], append_batch_size=False)
    x.shape = (1, 2, 3)
    i, v = _run(list(det.bipartite_match(x)), feed={"d": dist})
    np.testing.assert_array_equal(i[0], [0, 1, -1])
    np.testing.assert_allclose(v[0], [0.9, 0.7, 0.0])

    pt.framework.reset_default_programs()
    x = pt.layers.data(name="d", shape=[2, 3], append_batch_size=False)
    x.shape = (1, 2, 3)
    i, v = _run(list(det.bipartite_match(x, match_type="per_prediction",
                                         dist_threshold=0.5)),
                feed={"d": dist})
    np.testing.assert_array_equal(i[0], [0, 1, 0])
    np.testing.assert_allclose(v[0], [0.9, 0.7, 0.6])


def test_target_assign_golden():
    x = np.arange(12, dtype=np.float32).reshape(1, 3, 4)
    match = np.array([[1, -1, 2, 0]], np.int32)
    xv = pt.layers.data(name="x", shape=[3, 4], append_batch_size=False)
    xv.shape = (1, 3, 4)
    mv = pt.layers.data(name="m", shape=[4], dtype="int32",
                        append_batch_size=False)
    mv.shape = (1, 4)
    o, wv = _run(list(det.target_assign(xv, mv, mismatch_value=-7)),
                 feed={"x": x, "m": match})
    np.testing.assert_allclose(o[0, 0], x[0, 1])
    np.testing.assert_allclose(o[0, 1], [-7] * 4)
    np.testing.assert_allclose(o[0, 2], x[0, 2])
    np.testing.assert_allclose(o[0, 3], x[0, 0])
    np.testing.assert_allclose(wv[0, :, 0], [1, 0, 1, 1])


def np_nms_per_class(scores, boxes, thr, score_thr):
    order = np.argsort(-scores)
    keep = []
    sup = np.zeros(len(scores), bool)
    iou = np_iou(boxes, boxes)
    for i in order:
        if sup[i] or scores[i] < score_thr or scores[i] <= 0:
            continue
        keep.append(i)
        sup |= iou[i] >= thr
    return keep


def test_multiclass_nms_matches_numpy():
    rng = np.random.RandomState(1)
    M, C = 12, 3
    boxes = np.sort(rng.rand(M, 2, 2), axis=1).reshape(M, 4) \
        .astype(np.float32)
    scores = rng.rand(1, C, M).astype(np.float32)
    bv = pt.layers.data(name="b", shape=[4], append_batch_size=False)
    bv.shape = (M, 4)
    sv = pt.layers.data(name="s", shape=[C, M], append_batch_size=False)
    sv.shape = (1, C, M)
    out, count = det.multiclass_nms(bv, sv, background_label=0,
                                    score_threshold=0.3,
                                    nms_threshold=0.4, keep_top_k=10)
    o, n = _run([out, count], feed={"b": boxes, "s": scores})
    expect = []
    for c in range(1, C):
        for i in np_nms_per_class(scores[0, c], boxes, 0.4, 0.3):
            expect.append((c, scores[0, c, i], i))
    expect.sort(key=lambda t: -t[1])
    expect = expect[:10]
    assert int(n[0]) == len(expect)
    for row, (c, s, i) in zip(o[0], expect):
        assert int(row[0]) == c
        np.testing.assert_allclose(row[1], s, rtol=1e-5)
        np.testing.assert_allclose(row[2:], boxes[i], rtol=1e-5)
    assert (o[0, len(expect):, 0] == -1).all()


def test_ssd_head_trains_and_detects():
    """A one-feature-map SSD head on synthetic images with one gt box
    each: the loss halves in 60 Adam steps and the detections after NMS
    score mAP > 0.5; padded gt without counts gives the same mAP."""
    rng = np.random.RandomState(2)
    B, G = 4, 2
    imgs = rng.rand(B, 3, 32, 32).astype(np.float32)
    gt_boxes = np.zeros((B, G, 4), np.float32)
    gt_labels = np.zeros((B, G), np.int32)
    for b in range(B):
        x0, y0 = rng.rand(2) * 0.4
        gt_boxes[b, 0] = [x0, y0, x0 + 0.4, y0 + 0.4]
        gt_labels[b, 0] = 1 + (b % 2)
    gt_counts = np.ones(B, np.int32)

    img = pt.layers.data(name="img", shape=[3, 32, 32], dtype="float32")
    gb = pt.layers.data(name="gb", shape=[G, 4], dtype="float32")
    gl = pt.layers.data(name="gl", shape=[G], dtype="int32")
    feat = pt.layers.conv2d(img, 16, 3, stride=4, padding=1, act="relu")
    loc, conf, priors, pvars = det.multi_box_head(
        [feat], img, min_sizes=[[12.0, 20.0]], aspect_ratios=[[2.0]],
        num_classes=3, clip=True)
    loss = pt.layers.mean(det.ssd_loss(loc, conf, gb, gl, priors, pvars))
    pt.AdamOptimizer(learning_rate=0.02).minimize(loss)

    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope)
    feed = {"img": imgs, "gb": gt_boxes, "gl": gt_labels}
    losses = []
    for _ in range(60):
        l, = exe.run(pt.default_main_program(), feed=feed,
                     fetch_list=[loss], scope=scope)
        losses.append(float(np.ravel(l)[0]))
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])

    probs = pt.layers.softmax(conf)
    nms_out, nms_count = det.detection_output(
        loc, probs, priors, pvars, score_threshold=0.1,
        nms_threshold=0.4, keep_top_k=8)
    infer_prog = pt.default_main_program().clone(for_test=True)
    dets, counts = exe.run(infer_prog, feed=feed,
                           fetch_list=[nms_out, nms_count], scope=scope)
    assert (counts >= 1).all()

    ev = pt.evaluator.DetectionMAP(overlap_threshold=0.3)
    ev.update(dets, gt_boxes, gt_labels, gt_counts)
    assert ev.eval() > 0.5, ev.eval()
    ev2 = pt.evaluator.DetectionMAP(overlap_threshold=0.3)
    ev2.update(dets, gt_boxes, gt_labels)
    assert ev2.eval() == ev.eval()


def test_mine_hard_examples_golden():
    """max_negative mining: unmatched priors ranked by loss, 3:1 cap."""
    cls_loss = np.array([[5.0, 1.0, 4.0, 3.0, 2.0, 0.5]], np.float32)
    match = np.array([[0, -1, -1, -1, -1, -1]], np.int32)
    dist = np.zeros((1, 6), np.float32)
    cl = pt.layers.data(name="cl", shape=[6], append_batch_size=False)
    cl.shape = (1, 6)
    mi = pt.layers.data(name="mi", shape=[6], dtype="int32",
                        append_batch_size=False)
    mi.shape = (1, 6)
    md = pt.layers.data(name="md", shape=[6], append_batch_size=False)
    md.shape = (1, 6)
    mask = det.mine_hard_examples(cl, mi, md, neg_pos_ratio=3.0)
    m, = _run([mask], feed={"cl": cls_loss, "mi": match, "md": dist})
    np.testing.assert_array_equal(m[0], [0, 0, 1, 1, 1, 0])


def test_ssd_loss_with_hard_negative_mining_trains():
    rng = np.random.RandomState(4)
    B, G = 4, 2
    imgs = rng.rand(B, 3, 32, 32).astype(np.float32)
    gt_boxes = np.zeros((B, G, 4), np.float32)
    gt_labels = np.zeros((B, G), np.int32)
    for b in range(B):
        x0, y0 = rng.rand(2) * 0.4
        gt_boxes[b, 0] = [x0, y0, x0 + 0.4, y0 + 0.4]
        gt_labels[b, 0] = 1

    img = pt.layers.data(name="img", shape=[3, 32, 32], dtype="float32")
    gb = pt.layers.data(name="gb", shape=[G, 4], dtype="float32")
    gl = pt.layers.data(name="gl", shape=[G], dtype="int32")
    feat = pt.layers.conv2d(img, 8, 3, stride=4, padding=1, act="relu")
    loc, conf, priors, pvars = det.multi_box_head(
        [feat], img, min_sizes=[[12.0]], aspect_ratios=[[2.0]],
        num_classes=2, clip=True)
    loss = pt.layers.mean(det.ssd_loss(loc, conf, gb, gl, priors, pvars,
                                       neg_pos_ratio=3.0))
    pt.AdamOptimizer(learning_rate=0.05).minimize(loss)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope)
    feed = {"img": imgs, "gb": gt_boxes, "gl": gt_labels}
    losses = []
    for _ in range(40):
        l, = exe.run(pt.default_main_program(), feed=feed,
                     fetch_list=[loss], scope=scope)
        losses.append(float(np.ravel(l)[0]))
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])


def test_detection_map_perfect_predictions():
    ev = pt.evaluator.DetectionMAP()
    gt_boxes = np.array([[[0.1, 0.1, 0.5, 0.5], [0.6, 0.6, 0.9, 0.9]]])
    gt_labels = np.array([[1, 2]])
    dets = np.array([[[1, 0.95, 0.1, 0.1, 0.5, 0.5],
                      [2, 0.9, 0.6, 0.6, 0.9, 0.9],
                      [-1, 0, 0, 0, 0, 0]]])
    ev.update(dets, gt_boxes, gt_labels)
    assert ev.eval() == 1.0


# -- each op against the JAX package's lowering ------------------------------

def _boxes(rng, shape, lo=0.05, hi=0.5):
    """Valid corner boxes: a corner in [0, 0.5) and sides in [lo, hi)."""
    xy = rng.rand(*shape, 2) * 0.5
    wh = lo + rng.rand(*shape, 2) * (hi - lo)
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _close(p, j, rel):
    p = p.detach().numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
    j = np.asarray(j)
    assert p.shape == j.shape, (p.shape, j.shape)
    tol = rel * max(float(np.abs(j).max()), 1e-30)
    np.testing.assert_allclose(p, j, rtol=0, atol=tol)


def _equal(p, j):
    p = p.detach().numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
    j = np.asarray(j)
    assert p.shape == j.shape, (p.shape, j.shape)
    np.testing.assert_array_equal(p, j)


@pytest.mark.parametrize("case", ["ssd_conv4_3", "flip_steps_offset",
                                  "no_max_sizes"])
def test_prior_box_within_one_ulp_of_jax(case):
    fmap = np.zeros((1, 4, 38, 38) if case == "ssd_conv4_3"
                    else (2, 4, 5, 7), np.float32)
    image = np.zeros((1, 3, 300, 300) if case == "ssd_conv4_3"
                     else (2, 3, 60, 90), np.float32)
    attrs = {"ssd_conv4_3": dict(min_sizes=[30.0], max_sizes=[60.0],
                                 aspect_ratios=[2.0], flip=True, clip=True),
             "flip_steps_offset": dict(min_sizes=[8.0, 16.0],
                                       max_sizes=[12.0, 24.0],
                                       aspect_ratios=[2.0, 3.0, 2.0],
                                       flip=True, clip=False, step_w=13.0,
                                       step_h=11.0, offset=0.25,
                                       variances=[0.1, 0.2, 0.3, 0.4]),
             "no_max_sizes": dict(min_sizes=[20.0], aspect_ratios=[0.5],
                                  flip=False, clip=True)}[case]
    jout, pout, _, _ = run_both("prior_box", {"Input": [fmap],
                                              "Image": [image]}, attrs)
    for slot in ("Boxes", "Variances"):
        p, j = pout[slot][0].numpy(), np.asarray(jout[slot][0])
        assert p.shape == j.shape and p.dtype == j.dtype == np.float32
        np.testing.assert_array_max_ulp(p, j, maxulp=1)


@pytest.mark.parametrize("batched", [False, True])
def test_iou_similarity_and_grads_match_jax(batched):
    rng = np.random.RandomState(10)
    x = _boxes(rng, (3, 5) if batched else (5,))
    y = _boxes(rng, (9,))
    y[0] = y[1]                     # a zero-width box and two equal ones
    y[2, 2] = y[2, 0]
    jout, pout, jg, pg = run_both("iou_similarity", {"X": [x], "Y": [y]},
                                  grad=("X", "Y"))
    _close(pout["Out"][0], jout["Out"][0], VAL_REL)
    for j, p in zip(jg, pg):
        _close(p, j, GRAD_REL)


@pytest.mark.parametrize("code_type", ["encode_center_size",
                                       "encode_matched",
                                       "decode_center_size"])
@pytest.mark.parametrize("with_var", [True, False])
def test_box_coder_and_grads_match_jax(code_type, with_var):
    rng = np.random.RandomState(11)
    M = 7
    prior = _boxes(rng, (M,))
    pvar = rng.uniform(0.1, 0.3, (M, 4)).astype(np.float32)
    if code_type == "encode_center_size":
        target = _boxes(rng, (5,))
    elif code_type == "encode_matched":
        target = _boxes(rng, (2, M))
    else:
        target = rng.uniform(-1, 1, (2, M, 4)).astype(np.float32)
    ins = {"PriorBox": [prior], "TargetBox": [target]}
    if with_var:
        ins["PriorBoxVar"] = [pvar]
    grad = ("TargetBox", "PriorBox") + (("PriorBoxVar",) if with_var
                                        else ())
    jout, pout, jg, pg = run_both("box_coder", ins,
                                  {"code_type": code_type},
                                  out="OutputBox", grad=grad)
    _close(pout["OutputBox"][0], jout["OutputBox"][0], VAL_REL)
    for j, p in zip(jg, pg):
        _close(p, j, GRAD_REL)


@pytest.mark.parametrize("match_type", ["bipartite", "per_prediction"])
def test_bipartite_match_matches_jax(match_type):
    """IoU of random gt boxes against priors, with equal entries: a row
    duplicated (two gt boxes tie everywhere) and values rounded to 1/8
    (ties across the matrix), a padded all-zero gt row."""
    rng = np.random.RandomState(12)
    dist = (np.round(rng.rand(3, 6, 40) * 8) / 8).astype(np.float32)
    dist[0, 3] = dist[0, 1]
    dist[1, 5] = 0.0
    dist[2, :, :30] = 0.0           # an image with few matches
    attrs = {"match_type": match_type, "dist_threshold": 0.5}
    jout, pout, _, _ = run_both("bipartite_match", {"DistMat": [dist]},
                                attrs)
    for slot in ("ColToRowMatchIndices", "ColToRowMatchDist"):
        _equal(pout[slot][0], jout[slot][0])
        assert pout[slot][0].numpy().dtype == np.asarray(jout[slot][0]).dtype


def test_target_assign_and_grad_match_jax():
    rng = np.random.RandomState(13)
    x = rng.randn(3, 5, 4).astype(np.float32)
    match = rng.randint(-1, 5, (3, 11)).astype(np.int32)
    match[0, :3] = 2                 # a gt row gathered three times
    jout, pout, jg, pg = run_both("target_assign",
                                  {"X": [x], "MatchIndices": [match]},
                                  {"mismatch_value": -3}, grad=("X",))
    for slot in ("Out", "OutWeight"):
        _equal(pout[slot][0], jout[slot][0])
    _close(pg[0], jg[0], GRAD_REL)


@pytest.mark.parametrize("seed,ties", [(20, False), (21, True)])
def test_mine_hard_examples_matches_jax(seed, ties):
    rng = np.random.RandomState(seed)
    B, P = 4, 300
    loss = rng.rand(B, P).astype(np.float32) * 3
    if ties:
        loss = (np.round(loss * 2) / 2).astype(np.float32)
    match = np.where(rng.rand(B, P) < 0.05, rng.randint(0, 5, (B, P)),
                     -1).astype(np.int32)
    match[3] = -1                    # no positive: no negative either
    dist = rng.rand(B, P).astype(np.float32)
    jout, pout, _, _ = run_both(
        "mine_hard_examples", {"ClsLoss": [loss[..., None]],
                               "MatchIndices": [match],
                               "MatchDist": [dist]},
        {"neg_pos_ratio": 3.0, "neg_dist_threshold": 0.5})
    _equal(pout["NegMask"][0], jout["NegMask"][0])
    assert 0 < float(pout["NegMask"][0].sum())


def _nms_case(seed, ties):
    rng = np.random.RandomState(seed)
    B, C, M = 2, 4, 60
    boxes = _boxes(rng, (B, M), 0.1, 0.4)
    boxes[0, 7] = boxes[0, 3]                 # identical boxes
    scores = rng.rand(B, C, M).astype(np.float32)
    if ties == "rounded":
        scores = (np.round(scores * 4) / 4).astype(np.float32)
    elif ties == "all":
        scores = np.full((B, C, M), 0.5, np.float32)
    return boxes, scores


@pytest.mark.parametrize("ties", ["none", "rounded", "all"])
@pytest.mark.parametrize("shared", [False, True])
def test_multiclass_nms_matches_jax(ties, shared):
    """Out and OutCount exactly. With every score equal, NMS keeps one box
    a cluster and the rows past OutCount are padding whose boxes are
    those the tie order ranks there: held too."""
    boxes, scores = _nms_case(30, ties)
    if shared:
        boxes = boxes[0]
    attrs = {"background_label": 0, "score_threshold": 0.2,
             "nms_threshold": 0.45, "nms_top_k": 25, "keep_top_k": 100}
    jout, pout, _, _ = run_both("multiclass_nms", {"Scores": [scores],
                                                   "BBoxes": [boxes]},
                                attrs)
    _equal(pout["Out"][0], jout["Out"][0])
    _equal(pout["OutCount"][0], np.asarray(jout["OutCount"][0]).astype(
        np.int32))
    assert pout["OutCount"][0].dtype == torch.int32
    n = pout["OutCount"][0].numpy()
    assert (n > 0).all() and (n < 100).all()


def test_multiclass_nms_keep_top_k_past_the_candidates():
    """keep_top_k above C x M: rows past C x M are all -1."""
    boxes, scores = _nms_case(31, "none")
    scores = scores[:, :2, :5]
    boxes = boxes[:, :5]
    attrs = {"background_label": 1, "score_threshold": 0.0,
             "nms_threshold": 0.3, "nms_top_k": 64, "keep_top_k": 16}
    jout, pout, _, _ = run_both("multiclass_nms", {"Scores": [scores],
                                                   "BBoxes": [boxes]},
                                attrs)
    _equal(pout["Out"][0], jout["Out"][0])
    assert (pout["Out"][0].numpy()[:, 10:] == -1).all()


# -- the tiny SSD twin --------------------------------------------------------

TINY_B, TINY_G, TINY_C, TINY_HW = 2, 4, 5, 64


def tiny_ssd(P, hard_negatives=3.0):
    """SSD300's structure at 64 x 64: two conv stages (3x3 convs + relu,
    2x2 max pools, the second in ceil_mode), the stage-2 map
    l2-normalised times a learned [16] scale initialised at 20, two
    extra pairs (1x1 then 3x3 stride 2), multi_box_head over the three
    maps, ssd_loss with hard-negative mining, mean, Momentum(1e-3,
    0.9). Returns (cost, params_grads, head outputs, the loss parts)."""
    L = P.layers
    img = L.data("img", [3, TINY_HW, TINY_HW])
    gb = L.data("gb", [TINY_G, 4])
    gl = L.data("gl", [TINY_G], dtype="int32")
    x = L.conv2d(img, 8, 3, padding=1, act="relu")
    x = L.pool2d(x, 2, "max", 2)
    x = L.conv2d(x, 16, 3, padding=1, act="relu")
    f1 = L.conv2d(x, 16, 3, padding=1, act="relu")              # 32 x 32
    scale = L.create_parameter(
        [16], "float32", name="norm_scale",
        default_initializer=P.initializer.ConstantInitializer(20.0))
    n1 = L.elementwise_mul(L.l2_normalize(f1, axis=1), scale, axis=1)
    x = L.pool2d(f1, 2, "max", 2, ceil_mode=True)               # 16 x 16
    x = L.conv2d(x, 8, 1, act="relu")
    f2 = L.conv2d(x, 16, 3, stride=2, padding=1, act="relu")    # 8 x 8
    x = L.conv2d(f2, 8, 1, act="relu")
    f3 = L.conv2d(x, 16, 3, stride=2, padding=1, act="relu")    # 4 x 4
    loc, conf, priors, pvars = P.layers.detection.multi_box_head(
        [n1, f2, f3], img, min_sizes=[8.0, 20.0, 36.0],
        max_sizes=[20.0, 36.0, 52.0], aspect_ratios=[[2.0], [2.0, 3.0],
                                                     [2.0]],
        num_classes=TINY_C, flip=True, clip=True)
    cost = L.mean(P.layers.detection.ssd_loss(
        loc, conf, gb, gl, priors, pvars, overlap_threshold=0.5,
        neg_pos_ratio=hard_negatives))
    pg = P.backward.append_backward(cost)
    return cost, pg, (loc, conf, priors, pvars)


def tiny_feed(seed=5):
    rng = np.random.RandomState(seed)
    imgs = rng.rand(TINY_B, 3, TINY_HW, TINY_HW).astype(np.float32)
    gtb = np.zeros((TINY_B, TINY_G, 4), np.float32)
    gtl = np.zeros((TINY_B, TINY_G), np.int32)
    for b in range(TINY_B):
        for g in range(rng.randint(1, TINY_G + 1)):
            side = rng.uniform(0.1, 0.6, 2)
            xy = rng.rand(2) * (1 - side)
            gtb[b, g] = [xy[0], xy[1], xy[0] + side[0], xy[1] + side[1]]
            gtl[b, g] = rng.randint(1, TINY_C)
    return {"img": imgs, "gb": gtb, "gl": gtl}


def _jax_params():
    exe, scope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
    exe.run(jpt.default_startup_program(), scope=scope)
    return {k: np.array(scope.get(k)) for k in scope.keys()
            if not k.startswith("__")}


def _tiny_first_step(feed):
    """One step of the tiny twin in both packages on the JAX package's
    parameters: ({package: [cost, gradients...]}, gradient names,
    {package: (main, startup, cost)})."""
    fetched, progs = {}, {}
    for P in (jpt, pt):
        P.framework.reset_default_programs()
        cost, pg, head = tiny_ssd(P)
        progs[P] = (P.default_main_program(), P.default_startup_program(),
                    cost)
        assert tuple(head[2].shape) == (32 * 32 * 4 + 8 * 8 * 6 + 4 * 4 * 4,
                                        4)
        names = [g.name for _, g in pg]
        if P is jpt:
            params = _jax_params()
            scope = jpt.Scope()
            for k, v in params.items():
                scope.set(k, v)
        else:
            scope = scope_from_numpy(params, "cpu")
        fetched[P] = [np.asarray(v) for v in P.Executor(P.CPUPlace()).run(
            progs[P][0], feed=feed, fetch_list=[cost] + names, scope=scope)]
    return fetched, names, progs


def test_tiny_ssd_program_step_and_flops_match_jax():
    """The tiny SSD twin: equal Program dicts; one step on the JAX
    package's parameters, the loss within 1e-5 relative and every
    parameter's gradient within 1e-4 of its largest element; 4544
    priors; program_flops equal to the reference auditor's tally."""
    feed = tiny_feed(6)
    fetched, names, progs = _tiny_first_step(feed)
    assert progs[pt][0].to_dict() == progs[jpt][0].to_dict()
    assert progs[pt][1].to_dict() == progs[jpt][1].to_dict()
    j, p = fetched[jpt], fetched[pt]
    np.testing.assert_allclose(p[0], j[0], rtol=STEP_LOSS_REL)
    assert len(names) == 2 * 7 + 2 * 6 + 1     # 7 + 6 convs, the scale
    for jg, pgv in zip(j[1:], p[1:]):
        _close(pgv, jg, STEP_GRAD_REL)
        assert np.abs(jg).max() > 0

    jmain, jstart, jcost = progs[jpt]
    jexe, jscope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
    jexe.run(jstart, scope=jscope)
    ref = jintrospect.program_flops(jmain, feed=feed,
                                    fetch_list=[jcost.name], scope=jscope,
                                    executor=jexe)
    assert introspect.program_flops(progs[pt][0], feed) == ref > 0


def test_tiny_ssd_all_zero_vector_under_l2_normalize():
    """ROADMAP C26: on this feed one position of the normalised relu map
    is zero in all 16 channels. There sqrt's gradient is inf and the
    maximum's 0, so l2_normalize's input gradient is NaN in both
    packages; the reference's relu gradient multiplies it by 0 (NaN) and
    every parameter below the normalisation gets a NaN gradient, while
    the port's relu gradient selects 0 where its input is <= 0. Those
    three convolutions' gradients are finite in the port; the loss and
    every other gradient match as in the test above."""
    feed = tiny_feed(5)
    fetched, names, _ = _tiny_first_step(feed)
    j, p = fetched[jpt], fetched[pt]
    np.testing.assert_allclose(p[0], j[0], rtol=STEP_LOSS_REL)
    below = {f"conv2d_{i}.w_{k}@GRAD_0" for i in range(3) for k in (0, 1)}
    assert {n for n, g in zip(names, j[1:]) if np.isnan(g).any()} == below
    for n, jg, pgv in zip(names, j[1:], p[1:]):
        if n in below:
            assert np.isfinite(pgv).all() and np.abs(pgv).max() > 0, n
        else:
            _close(pgv, jg, STEP_GRAD_REL)


def test_tiny_ssd_hard_negative_mask_on_jax_conf_loss():
    """The JAX program's conf_loss, match indices and match distances
    fetched, then the port's mine_hard_examples on them: the mask equals
    the JAX op's exactly."""
    feed = tiny_feed(6)
    cost, _, _ = tiny_ssd(jpt)
    blk = jpt.default_main_program().global_block()
    mine = next(op for op in blk.ops if op.type == "mine_hard_examples")
    names = [mine.inputs[s][0] for s in ("ClsLoss", "MatchIndices",
                                         "MatchDist")]
    params = _jax_params()
    scope = jpt.Scope()
    for k, v in params.items():
        scope.set(k, v)
    vals = jpt.Executor(jpt.CPUPlace()).run(
        feed=feed, fetch_list=names + [mine.outputs["NegMask"][0]],
        scope=scope)
    loss, match, dist, jmask = (np.asarray(v) for v in vals)
    _, pout, _, _ = run_both("mine_hard_examples",
                             {"ClsLoss": [loss], "MatchIndices": [match],
                              "MatchDist": [dist]},
                             dict(mine.attrs))
    _equal(pout["NegMask"][0], jmask)
    assert 0 < jmask.sum() < jmask.size
