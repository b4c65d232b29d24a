"""`roi_pool` in the port against the JAX package's lowering, on the CPU.

The same seeded numpy inputs through both lowerings: Out and Argmax
exactly (the first maximum in the map's flat h * W + w order, -1 for an
empty bin), and the gradient of X within 1e-6 of its largest element
(the two sum overlapping bins' shares in different orders). Cases:
tests/test_vision_op_tail.py::test_roi_pool's (two images, the ROIs
grouped by the @SEQLEN counts), a relu-zero map whose bins tie at 0 and
whose gradient splits evenly among the tied elements as the reference's
jnp.max gives it (1/3 each for three ties, not the 1/4, 1/4, 1/2 of a
rows-then-columns max), ROIs off the map (empty bins), no SeqLen (every
ROI on image 0), an image with no ROI, spatial_scale 1/16 with rounding
at halves, and ROIs gathered in several chunks.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import registry as preg
from paddle_tpu_torch.ops import vision_ops
from torch_parity_helpers import run_both
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GRAD_REL = 1e-6


def _check(x, rois, attrs, lens=None, cot=None):
    ins = {"X": [x], "ROIs": [rois]}
    if lens is not None:
        ins["SeqLen"] = [lens]
    jout, pout, jg, pg = run_both("roi_pool", ins, attrs, out="Out",
                                  grad=("X",), cot=cot)
    np.testing.assert_array_equal(pout["Out"][0].numpy(),
                                  np.asarray(jout["Out"][0]))
    assert pout["Argmax"][0].dtype == torch.int64
    np.testing.assert_array_equal(pout["Argmax"][0].numpy(),
                                  np.asarray(jout["Argmax"][0]))
    j, p = np.asarray(jg[0]), pg[0].numpy()
    tol = GRAD_REL * max(float(np.abs(j).max()), 1e-30)
    np.testing.assert_allclose(p, j, rtol=0, atol=tol)
    return pout, p


def test_roi_pool_matches_jax_on_the_reference_case():
    x = np.random.RandomState(0).permutation(2 * 2 * 8 * 8).reshape(
        2, 2, 8, 8).astype(np.float32)
    rois = np.asarray([[1, 1, 6, 6], [0, 0, 3, 3], [2, 2, 7, 7]],
                      np.float32)
    lens = np.asarray([2, 1], np.int64)
    pout, _ = _check(x, rois, {"spatial_scale": 1.0, "pooled_height": 2,
                               "pooled_width": 2}, lens)
    # the third ROI pools image 1
    assert pout["Out"][0][2].max() == x[1, :, 2:8, 2:8].max()


def test_roi_pool_gradient_splits_evenly_among_tied_maxima():
    """relu(randn) maps: most bins hold several zeros and some hold only
    zeros; each tied element gets the same share. One bin is built to
    hold three elements at its maximum: each gets 1/3 of its gradient."""
    rng = np.random.RandomState(1)
    x = np.maximum(rng.randn(1, 3, 9, 9), 0).astype(np.float32)
    x[0, 0, 0:3, 0:3] = [[0.5, 0.0, 0.5], [0.0, 0.5, 0.0], [0.0, 0.0, 0.0]]
    rois = np.asarray([[0, 0, 8, 8], [1, 2, 7, 5], [0, 0, 2, 2]],
                      np.float32)
    attrs = {"spatial_scale": 1.0, "pooled_height": 3, "pooled_width": 3}
    cot = np.zeros((3, 3, 3, 3), np.float32)
    cot[0, 0, 0, 0] = 1.0            # ROI 0, channel 0, bin (0, 0)
    _, grad = _check(x, rois, attrs, cot=cot)
    third = np.float32(1) / np.float32(3)
    np.testing.assert_array_equal(
        grad[0, 0, 0:3, 0:3],
        np.asarray([[third, 0, third], [0, third, 0], [0, 0, 0]],
                   np.float32))
    assert grad.sum() == pytest.approx(1.0)
    _check(x, rois, attrs)           # every bin at once


def test_roi_pool_empty_bins_and_rois_off_the_map():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 4, 6, 7).astype(np.float32)
    rois = np.asarray([[9, 9, 12, 12],      # wholly off the map
                       [5, 4, 9, 8],        # partly off
                       [-3, -2, 1, 1],      # negative corners
                       [2, 2, 2, 2]],       # 1 x 1
                      np.float32)
    pout, _ = _check(x, rois, {"spatial_scale": 1.0, "pooled_height": 3,
                               "pooled_width": 2},
                     np.asarray([1, 3], np.int64))
    out, arg = pout["Out"][0].numpy(), pout["Argmax"][0].numpy()
    assert (out[0] == 0).all() and (arg[0] == -1).all()
    assert (arg[1] == -1).any() and (arg[1] >= 0).any()


@pytest.mark.parametrize("lens", [None, [0, 3, 2], [3, 0, 2]],
                         ids=["no_seqlen", "first_empty", "middle_empty"])
def test_roi_pool_grouping_by_seqlen(lens):
    """Without SeqLen every ROI pools image 0; with it the counts assign
    the ROIs to images in order, an image with no ROI included."""
    rng = np.random.RandomState(3)
    x = rng.randn(3, 2, 10, 12).astype(np.float32)
    rois = np.concatenate([rng.randint(0, 6, (5, 2)),
                           rng.randint(6, 12, (5, 2))], 1).astype(np.float32)
    lens = None if lens is None else np.asarray(lens, np.int32)
    pout, _ = _check(x, rois, {"spatial_scale": 1.0, "pooled_height": 2,
                               "pooled_width": 3}, lens)
    img = [0] * 5 if lens is None else np.repeat(np.arange(3), lens)
    for n, b in enumerate(img):
        arg = pout["Argmax"][0][n].numpy()
        flat = x[b].reshape(2, -1)
        for c in range(2):
            np.testing.assert_array_equal(
                pout["Out"][0][n, c].numpy(),
                np.where(arg[c] >= 0, flat[c][arg[c]], 0))


def test_roi_pool_fast_rcnn_scale_in_several_chunks(monkeypatch):
    """spatial_scale 1/16 (corners at halves round to even) over a
    [2, 8, 12, 15] map, 7 x 7 bins, 24 ROIs gathered a few at a time."""
    rng = np.random.RandomState(4)
    x = np.maximum(rng.randn(2, 8, 12, 15), 0).astype(np.float32)
    xy = rng.randint(0, 160, (24, 2)) + rng.choice([0, 8], (24, 2))
    wh = rng.randint(16, 120, (24, 2))
    rois = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    monkeypatch.setattr(vision_ops, "_CHUNK_BYTES", 5 * 49 * 8 * 4 * 30)
    _check(x, rois, {"spatial_scale": 1.0 / 16, "pooled_height": 7,
                     "pooled_width": 7}, np.asarray([10, 14], np.int64))


def test_roi_pool_meta_shapes():
    """Build-time shape inference: Out and Argmax [N, C, PH, PW] on meta
    tensors, with no read on the host."""
    x = torch.empty((9973, 16, 20, 30), device="meta")
    rois = torch.empty((7, 4), device="meta")
    out = preg.get_op("roi_pool").lowering(
        None, {"X": [x], "ROIs": [rois]},
        {"spatial_scale": 0.5, "pooled_height": 3, "pooled_width": 4})
    assert tuple(out["Out"][0].shape) == (7, 16, 3, 4)
    assert out["Argmax"][0].dtype == torch.int64
