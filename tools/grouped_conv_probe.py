"""cuDNN's float32 convolution weight gradients on the card against a
float64 reference, at the shapes the port's models and `chip_smoke.py`
paths run and at sweeps around them, to tell which shapes cuDNN gets
wrong (ROADMAP C39).

    python3 tools/grouped_conv_probe.py

For each case (conv2d, conv_transpose2d, conv3d, conv_transpose3d; the
batch, channels, spatial size, kernel, stride, padding and groups the
case names): the forward, the data gradient and the weight gradient in
float32 (TF32 off) with cuDNN as the port runs it (deterministic
algorithms, no search: "det"), without the deterministic restriction
("nondet"), with its algorithm search ("bench"), and with cuDNN off
(PyTorch's own CUDA convolution: "nocudnn"), each as max |got - ref| /
max |ref| against the same product in float64 on the card with cuDNN
off; for conv2d also an im2col weight gradient summed by cuBLAS
(`weight_gemm`, the alternative weighed against "nocudnn"). Then the
weight gradient's time (CUDA events, median of 10 calls after one) by
cuDNN (det), with cuDNN off, and by `weight_gemm`. One JSON line a
case, then the card's name and power limit.
"""

import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from paddle_tpu_torch._device import use_full_f32  # noqa: E402

MODES = [("det", dict(deterministic=True, benchmark=False, enabled=True)),
         ("nondet", dict(deterministic=False, benchmark=False,
                         enabled=True)),
         ("bench", dict(deterministic=False, benchmark=True, enabled=True)),
         ("nocudnn", dict(deterministic=True, benchmark=False,
                          enabled=False))]


def case(tag, B, C, O, side, k, stride=1, pad=0, groups=1, op="conv2d"):
    nd = 3 if op.endswith("3d") else 2
    side = tuple(side) if isinstance(side, (list, tuple)) else (side,) * nd
    return {"tag": tag, "op": op, "B": B, "C": C, "O": O, "side": side,
            "k": k, "stride": stride, "pad": pad, "groups": groups}


# the f32 convolutions the port's models and chip_smoke.py's paths run
# with a kernel larger than 3 x 3 (the s2d rows are the stride-s stems
# after nn_ops._conv2d_s2d's rewrite), a few 3 x 3 and 1 x 1 controls,
# and the other convolution ops' weight gradients
PATHS = [
    case("legacy AlexNet conv1 (s2d: 3 x 3 over 48)", 128, 48, 96, 58, 3),
    case("legacy AlexNet conv1 (s2d off)", 128, 3, 96, 227, 11, 4, 1),
    case("legacy AlexNet conv2", 128, 96, 256, 27, 5, 1, 2),
    case("legacy AlexNet conv2, layer_num 2", 128, 96, 256, 27, 5, 1, 2, 2),
    case("legacy AlexNet conv4, layer_num 2", 128, 384, 384, 13, 3, 1, 1, 2),
    case("models/alexnet conv1 (s2d: 3 x 3 over 48)", 128, 48, 64, 57, 3),
    case("models/alexnet conv2", 128, 64, 192, 27, 5, 1, 2),
    case("recognize-digits conv1", 128, 1, 20, 28, 5),
    case("recognize-digits conv2", 128, 20, 50, 12, 5),
    case("ResNet-50 stem (s2d: 4 x 4 over 12), B 4", 4, 12, 64, 115, 4),
    case("ResNet-50 stem (s2d: 4 x 4 over 12), B 256", 256, 12, 64, 115, 4),
    case("ResNet-50 stem (s2d off), B 32", 32, 3, 64, 224, 7, 2, 3),
    case("GoogLeNet inception 3a 5 x 5", 128, 16, 32, 28, 5, 1, 2),
    case("GoogLeNet inception 3b 5 x 5", 128, 32, 96, 28, 5, 1, 2),
    case("GoogLeNet inception 4a 5 x 5", 128, 16, 48, 14, 5, 1, 2),
    case("GoogLeNet inception 4b-c 5 x 5", 128, 24, 64, 14, 5, 1, 2),
    case("GoogLeNet inception 4d 5 x 5", 128, 32, 64, 14, 5, 1, 2),
    case("GoogLeNet inception 4e 5 x 5", 128, 32, 128, 14, 5, 1, 2),
    case("GoogLeNet inception 5a 5 x 5", 128, 32, 128, 7, 5, 1, 2),
    case("GoogLeNet inception 5b 5 x 5", 128, 48, 128, 7, 5, 1, 2),
    case("smallnet conv1", 128, 3, 32, 32, 5, 1, 2),
    case("smallnet conv2", 128, 32, 32, 16, 5, 1, 2),
    case("VGG16 conv3_3 (3 x 3 control)", 32, 256, 256, 75, 3, 1, 1),
    case("ResNet-50 3 x 3 (control)", 32, 64, 64, 56, 3, 1, 1),
    case("1 x 1 (control)", 128, 256, 64, 28, 1),
    case("dynamic_conv2d (phase 40: a group a sample)", 1, 128, 256, 32, 3,
         1, 1, 16),
    case("conv3d C3D conv1", 8, 3, 64, (16, 112, 112), 3, 1, 1, op="conv3d"),
    case("conv3d C3D conv2", 8, 64, 128, (16, 56, 56), 3, 1, 1,
         op="conv3d"),
    case("conv3d_transpose C3D conv2 inverse", 8, 128, 64, (16, 56, 56), 3,
         1, 1, op="conv_transpose3d"),
    case("conv3d_transpose (phase 40 corpus)", 4, 16, 8, (4, 8, 8), 2, 2,
         op="conv_transpose3d"),
    case("conv2d_transpose FCN 4 x 4 s2 (21 classes)", 32, 21, 21, 34, 4,
         2, op="conv_transpose2d"),
    case("conv2d_transpose FCN-8s 16 x 16 s8", 8, 21, 21, 70, 16, 8,
         op="conv_transpose2d"),
    case("conv2d_transpose FCN-32s 64 x 64 s32", 8, 21, 21, 16, 64, 32,
         op="conv_transpose2d"),
    case("conv2d_transpose DCGAN 5 x 5 s2", 64, 256, 128, 16, 5, 2, 2,
         op="conv_transpose2d"),
    case("conv2d_transpose DCGAN 4 x 4 s2", 64, 512, 256, 8, 4, 2, 1,
         op="conv_transpose2d"),
]
# input channels a group of 5 x 5, 7 x 7, 11 x 11 and 4 x 4 kernels at
# B 128, 27 x 27, 128 outputs; batch, side and output-count neighbours
SWEEP = ([case(f"sweep 5 x 5 over {c}", 128, c, 128, 27, 5, 1, 2)
          for c in (1, 3, 8, 16, 20, 24, 32, 40, 44, 48, 56, 64, 80, 96,
                    128, 192, 256)]
         + [case(f"sweep 7 x 7 over {c}", 128, c, 128, 27, 7, 1, 3)
            for c in (3, 16, 32, 48, 64, 128)]
         + [case(f"sweep 11 x 11 over {c}", 128, c, 128, 27, 11, 1, 5)
            for c in (3, 16, 48, 64)]
         + [case(f"sweep 4 x 4 over {c}", 128, c, 128, 27, 4, 1, 0)
            for c in (12, 32, 48, 64, 128)]
         + [case(f"sweep 3 x 3 over {c}", 128, c, 128, 27, 3, 1, 1)
            for c in (48, 64, 128)]
         + [case("5 x 5 over 48, B 32", 32, 48, 128, 27, 5, 1, 2),
            case("5 x 5 over 48, 13 x 13", 128, 48, 128, 13, 5, 1, 2),
            case("5 x 5 over 48, 56 x 56", 128, 48, 128, 56, 5, 1, 2),
            case("5 x 5 over 48, 32 outputs", 128, 48, 32, 27, 5, 1, 2),
            case("5 x 5 over 48, 256 outputs", 128, 48, 256, 27, 5, 1, 2),
            case("5 x 5 over 64, stride 2", 128, 64, 128, 27, 5, 2, 2)])


@contextlib.contextmanager
def cudnn_mode(enabled, deterministic, benchmark):
    """Sets cuDNN's switches for the block and puts back the old ones."""
    cd = torch.backends.cudnn
    old = (cd.enabled, cd.deterministic, cd.benchmark)
    cd.enabled, cd.deterministic, cd.benchmark = (enabled, deterministic,
                                                  benchmark)
    try:
        yield
    finally:
        cd.enabled, cd.deterministic, cd.benchmark = old


def weight_gemm(x, gy, w_shape, stride, padding, groups):
    """conv2d's weight gradient as im2col columns (F.unfold) times gy,
    summed by cuBLAS over chunks of at most 256 MiB of columns."""
    N = int(x.shape[0])
    O, Cg, kh, kw = (int(d) for d in w_shape)
    L = int(gy.shape[2]) * int(gy.shape[3])
    K = Cg * kh * kw
    step = max(1, (256 << 20) // (int(x.shape[1]) * kh * kw * L * 4))
    dw = torch.zeros((groups, O // groups, K), dtype=x.dtype,
                     device=x.device)
    for n0 in range(0, N, step):
        n = min(step, N - n0)
        cols = F.unfold(x[n0:n0 + n], (kh, kw), padding=padding,
                        stride=stride)
        g = gy[n0:n0 + n].reshape(n, groups, O // groups, L)
        dw += torch.einsum("ngol,ngkl->gok", g,
                           cols.reshape(n, groups, K, L))
    return dw.reshape(O, Cg, kh, kw)


class Conv:
    """One case's operands and its three products through
    aten.convolution_backward, as autograd computes them."""

    def __init__(self, c, gen):
        nd = len(c["side"])
        self.c, self.nd = c, nd
        self.transposed = "transpose" in c["op"]
        k = (c["k"],) * nd
        g = c["groups"]
        w_shape = ((c["C"], c["O"] // g) + k if self.transposed
                   else (c["O"], c["C"] // g) + k)
        dev = "cuda"
        self.x = torch.randn((c["B"], c["C"]) + c["side"], generator=gen,
                             device=dev)
        fan_in = (c["C"] // g) * c["k"] ** nd
        self.w = torch.randn(w_shape, generator=gen, device=dev) \
            / fan_in ** 0.5
        self.stride = [c["stride"]] * nd
        self.pad = [c["pad"]] * nd
        with torch.no_grad():
            y = self.forward(self.x.double(), self.w.double())
        self.gy = torch.randn(y.shape, generator=gen, device=dev)

    def forward(self, x, w):
        return torch.ops.aten.convolution(
            x, w, None, self.stride, self.pad, [1] * self.nd,
            self.transposed, [0] * self.nd, self.c["groups"])

    def grads(self, x, w, gy, mask=(True, True)):
        dx, dw, _ = torch.ops.aten.convolution_backward(
            gy, x, w, None, self.stride, self.pad, [1] * self.nd,
            self.transposed, [0] * self.nd, self.c["groups"],
            [mask[0], mask[1], False])
        return dx, dw

    def dw(self):
        return self.grads(self.x, self.w, self.gy, (False, True))[1]

    def dw_gemm(self):
        return weight_gemm(self.x, self.gy, self.w.shape,
                           tuple(self.stride), tuple(self.pad),
                           self.c["groups"])


def rel(got, ref):
    return float((got.double() - ref).abs().max() / ref.abs().max())


def median_ms(fn, reps=10):
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def probe(c, gen):
    conv = Conv(c, gen)
    with cudnn_mode(False, True, False):
        xd, wd, gd = conv.x.double(), conv.w.double(), conv.gy.double()
        ref_y = conv.forward(xd, wd)
        ref_dx, ref_dw = conv.grads(xd, wd, gd)
        del xd, wd, gd
    out = dict(c)
    for name, flags in MODES:
        with cudnn_mode(**flags):
            out[f"{name}_y"] = rel(conv.forward(conv.x, conv.w), ref_y)
            dx, dw = conv.grads(conv.x, conv.w, conv.gy)
            out[f"{name}_dx"], out[f"{name}_dw"] = rel(dx, ref_dx), rel(
                dw, ref_dw)
            del dx, dw
    if c["op"] == "conv2d":
        out["gemm_dw"] = rel(conv.dw_gemm(), ref_dw)
    del ref_y, ref_dx, ref_dw
    with cudnn_mode(True, True, False):
        out["cudnn_dw_ms"] = median_ms(conv.dw)
    with cudnn_mode(False, True, False):
        out["nocudnn_dw_ms"] = median_ms(conv.dw)
    if c["op"] == "conv2d":
        out["gemm_dw_ms"] = median_ms(conv.dw_gemm)
    del conv
    torch.cuda.empty_cache()
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("grouped_conv_probe: no CUDA card visible")
    use_full_f32()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__}, cuDNN "
          f"{torch.backends.cudnn.version()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for c in PATHS + SWEEP:
        print(json.dumps(probe(c, gen)), flush=True)
    print(smi)


if __name__ == "__main__":
    main()
