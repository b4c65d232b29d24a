"""Time K1 (flash forward, Tq > 1) and K2 (fused flash backward) of one
checkout of the port, for A/B comparisons of kernel variants.

    python3 tools/flash_ab.py TREE LABEL

TREE is a directory holding `chip_smoke.py` and `paddle_tpu_torch/` (a
`git archive` of a commit, or a copy with a variant of csrc/); its
kernels are built from its own sources. Prints, per line tagged "AB
LABEL": K1 and K2 device ms (CUDA-graph replay, chip_smoke's `time_ms`)
and their max errors against the plain versions at GPT-2-small's
training shapes [8, 12, 1024, 64] and [32, 12, 256, 64] causal, then
chip_smoke's K1 serving cases. Compare two trees only within one call,
in turns: parent, change, change, parent. Needs a CUDA card.
"""

import importlib
import sys

import numpy as np
import torch


def main():
    tree, label = sys.argv[1], sys.argv[2]
    sys.path.insert(0, tree)
    cs = importlib.import_module("chip_smoke")   # the tree's own script
    fa = cs.fa
    cs._build.build_libraries(["flash_attn_fwd", "flash_attn_bwd"])
    rng = np.random.RandomState(0)
    scale = 1.0 / float(np.sqrt(cs.HEAD_DIM))
    for name, (B, T) in {"train": (cs.TRAIN_B, cs.TRAIN_T),
                         "short": (cs.SHORT_B, cs.SHORT_T)}.items():
        full = [T] * B
        sets = [cs.bwd_inputs(rng, B, T, T, full, True, scale)
                for _ in range(2)]
        lens = sets[0][6]
        starts = torch.zeros(B, dtype=torch.int32, device="cuda")
        fsets = [s[:3] for s in sets]
        o, lse = fa.flash_attn_fwd(*fsets[0], lens, starts, True, scale)
        o_ref, lse_ref = fa.flash_attn_fwd_plain(*fsets[0], lens, starts,
                                                 True, scale)
        e1 = max(float((o - o_ref).abs().max()),
                 float((lse - lse_ref).abs().max()))
        k1 = cs.time_ms(lambda q, k, v: fa.flash_attn_fwd(
            q, k, v, lens, starts, True, scale), fsets, reps=20)
        got = fa.flash_attn_bwd_fused(*sets[0], True, scale)
        ref = fa.flash_attn_bwd_fused_plain(*sets[0], True, scale)
        e2 = max(cs.rel_err(g, r) for g, r in zip(got, ref))
        e2a = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        k2 = cs.time_ms(lambda *a: fa.flash_attn_bwd_fused(
            *a, True, scale), sets, reps=10)
        print(f"AB {label} {name}: K1 {k1:.4f} ms err {e1:.2e} | K2 "
              f"{k2:.4f} ms err abs {e2a:.2e} rel {e2:.2e}", flush=True)
        del sets, fsets, got, ref
        torch.cuda.empty_cache()
    for case in cs.kernel_phase():
        print(f"AB {label} K1 {case['case']}: {case['ms']:.4f} ms err "
              f"{case['max_abs_err']:.2e}", flush=True)


if __name__ == "__main__":
    main()
