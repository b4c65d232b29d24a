"""Find the largest ResNet-50 training batch that fits on the card.

    python3 tools/resnet_probe.py [B ...]      # default 1024 512 256 128

Builds bench.py's bench_resnet50 program in the port as chip_smoke.py
does (224 x 224, 1000 classes, in-graph uniform_random images and
labels, Momentum(0.1, 0.9), bf16 amp) and runs three steps at each
batch, largest first, until one fits. Prints, for each batch, either
the step walls and the peak memory or the out-of-memory error with the
peak allocated when it was raised, beside the card's name and power
limit. The batch chip_smoke.py trains at (RESNET_B) is the largest that
fits here.
"""

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
import paddle_tpu_torch as pt  # noqa: E402


def main():
    _, smi = cs.device_phase()
    batches = [int(b) for b in sys.argv[1:]] or [1024, 512, 256, 128]
    for B in batches:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        main_prog, startup, cost = cs.resnet_train_program(B, "random",
                                                           True)
        exe, scope = pt.Executor(), pt.Scope()
        exe.run(startup, scope=scope)
        walls = []
        try:
            for _ in range(3):
                t0 = time.perf_counter()
                loss, = exe.run(main_prog, fetch_list=[cost], scope=scope)
                walls.append(1e3 * (time.perf_counter() - t0))
        except torch.cuda.OutOfMemoryError as e:
            peak = torch.cuda.max_memory_allocated() / 2**30
            print(f"B {B}: out of memory after {len(walls)} steps, peak "
                  f"allocated {peak:.2f} GiB when raised: "
                  f"{str(e).splitlines()[0][:200]} | {smi}", flush=True)
            del scope, exe
            continue
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"B {B}: fits; step walls ms {[round(w, 1) for w in walls]} "
              f"(images/s {B / walls[-1] * 1e3:.0f} at the last), peak "
              f"{peak:.2f} GiB, loss {float(loss[0]):.4f} | {smi}",
              flush=True)
        return 0
    print(f"none of {batches} fits | {smi}")
    return 1


if __name__ == "__main__":
    sys.exit(main())
