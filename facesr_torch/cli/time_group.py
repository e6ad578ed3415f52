"""Time one residual-group kernel call at a few batch shapes, on the card.

    python -m facesr_torch.cli.time_group [--shape N H W ...]

For each shape (a group of 10 RCABs, weights from a seed, uniform bf16
input) it prints one JSON line: the launch the plan picks, the mean device
time of a call (CUDA events, the median of 3 means of 5 calls), the memory
one call adds at its peak (the output and the scratch variant's buffers)
and how far the output is from `rcab_group_reference` beyond the kernel
tolerance (2e-2 + 2^-7 * |ref|; at most 0 is within). It uses only
`fused_residual_group`, `_plan` and `prepare_group_weights`, so the same
file times an older checkout of the package when copied into it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import torch

from facesr_torch.models import blocks
from facesr_torch.ops import rcab_group as rg

# a large batch at SpatialPredictor's 256x256 and one of small images
# past one 64-pixel tile: both more images than the scratch variant keeps
# in flight
SHAPES = ((128, 256, 256), (80, 40, 80))
BLOCKS, ITERS, REPS = 10, 5, 3


def mean_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_shape(n: int, h: int, w: int) -> dict:
    dev = torch.device("cuda")
    group = blocks.make_residual_groups(1, BLOCKS, 64, 3, 4,
                                        torch.Generator().manual_seed(4))[0]
    gw = {k: v.to(dev) for k, v in rg.prepare_group_weights(group).items()}
    x = torch.rand((n, h, w, 64), generator=torch.Generator().manual_seed(5))
    x = x.to(torch.bfloat16).to(dev)
    with torch.inference_mode():
        want = rg.rcab_group_reference(x, gw, 0.2).float()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got = rg.fused_residual_group(x, gw, 0.2)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        excess = ((got.float() - want).abs() - (2e-2 + 2.0 ** -7 * want.abs())).max().item()
        del got, want
        ms = [mean_ms(lambda: rg.fused_residual_group(x, gw, 0.2), ITERS) for _ in range(REPS)]
    return {"shape": [n, h, w, 64], "blocks": BLOCKS,
            "plan": list(rg._plan(rg._lib(), n, h, w)), "ms": statistics.median(ms),
            "ms_each": ms, "peak_call_bytes": peak, "excess_over_tolerance": excess}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", type=int, nargs=3, action="append", metavar=("N", "H", "W"),
                    help="a batch shape (repeatable); default: " + ", ".join(
                        "x".join(map(str, s)) for s in SHAPES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_group: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    for n, h, w in args.shape or SHAPES:
        print(json.dumps(time_shape(n, h, w)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
