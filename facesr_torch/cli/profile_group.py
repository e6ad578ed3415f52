"""Phase timeline inside one residual-group kernel call, on the card.

    python -m facesr_torch.cli.profile_group [--n 128] [--h 64] [--w 64]

A group call is one launch, so the profiler sees one kernel. This builds a
copy of ``facesr_torch/csrc/rcab_group.cu`` with ``clock64()`` marks at the
phase points of the resident variant (rank 0 of cluster 0, its first
image, RCAB k=1), runs one call (weights from a seed, 10 RCABs) and prints
the SM cycles from the start of that RCAB to each mark, three times. The
marks are inserted by text substitution; when the source moves on, a
missing anchor stops the tool with its text. The copy and its library go
to the gitignored ``facesr_torch/_build/profile_group/``.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import torch

from facesr_torch.ops import _build
from facesr_torch.ops import rcab_group as rg

MARK = "if (dbg != nullptr && tid == 0) dbg[nmark++] = clock64();"
R_MARK = "if (r.dbg != nullptr && r.tid == 0) r.dbg[r.nmark++] = clock64();"

# (anchor, text before it, text after it, how many anchors); marks in order
ANCHORS = [
    ("  uint32_t q;      // convs started: weight buffer q & 1\n",
     "", "  long long* dbg;\n  int nmark;\n", 1),
    ("    mbar_wait(bar_w0 + 8 * (q & 1), (q >> 1) & 1);\n", MARK + "\n", MARK + "\n", 1),
    ("        if (tid == 0) mbar_expect_tx(bar_h, halo_bytes);\n", MARK + "\n", "", 1),
    ("        fence_proxy_async_smem();  // before wgmma (the async proxy) reads them\n",
     "", MARK + "\n", 1),
    ("    wgmma_wait<0>();\n    fence_acc(d);\n", "", MARK + "\n", 1),
    ("    __syncthreads();  // this block's weight buffer and input rows are free\n"
     "    cluster_arrive_relaxed();\n", "", MARK + "\n", 1),
    ("    cluster_wait();\n"
     "    if (tid == 0 && next_w != nullptr) load_weight(next_w, next_row, q & 1);\n",
     MARK + "\n", MARK + "\n", 1),
    ("    ++q;\n", MARK + "\n", "", 1),
    ("        const GateWeights gw = load_gate_weights(p, k, r.tid);\n", R_MARK + "\n", "", 1),
    ("        se_gate(r.m, r.allsum(buf), p, gw, r.csize, r.tid);\n",
     R_MARK + "\n", R_MARK + "\n", 1),
    ("  r.q = 0;\n", "",
     "  long long* marks = reinterpret_cast<long long*>(p.feat);\n"
     "  r.dbg = nullptr;\n  r.nmark = 0;\n", 1),
    ("      // conv1 + PReLU: t1 goes straight into the next conv's input rows\n",
     "      r.dbg = marks != nullptr && cid == 0 && r.rank == 0 && img == cid && k == 1"
     " ? marks : nullptr;\n      r.nmark = 0;\n", "", 1),
]
CONV_MARKS = ["start", "weight ready", "own-row MMAs queued", "halo rows in", "MMAs done",
              "arrived"]
FINISH_MARKS = ["rows stored", "barrier passed", "edge rows pushed"]
NAMES = (["conv1 " + m for m in CONV_MARKS] + ["t1 " + m for m in FINISH_MARKS]
         + ["conv2 " + m for m in CONV_MARKS] + ["sums sent", "sums in", "gate"]
         + ["feat " + m for m in FINISH_MARKS])


def build_probe() -> ctypes.CDLL:
    src = (_build.CSRC / "rcab_group.cu").read_text()
    for anchor, before, after, count in ANCHORS:
        if src.count(anchor) != count:
            raise SystemExit(f"profile_group: anchor not found {count}x in rcab_group.cu:\n{anchor}")
        src = src.replace(anchor, before + anchor + after)
    out = _build.BUILD_DIR / "profile_group"
    out.mkdir(parents=True, exist_ok=True)
    (out / "rcab_group.cu").write_text(src)
    lib_path = out / "librcab_group_probe.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                          str(out / "rcab_group.cu")], capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"profile_group: nvcc failed\n{res.stdout}{res.stderr}")
    return ctypes.CDLL(str(lib_path))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--h", type=int, default=64)
    ap.add_argument("--w", type=int, default=64)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_group: needs a CUDA card", file=sys.stderr)
        return 1
    from facesr_torch.models import blocks

    lib = build_probe()
    _build._libs["rcab_group"] = lib  # the wrapper's library is the marked copy
    dev = torch.device("cuda")
    group = blocks.make_residual_groups(1, 10, 64, 3, 4, torch.Generator().manual_seed(4))[0]
    gw = {k: v.to(dev) for k, v in rg.prepare_group_weights(group).items()}
    x = torch.rand((args.n, args.h, args.w, 64), generator=torch.Generator().manual_seed(5))
    x = x.to(torch.bfloat16).to(dev)
    clusters, size, scratch = rg._plan(rg._lib(), args.n, args.h, args.w)
    if scratch:
        print("profile_group: this shape takes the scratch variant, which has no marks",
              file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"{card.strip()}; N={args.n} {args.h}x{args.w}, {clusters} cluster(s) of {size}; "
          "SM cycles from the start of RCAB k=1 (rank 0 of cluster 0, first image)")
    for rep in range(3):
        marks = torch.zeros(64, dtype=torch.int64, device=dev)
        out = torch.empty_like(x)
        err = lib.rcab_group_forward(
            x.data_ptr(), out.data_ptr(), *(gw[k].data_ptr() for k in rg._WEIGHT_SPECS),
            marks.data_ptr(), None, None, None, args.n, args.h, args.w, 10,
            gw["fc1"].shape[-1], 0.2, clusters, size, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if err != 0:
            raise SystemExit(f"profile_group: rcab_group_forward failed: cudaError_t {err}")
        v = marks.cpu().tolist()[:len(NAMES)]
        print(f"  run {rep}: " + ", ".join(f"{name} {t - v[0]}" for name, t in zip(NAMES, v)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
