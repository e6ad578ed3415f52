"""Phase timeline inside one residual-group kernel call, on the card.

    python -m facesr_torch.cli.profile_group [--n 128] [--h 64] [--w 64]
    python -m facesr_torch.cli.profile_group --n 1 --h 256 --w 256

A group call is one launch, so the profiler sees one kernel. This builds a
copy of ``facesr_torch/csrc/rcab_group.cu`` with ``clock64()`` marks at the
phase points of the variant the shape takes, runs one call (weights from a
seed, 10 RCABs) and prints the SM cycles of RCAB k=1, three times:

* resident: rank 0 of cluster 0, its first image; cycles from the start
  of that RCAB to each mark;
* scratch: every block of the first image, thread 0; cycles of each
  phase (conv MMAs, the waits for input units, the epilogues, the
  image-wide barrier waits, the SE mean and gate, the residual update),
  the MMA and unit-wait shares summed over the conv's units (warpgroup
  0's tiles): block 0's, then the minimum, median and maximum over the
  image's blocks. A barrier's shortest wait is the last block's, so it is
  the barrier's own cost; the longer ones wait for the slowest block.

The marks are inserted by text substitution; when the source moves on, a
missing anchor stops the tool with its text. The copy and its library go
to the gitignored ``facesr_torch/_build/profile_group/``.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
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
# the scratch variant: timestamps into dbg[0..], conv durations into dbg[48..]
S_MARK = "if (b.dbg != nullptr && b.tid == 0) b.dbg[b.nmark++] = clock64();"
S_ANCHORS = [
    ("  uint32_t q;   // convs started so far (weight barrier parity q & 1)\n",
     "", "  long long* dbg;\n  int nmark, nsum;\n  long long t_wait, t_mma;\n", 1),
    ("namespace {\n", "", "__device__ long long* g_marks;\n", 1),
    ("  b.q = 0;\n", "", "  b.dbg = nullptr;\n  b.nmark = b.nsum = 0;\n", 1),
    ("  mbar_wait(b.bar_w, b.q & 1);\n", S_MARK + "\n  b.t_wait = b.t_mma = 0;\n",
     S_MARK + "\n", 1),
    ("    mbar_wait(b.bar_s(b.it), (b.it >> 1) & 1);\n", "    long long tw = clock64();\n",
     "    b.t_wait += clock64() - tw;\n", 1),
    ("      conv_tile(acc, rows, l0, b.wsm, b.wq, b.lane);\n", "      long long tm = clock64();\n",
     "      b.t_mma += clock64() - tm;\n", 1),
    ("  __syncthreads();  // every MMA of this conv is done with the weight buffer\n",
     S_MARK + "\n  if (b.dbg != nullptr && b.tid == 0) {\n"
     "    b.dbg[48 + b.nsum++] = b.t_wait;\n    b.dbg[48 + b.nsum++] = b.t_mma;\n  }\n", "", 1),
    ("  fence_proxy_async();  // t1 / out writes before other blocks' TMA reads\n", "",
     S_MARK + "\n", 1),
    ("      conv_phase<PRELU_T1>(b, p, k == 0 ? &tm_x : &tm_featb",
     "      b.dbg = g_marks != nullptr && slot == 0 && img == slot && k == 1"
     " ? g_marks + 64 * b.bi : nullptr;\n      b.nmark = b.nsum = 0;\n", "", 1),
    ("      b.image_barrier();  // every block's t1 units are written\n", "", S_MARK + "\n", 1),
    ("      b.image_barrier();  // every block's channel sums are written\n",
     S_MARK + "\n", S_MARK + "\n", 1),
    ("      gate_from_mean(b.m, p, gw, b.tid);\n", "", S_MARK + "\n", 1),
    ("      fence_proxy_async();\n      b.image_barrier();  // every block's bf16(feat) units are written\n",
     S_MARK + "\n", S_MARK + "\n", 1),
    ("extern \"C\" int rcab_group_barrier_bytes()",
     "extern \"C\" int rcab_group_set_marks(void* marks) {\n"
     "  return int(cudaMemcpyToSymbol(g_marks, &marks, sizeof(marks)));\n}\n\n", "", 1),
]
S_CONV = ["start", "weight ready", "units done", "stored"]
S_NAMES = (["conv1 " + m for m in S_CONV] + ["t1 barrier passed"]
           + ["conv2 " + m for m in S_CONV] + ["sums barrier arrive", "sums barrier passed",
                                               "gate", "update done", "feat barrier passed"])
# phases of the scratch variant's RCAB: (name, first mark, last mark)
S_PHASES = [("conv1 weight wait", "conv1 start", "conv1 weight ready"),
            ("conv1 units", "conv1 weight ready", "conv1 units done"),
            ("conv1 tail", "conv1 units done", "conv1 stored"),
            ("t1 barrier", "conv1 stored", "t1 barrier passed"),
            ("conv2 weight wait", "conv2 start", "conv2 weight ready"),
            ("conv2 units", "conv2 weight ready", "conv2 units done"),
            ("conv2 sums", "conv2 units done", "conv2 stored"),
            ("gate weights", "conv2 stored", "sums barrier arrive"),
            ("sums barrier", "sums barrier arrive", "sums barrier passed"),
            ("SE mean + gate", "sums barrier passed", "gate"),
            ("update", "gate", "update done"),
            ("feat barrier", "update done", "feat barrier passed")]

CONV_MARKS = ["start", "weight ready", "own-row MMAs queued", "halo rows in", "MMAs done",
              "arrived"]
FINISH_MARKS = ["rows stored", "barrier passed", "edge rows pushed"]
NAMES = (["conv1 " + m for m in CONV_MARKS] + ["t1 " + m for m in FINISH_MARKS]
         + ["conv2 " + m for m in CONV_MARKS] + ["sums sent", "sums in", "gate"]
         + ["feat " + m for m in FINISH_MARKS])


def build_probe() -> ctypes.CDLL:
    src = (_build.CSRC / "rcab_group.cu").read_text()
    for anchor, before, after, count in ANCHORS + S_ANCHORS:
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


def profile_scratch(lib, card, x, gw, clusters, size, per_image) -> int:
    """The scratch variant's phases of RCAB k=1 in every block of the first
    image, through the wrapper (which launches the marked copy), the marks'
    buffer set by the copy's extra entry."""
    lib.rcab_group_set_marks.argtypes = [ctypes.c_void_p]
    lib.rcab_group_set_marks.restype = ctypes.c_int
    n, h, w, _ = x.shape
    blocks = per_image * size
    print(f"{card}; N={n} {h}x{w}, {clusters} cluster(s) of {size}, {per_image} an image, "
          f"{clusters * size} SMs; SM cycles of RCAB k=1 in the first image's {blocks} blocks "
          "(thread 0): block 0, then min / median / max over the blocks")
    names = [name for name, _, _ in S_PHASES] + ["conv1 unit waits", "conv1 MMAs",
                                                 "conv2 unit waits", "conv2 MMAs", "RCAB"]
    for rep in range(3):
        marks = torch.zeros(64 * blocks, dtype=torch.int64, device=x.device)
        err = lib.rcab_group_set_marks(marks.data_ptr())
        if err != 0:
            raise SystemExit(f"profile_group: rcab_group_set_marks failed: cudaError_t {err}")
        rg.fused_residual_group(x, gw, 0.2)
        torch.cuda.synchronize()
        rows = []
        for v in marks.view(blocks, 64).cpu().tolist():
            at = dict(zip(S_NAMES, v[:len(S_NAMES)]))
            rows.append([at[b] - at[a] for _, a, b in S_PHASES] + v[48:52]
                        + [at["feat barrier passed"] - at["conv1 start"]])
        cols = list(zip(*rows))
        print(f"  run {rep}: " + "; ".join(
            f"{name} {col[0]} ({min(col)} / {statistics.median(col):.0f} / {max(col)})"
            for name, col in zip(names, cols)))
    lib.rcab_group_set_marks(None)
    return 0


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
    clusters, size, scratch, per_image = rg._plan(rg._lib(), args.n, args.h, args.w)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    if scratch:
        return profile_scratch(lib, card.strip(), x, gw, clusters, size, per_image)
    print(f"{card.strip()}; N={args.n} {args.h}x{args.w}, {clusters} cluster(s) of {size}; "
          "SM cycles from the start of RCAB k=1 (rank 0 of cluster 0, first image)")
    for rep in range(3):
        marks = torch.zeros(64, dtype=torch.int64, device=dev)
        out = torch.empty_like(x)
        err = lib.rcab_group_forward(
            x.data_ptr(), out.data_ptr(), *(gw[k].data_ptr() for k in rg._WEIGHT_SPECS),
            marks.data_ptr(), None, None, None, None, None, args.n, args.h, args.w, 10,
            gw["fc1"].shape[-1], 0.2, clusters, size, per_image,
            torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if err != 0:
            raise SystemExit(f"profile_group: rcab_group_forward failed: cudaError_t {err}")
        v = marks.cpu().tolist()[:len(NAMES)]
        print(f"  run {rep}: " + ", ".join(f"{name} {t - v[0]}" for name, t in zip(NAMES, v)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
