"""The train step's memory budget per rank (port of `memory_report` and
`format_memory_report` of `facesr/utils/profiling.py`).

The JAX package reports XLA's buffer assignment of the compiled step
without running it. Eager PyTorch has no such plan, so the port reports
what it can count and, on a card, what it measures:

- the state's bytes, by part (the parameters and buffers, the optimiser
  state, the EMA, the discriminator and its optimiser state) that this
  rank holds: a full replica, under tp its slices, under pp its stage's
  residual groups and the replicated rest (the other stages' leaves are
  empty tensors, counted as 0);
- the batch's bytes (this rank's rows);
- on CUDA, the peak of one step: ``torch.cuda.max_memory_allocated``
  after ``reset_peak_memory_stats``, around a step that really runs once
  (`Trainer.memory_report` restores the state afterwards). On the CPU the
  peak is not measured.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

__all__ = ["tensor_bytes", "memory_report", "format_memory_report"]


def tensor_bytes(tree: Any) -> int:
    """The bytes of every tensor in a tensor / dict / list / module tree."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, torch.nn.Module):
        return sum(tensor_bytes(t) for t in list(tree.parameters()) + list(tree.buffers()))
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(v) for v in tree)
    return 0


def memory_report(state_parts: Dict[str, Any], batch: torch.Tensor,
                  run_step: Optional[Callable[[], None]] = None,
                  rank: int = 0, world_size: int = 1) -> Dict[str, Any]:
    """Bytes of each named part of the state and of ``batch``; with
    ``run_step`` on a CUDA batch, the measured peak of one call of it
    (``peak_step_bytes``, else None)."""
    report: Dict[str, Any] = {f"{k}_bytes": tensor_bytes(v) for k, v in state_parts.items()}
    report["state_bytes"] = sum(report.values())
    report["batch_bytes"] = tensor_bytes(batch)
    report["peak_step_bytes"] = None
    report["rank"], report["world_size"] = rank, world_size
    if run_step is not None and batch.device.type == "cuda":
        torch.cuda.synchronize(batch.device)
        torch.cuda.reset_peak_memory_stats(batch.device)
        run_step()
        torch.cuda.synchronize(batch.device)
        report["peak_step_bytes"] = torch.cuda.max_memory_allocated(batch.device)
    return report


def format_memory_report(report: Dict[str, Any], label: str = "step") -> str:
    mb = lambda b: f"{b / (1 << 20):10.1f} MB ({b} bytes)"
    parts = [k[:-len("_bytes")] for k in report
             if k.endswith("_bytes") and k not in ("state_bytes", "batch_bytes",
                                                   "peak_step_bytes")]
    lines = [f"[{label}] rank {report['rank']} of {report['world_size']}, device memory "
             "(this rank's state: a full replica, or under tp and pp its part):"]
    lines += [f"  {p:<14}{mb(report[p + '_bytes'])}" for p in parts]
    lines.append(f"  {'state':<14}{mb(report['state_bytes'])}  (the parts above)")
    lines.append(f"  {'batch':<14}{mb(report['batch_bytes'])}  (this rank's rows)")
    peak = report["peak_step_bytes"]
    lines.append(f"  {'step peak':<14}"
                 + (f"{mb(peak)}  (max_memory_allocated over one step, run once)"
                    if peak is not None else "    not measured (CPU)"))
    return "\n".join(lines)
