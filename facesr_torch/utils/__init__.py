"""Utilities of the port: the train step's memory report."""

from facesr_torch.utils.profiling import format_memory_report, memory_report

__all__ = ["memory_report", "format_memory_report"]
