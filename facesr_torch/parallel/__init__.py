"""Serving of the port (one card)."""

from facesr_torch.parallel.serving import MicroBatcher, Predictor, build_serving_fn

__all__ = ["MicroBatcher", "Predictor", "build_serving_fn"]
