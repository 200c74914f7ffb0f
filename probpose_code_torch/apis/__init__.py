"""Inference entry points."""

from .inference import crop_batch, inference_topdown, init_model  # noqa: F401
