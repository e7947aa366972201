"""Deployment: full-video sliding-window inference and streaming serving."""

from spatialaudiogen_tpu_torch.deploy.deploy import MonoToAmbix
from spatialaudiogen_tpu_torch.deploy.stream import StreamBatcher, StreamingMonoToAmbix

__all__ = ["MonoToAmbix", "StreamBatcher", "StreamingMonoToAmbix"]
