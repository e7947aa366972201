"""Model interface protocol (port of spatialaudiogen_tpu.models.interface;
reference tflib/models/custom_models.py).

A model that the deploy, eval and training code can drive exposes its
configuration and a forward from the input audio (and frames) to the
ambisonics; models.sptaudiogen.SptAudioGen satisfies it.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable


@runtime_checkable
class GenerativeAudioModel(Protocol):
    cfg: object
    """Model configuration (geometry + architecture)."""

    def forward(self, audio, video=None, flow=None, *, train: bool = False, **kw):
        """audio (B, snd_size, n_in) [+ frames] -> (B, snd_dur, n_out)."""

    def no_decay_paths(self) -> tuple:
        """Parameter-name substrings excluded from the L2 weight decay."""
