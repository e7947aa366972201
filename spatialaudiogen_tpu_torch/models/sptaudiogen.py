"""SptAudioGen: mono + video -> first-order ambisonics (port of
spatialaudiogen_tpu.models.sptaudiogen).

Public layouts are the JAX package's: audio (B, snd_size, n_in), frames
(B, T, H, W, 3), output (B, snd_dur, n_out). Inside, tensors are NCHW with
H = time and W = frequency for the audio U-Net, so the U-Net's last deconv
already yields the mask track-major, (B, n_in*tracks, T, F), and the mask
crop is a strided view that the masked-ISTFT kernel reads in place. Fully
connected layers consume NHWC-flattened features, as the JAX model's do,
so the same weights line up. All crop indices come from
dsp.geometry.ModelGeometry.

`cfg.pallas_nhwc` (mono input) runs the separation U-Net channels_last
instead: its last deconv then yields the mask as
(B, T, F, tracks) in memory, and K3 reads that crop in place. `cfg.dtype`
(torch.bfloat16) runs the conv, deconv and FC products in bfloat16 with
float32 params; the STFT, the sigmoid, the masked ISTFT and the decode stay
float32, and the mask is stored bfloat16, as in the JAX model.

Tensor trace at defaults (audio+video, unet_mask, order 1, batch B):
  audio (B, 52799, 1) -> stft frames [46:173) -> mag (B, 1, 127, 1024)
  conv stack -> (B,32,31,127)(B,64,15,31)(B,128,7,14)(B,256,5,10)(B,512,3,6)
  video (B, 1, 224, 448, 3) -> ResNet18@conv5_2 -> (B, 512, 7, 14)
  bottleneck -> (B, 3, 1536); localization -> w (B,3,3,1,32), b (B,3,3,1)
  separation mask (B,1,32,28,1024); masked ISTFT -> (B,1,32,4800)
  decode: sum_{in,track} w*s + b -> (B, 4800, 3)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from spatialaudiogen_tpu_torch.config import (
    AUDIO,
    FLOW,
    NO_SEPARATION,
    VIDEO,
    SptAudioGenConfig,
)
from spatialaudiogen_tpu_torch.models.layers import (
    Conv2D,
    Deconv2D,
    Dense,
    at_least_float32,
    cast,
    init_weights,
)
from spatialaudiogen_tpu_torch.models.resnet import FILTERS, ResNet18
from spatialaudiogen_tpu_torch.ops.dft import precision_scope, stft_real
from spatialaudiogen_tpu_torch.ops.masked_istft import masked_istft, masked_istft_nhwc

# Audio U-Net architecture constants (model.py:162-164).
AUDIO_FILTERS = (32, 64, 128, 256, 512)
AUDIO_KERNELS = ((7, 16), (3, 7), (3, 5), (3, 5), (3, 5))
AUDIO_STRIDES = ((4, 8), (2, 4), (2, 2), (1, 1), (1, 1))


def _valid_out(n: int, k: int, s: int) -> int:
    return (n - k) // s + 1


def audio_feature_hw(cfg: SptAudioGenConfig) -> tuple[int, int]:
    """(time, freq) of the audio encoder's last activation."""
    g = cfg.geometry
    t, f = g.n_enc_frames, g.wind_size
    for k, s in zip(AUDIO_KERNELS, AUDIO_STRIDES):
        t, f = _valid_out(t, k[0], s[0]), _valid_out(f, k[1], s[1])
    return t, f


def visual_feature_hw(frame_hw) -> tuple[int, int]:
    """(h, w) of ResNet18@conv5_2 features: five "SAME" stride-2 stages."""
    h, w = frame_hw
    for _ in range(5):
        h, w = -(-h // 2), -(-w // 2)
    return h, w


class AudioEncoder(nn.Module):
    """5-layer VALID conv stack over |STFT| (model.py:161-187)."""

    def __init__(self, n_in: int, dtype=None):
        super().__init__()
        chans = (n_in,) + AUDIO_FILTERS
        for i, (k, s) in enumerate(zip(AUDIO_KERNELS, AUDIO_STRIDES)):
            self.add_module(f"conv{i + 1}", Conv2D(chans[i], chans[i + 1], k, s,
                                                   activation=F.relu, dtype=dtype))

    def forward(self, mag):
        acts = [mag]
        for conv in self.children():
            acts.append(conv(acts[-1]))
        return acts


class Bottleneck(nn.Module):
    """Per-modality FC reduction + fusion concat (model.py:203-239); each
    visual frame's 512-d embedding is repeated over the audio steps it
    covers."""

    def __init__(self, cfg: SptAudioGenConfig, frame_hw):
        super().__init__()
        self.visual = [k for k in (VIDEO, FLOW) if k in cfg.encoders]
        self.vid_t = cfg.geometry.vid_dur
        t, f = audio_feature_hw(cfg)
        d = cfg.dtype
        self.add_module(f"{AUDIO}-fc", Dense(f * AUDIO_FILTERS[-1], 1024, F.relu, dtype=d))
        h, w = visual_feature_hw(frame_hw)
        for k in self.visual:
            self.add_module(f"{k}-fc-red", Dense(FILTERS[-1], 128, F.relu, dtype=d))
            self.add_module(f"{k}-fc", Dense(self.vid_t * h * w * 128, 512, F.relu, dtype=d))
        self.out_features = 1024 + 512 * len(self.visual)

    def forward(self, enc: dict):
        audio = enc[AUDIO]                                   # (B, 512, t, f)
        b, _, audio_t, _ = audio.shape
        x = audio.permute(0, 2, 3, 1).reshape(b, audio_t, -1)   # NHWC flatten
        parts = [getattr(self, f"{AUDIO}-fc")(x)]
        for k in self.visual:
            y = enc[k].permute(0, 2, 3, 1)                   # (B*vid_t, h, w, 512)
            y = getattr(self, f"{k}-fc-red")(y)
            y = y.reshape(y.shape[0] // self.vid_t, self.vid_t, -1)
            y = getattr(self, f"{k}-fc")(y)
            assert audio_t % self.vid_t == 0, (audio_t, self.vid_t)
            parts.append(y.repeat_interleave(audio_t // self.vid_t, dim=1))
        return torch.cat(parts, dim=2)


class LocalizationHead(nn.Module):
    """FC stack -> per-video-frame synthesis weights (model.py:241-271)."""

    def __init__(self, cfg: SptAudioGenConfig, in_features: int):
        super().__init__()
        g = cfg.geometry
        self.shape = (g.num_out_channels, g.num_in_channels, cfg.num_tracks + 1)
        units = (in_features,) + tuple(cfg.loc_fc_units)
        for i in range(len(cfg.loc_fc_units)):
            self.add_module(f"fc{i + 1}", Dense(units[i], units[i + 1], F.relu,
                                                dtype=cfg.dtype))
        self.output_layer = f"fc{len(cfg.loc_fc_units) + 1}"
        n_out = self.shape[0] * self.shape[1] * self.shape[2]
        self.add_module(self.output_layer, Dense(units[-1], n_out, dtype=cfg.dtype))

    def forward(self, x):
        for layer in self.children():
            x = layer(x)
        x = x.reshape(x.shape[:2] + self.shape)
        return x[..., :-1], x[..., -1]   # weights (B,T,out,in,tr), biases (B,T,out,in)


class SeparationUNet(nn.Module):
    """Deconv mirror of the audio encoder -> per-track sigmoid STFT mask ->
    masked comb ISTFT (model.py:282-348)."""

    def __init__(self, cfg: SptAudioGenConfig, in_features: int):
        super().__init__()
        self.cfg = cfg
        g = cfg.geometry
        # the JAX model's NHWC-mask branch (sptaudiogen.py:276-287)
        self.nhwc = cfg.pallas_nhwc and g.num_in_channels == 1
        self.add_module("fc-feats", Dense(in_features, AUDIO_FILTERS[-1], F.relu,
                                          dtype=cfg.dtype))
        out_filters = (cfg.sep_num_tracks * g.num_in_channels,) + AUDIO_FILTERS[:-1]
        for layer in range(len(AUDIO_FILTERS)):
            # input = relu(previous deconv) ++ the encoder activation of that size
            self.add_module(f"deconv{layer + 1}", Deconv2D(
                2 * AUDIO_FILTERS[layer], out_filters[layer], AUDIO_KERNELS[layer],
                AUDIO_STRIDES[layer], dtype=cfg.dtype))

    def forward(self, feats, audio_acts, stft_re, stft_im, taps=None):
        cfg, g = self.cfg, self.cfg.geometry
        x = getattr(self, "fc-feats")(feats)                 # (B, t, 512)
        enc = audio_acts[-1]                                 # (B, 512, t, f)
        # audio features first, then the fused features tiled over frequency
        x = x.transpose(1, 2)[..., None].expand(-1, -1, -1, enc.shape[3])
        x = torch.cat([enc, x], dim=1)
        if self.nhwc:
            # channels_last from here on, so every deconv, deconv1's mask
            # included, is laid out (B, H, W, C) in memory
            x = x.contiguous(memory_format=torch.channels_last)
            audio_acts = [a.contiguous(memory_format=torch.channels_last)
                          for a in audio_acts]
        for layer in reversed(range(len(AUDIO_FILTERS))):
            if layer == 0:
                # only deconv1 frames [deconv_ss, deconv_tt) survive the mask
                # crop; compute it on the contributing input slice (exact)
                x = x[:, :, g.deconv1_in_lo: g.deconv1_in_hi]
            x = getattr(self, f"deconv{layer + 1}")(x)
            if layer == 0:
                break
            x = torch.cat([F.relu(x), audio_acts[layer]], dim=1)

        # sigmoid in float32, the mask stored in the compute dtype
        # (sptaudiogen.py:262-263); the frame crop is a view
        x = at_least_float32(x)
        mask = torch.sigmoid(x).to(cfg.dtype or x.dtype)[
            :, :, g.narrowed_deconv_ss: g.narrowed_deconv_ss + g.n_mask_frames]
        # (B, n_in*tracks, T, F) -> (B, n_in, tracks, T, F): channel =
        # in*tracks + track, as the JAX model's reshape
        if taps is not None:
            taps["mask"] = mask.unflatten(1, (g.num_in_channels, cfg.sep_num_tracks))
        if self.nhwc:
            # K3 reads the (B, T, F, tracks) view of the channels_last mask
            x_sep = masked_istft_nhwc(stft_re[:, 0], stft_im[:, 0], mask.permute(0, 2, 3, 1),
                                      4, cfg.pallas_precision)
            return x_sep[:, None, :, g.out_ss: g.out_tt]      # (B, 1, tracks, snd_dur)
        mask = mask.unflatten(1, (g.num_in_channels, cfg.sep_num_tracks))
        # CUDA tensors go through the fused kernels (K1 forward, K2
        # backward), CPU tensors through the plain version (the counterpart
        # of _pallas_enabled's "auto")
        x_sep = masked_istft(stft_re, stft_im, mask, 4, cfg.pallas_precision)
        return x_sep[..., g.out_ss: g.out_tt]                # (B, n_in, tracks, snd_dur)


class SptAudioGen(nn.Module):
    """Full model: forward(audio, video, flow) -> (B, snd_dur, n_out)."""

    def __init__(self, cfg: SptAudioGenConfig, frame_hw=(224, 448)):
        super().__init__()
        self.cfg = cfg
        assert AUDIO in cfg.encoders, (
            "the bottleneck aligns visual features to the audio time axis, "
            "so the audio encoder is required (as in the JAX model)")
        g = cfg.geometry
        self.audio_encoder = AudioEncoder(g.num_in_channels, cfg.dtype)
        for name in (VIDEO, FLOW):
            if name in cfg.encoders:
                self.add_module(f"{name}_encoder", ResNet18(dtype=cfg.dtype))
        self.bottleneck = Bottleneck(cfg, frame_hw)
        feat = self.bottleneck.out_features
        self.localization = LocalizationHead(cfg, feat)
        if cfg.separation != NO_SEPARATION:
            self.separation = SeparationUNet(cfg, feat)

    def init_weights(self, generator: torch.Generator) -> "SptAudioGen":
        """Random weights with the reference's initialisers, from `generator`."""
        return init_weights(self, generator,
                            small_init=(f"localization.{self.localization.output_layer}",))

    def forward(self, audio, video=None, flow=None, taps: dict | None = None,
                train: bool = False):
        """audio (B, snd_size, n_in), frames (B, T, H, W, 3) -> (B, snd_dur, n_out).

        `train=True` is the train step's forward: the visual encoders' BNs
        run on batch statistics and update their running averages, as the
        JAX model's apply(..., train=True, mutable=["batch_stats"]) does.
        Pass a dict as `taps` to receive the |STFT| (NHWC, as the JAX
        model's `stft_mag`) and the separation `mask`.

        `cfg.dft_precision` holds inside the call (ops.dft.precision_scope):
        "highest" turns TF32 off for matmuls and cuDNN convolutions, so every
        float32 product is a full float32 product (PyTorch's default allows
        TF32 in convolutions, about three decimal digits); "default" allows
        TF32 in both. A backward runs under its forward's setting only inside
        a scope of its own (train.steps.train_step)."""
        with precision_scope(self.cfg.dft_precision):
            return self._forward(audio, video, flow, taps, train)

    def _forward(self, audio, video, flow, taps, train):
        cfg, g = self.cfg, self.cfg.geometry
        assert audio.shape[1] == g.snd_size, (audio.shape, g.snd_size)
        mono = audio.transpose(1, 2)                         # (B, n_in, snd_size)
        # STFT only over the frames the network touches ([enc_ss, enc_tt))
        re, im = stft_real(mono, g.wind_size, 4, g.enc_ss, g.n_enc_frames)

        mag = torch.sqrt(re * re + im * im)                  # (B, n_in, T_enc, F)
        if taps is not None:
            taps["stft_mag"] = mag.permute(0, 2, 3, 1)
        enc = {AUDIO: self.audio_encoder(cast(mag, cfg.dtype))}
        for name, frames in ((VIDEO, video), (FLOW, flow)):
            if name in cfg.encoders:
                assert frames is not None, f"{name} encoder requires {name} input"
                x = cast(frames.flatten(0, 1).permute(0, 3, 1, 2), cfg.dtype).contiguous()
                enc[name] = getattr(self, f"{name}_encoder")(
                    x, train or cfg.bn_batch_stats, train)
        feats = self.bottleneck({k: (v[-1] if k == AUDIO else v)
                                 for k, v in enc.items()})
        weights, biases = self.localization(feats)

        if cfg.separation == NO_SEPARATION:
            x_sep = mono[:, :, None, g.nosep_ss: g.nosep_ss + g.snd_dur]
        else:
            # the mask frames are a sub-range of the encoder frame range
            lo, hi = g.mask_ss - g.enc_ss, g.mask_tt - g.enc_ss
            x_sep = self.separation(feats, enc[AUDIO], re[:, :, lo:hi],
                                    im[:, :, lo:hi], taps)

        # decode, in the separated tracks' float dtype: A_t = sum_tracks
        # sum_in W_t * s_t + b_t (model.py:430), applied blockwise: each
        # video-rate coefficient covers snd_dur/T consecutive audio samples
        b, t_coef = weights.shape[:2]
        s = x_sep.unflatten(3, (t_coef, g.snd_dur // t_coef))   # (B, in, tr, T, reps)
        ambi = torch.einsum("btoik,biktr->btro", weights.to(s.dtype), s)
        ambi = ambi + biases[..., 0].to(s.dtype)[:, :, None]
        return ambi.reshape(b, g.snd_dur, g.num_out_channels)

    def no_decay_paths(self) -> tuple:
        """Parameter-name substrings excluded from L2 weight decay (the
        localization output layer, model.py:253-256)."""
        return (f"localization.{self.localization.output_layer}",)
