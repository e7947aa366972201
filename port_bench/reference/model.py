"""The SptAudioGen forward pass in plain PyTorch, as a function of a dict
of named tensors (Morgado et al., NeurIPS 2018, "Self-Supervised
Generation of Spatial Audio for 360 Video"; the reference code's
model.py:161-430).

Layouts: audio (B, snd_size, 1) mono, frames (B, vid_dur, H, W, 3), output
(B, snd_dur, 3) Y/Z/X. Inside, NCHW with H = time and W = frequency for
the audio path. Parameter names are the keys the benchmark hands to both
sides (`param_spec`).

`Precision` says how each product is computed: `compute` is the dtype of
the conv, deconv and fully connected products (None: float32, as the
inputs), `round_to` an optional narrower type every operand of those
products is rounded through in the forward pass, `tf32` whether their float32 operands are
rounded to TF32 (10 mantissa bits, to nearest, as the tensor cores read
them; the reference never lets the libraries use TF32 themselves), and
`istft_bf16` whether the masked ISTFT's two GEMM operands are rounded
to bfloat16 (the route the configuration declares for that product).
BatchNorm statistics, the sigmoid, the DFTs and the decode stay float32.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference.geometry import Geometry

AUDIO_FILTERS = (32, 64, 128, 256, 512)
AUDIO_KERNELS = ((7, 16), (3, 7), (3, 5), (3, 5), (3, 5))
AUDIO_STRIDES = ((4, 8), (2, 4), (2, 2), (1, 1), (1, 1))
RESNET_FILTERS = (64, 64, 128, 256, 512)
BN_EPS, BN_MOMENTUM = 1e-3, 0.99
VISUAL = ("video", "flow")


@dataclasses.dataclass(frozen=True)
class Precision:
    compute: torch.dtype | None = None
    round_to: torch.dtype | None = None
    tf32: bool = False
    istft_bf16: bool = True


@dataclasses.dataclass(frozen=True)
class ModelShape:
    encoders: tuple = ("audio", "video")
    tracks: int = 32
    frame_hw: tuple = (224, 448)
    loc_units: tuple = (512, 512)
    geometry: Geometry = Geometry()

    @property
    def visual(self) -> tuple:
        return tuple(k for k in VISUAL if k in self.encoders)


def _valid(n: int, k: int, s: int) -> int:
    return (n - k) // s + 1


def audio_feature_hw(m: ModelShape) -> tuple[int, int]:
    t, f = m.geometry.n_enc, m.geometry.wind
    for k, s in zip(AUDIO_KERNELS, AUDIO_STRIDES):
        t, f = _valid(t, k[0], s[0]), _valid(f, k[1], s[1])
    return t, f


def visual_feature_hw(m: ModelShape) -> tuple[int, int]:
    h, w = m.frame_hw
    for _ in range(5):
        h, w = -(-h // 2), -(-w // 2)
    return h, w


def _resnet_spec(prefix: str) -> list:
    spec = [(f"{prefix}.conv1", "conv_bn", (64, 3, 7, 7))]
    for i, stage in enumerate(("conv2", "conv3", "conv4", "conv5")):
        c_in, c = RESNET_FILTERS[i], RESNET_FILTERS[i + 1]
        for j in (1, 2):
            name = f"{prefix}.{stage}_{j}"
            first = j == 1 and stage != "conv2"
            if first:
                spec.append((f"{name}.shortcut", "conv_nobias", (c, c_in, 1, 1)))
            spec.append((f"{name}.conv_1", "conv_bn", (c, c_in if first else c, 3, 3)))
            spec.append((f"{name}.conv_2", "conv_bn", (c, c, 3, 3)))
    return spec


def layer_spec(m: ModelShape) -> list:
    """[(layer name, kind, weight shape)] in a fixed order."""
    spec = []
    chans = (1,) + AUDIO_FILTERS
    for i, k in enumerate(AUDIO_KERNELS):
        spec.append((f"audio_encoder.conv{i + 1}", "conv", (chans[i + 1], chans[i]) + k))
    for enc in m.visual:
        spec += _resnet_spec(f"{enc}_encoder")
    _, f = audio_feature_hw(m)
    spec.append(("bottleneck.audio-fc", "dense", (1024, f * AUDIO_FILTERS[-1])))
    h, w = visual_feature_hw(m)
    for enc in m.visual:
        spec.append((f"bottleneck.{enc}-fc-red", "dense", (128, RESNET_FILTERS[-1])))
        spec.append((f"bottleneck.{enc}-fc", "dense", (512, m.geometry.vid_dur * h * w * 128)))
    feat = 1024 + 512 * len(m.visual)
    units = (feat,) + tuple(m.loc_units)
    for i in range(len(m.loc_units)):
        spec.append((f"localization.fc{i + 1}", "dense", (units[i + 1], units[i])))
    spec.append((f"localization.fc{len(m.loc_units) + 1}", "dense_small",
                 (3 * 1 * (m.tracks + 1), units[-1])))
    spec.append(("separation.fc-feats", "dense", (AUDIO_FILTERS[-1], feat)))
    outs = (m.tracks,) + AUDIO_FILTERS[:-1]
    for i, k in enumerate(AUDIO_KERNELS):
        spec.append((f"separation.deconv{i + 1}", "deconv", (2 * AUDIO_FILTERS[i], outs[i]) + k))
    return spec


def param_spec(m: ModelShape) -> list:
    """[(tensor name, shape, role)] of every parameter and BN buffer. Roles:
    kernel, bias, small_kernel, bn_scale, bn_bias, bn_mean, bn_var."""
    out = []
    for name, kind, shape in layer_spec(m):
        if kind.startswith("dense"):
            out.append((f"{name}.dense.weight", shape,
                        "small_kernel" if kind == "dense_small" else "kernel"))
            out.append((f"{name}.dense.bias", shape[:1], "bias"))
        elif kind == "deconv":
            out.append((f"{name}.deconv.weight", shape, "kernel"))
            out.append((f"{name}.deconv.bias", shape[1:2], "bias"))
        else:
            out.append((f"{name}.conv.weight", shape, "kernel"))
            if kind == "conv":
                out.append((f"{name}.conv.bias", shape[:1], "bias"))
            elif kind == "conv_bn":
                for role in ("scale", "bias", "mean", "var"):
                    out.append((f"{name}.bn.{role}", shape[:1], f"bn_{role}"))
    return out


def fan_in_out(shape: tuple) -> tuple[int, int]:
    """Glorot fans of a kernel: conv (out, in, kh, kw), deconv (in, out, kh,
    kw) read as the JAX layout's (kh, kw, in, out), dense (out, in)."""
    if len(shape) == 2:
        return shape[1], shape[0]
    rf = shape[2] * shape[3]
    return shape[1] * rf, shape[0] * rf


# ---------------------------------------------------------------------------
# layers


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (to nearest, ties away from zero),
    the gradient passed straight through."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach()


def _operand(x: torch.Tensor, p: Precision) -> torch.Tensor:
    if p.compute is not None:
        x = x.to(p.compute)
    if p.round_to is not None:
        x = x + (x.detach().to(p.round_to).to(x.dtype) - x.detach())
    if p.tf32 and x.dtype == torch.float32:
        x = tf32_round(x)
    return x


def _same_pad(size: int, k: int, s: int) -> tuple[int, int]:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv(x, w, b, stride, same: bool, p: Precision):
    if same:
        (h0, h1), (w0, w1) = (_same_pad(x.shape[2], w.shape[2], stride),
                              _same_pad(x.shape[3], w.shape[3], stride))
        x = F.pad(x, (w0, w1, h0, h1))
    return F.conv2d(_operand(x, p), _operand(w, p),
                    None if b is None else _operand(b, p), stride)


def deconv(x, w, b, stride, p: Precision):
    return F.conv_transpose2d(_operand(x, p), _operand(w, p), _operand(b, p), stride)


def dense(x, w, b, p: Precision):
    return F.linear(_operand(x, p), _operand(w, p), _operand(b, p))


def batch_norm(x, params: dict, name: str, new_stats: dict | None):
    """Batch statistics, biased variance, eps 1e-3, in float32; with
    `new_stats` the moved running averages go there (momentum 0.99)."""
    xf = x.float()
    mean = xf.mean(dim=(0, 2, 3))
    var = ((xf - mean[None, :, None, None]) ** 2).mean(dim=(0, 2, 3))
    if new_stats is not None:
        for key, batch in (("mean", mean), ("var", var)):
            old = params[f"{name}.bn.{key}"]
            new_stats[f"{name}.bn.{key}"] = BN_MOMENTUM * old + (1 - BN_MOMENTUM) * batch.detach()
    y = ((xf - mean[None, :, None, None]) * torch.rsqrt(var + BN_EPS)[None, :, None, None]
         * params[f"{name}.bn.scale"][None, :, None, None]
         + params[f"{name}.bn.bias"][None, :, None, None])
    return y.to(x.dtype)


def _conv_bn(x, params, name, stride, relu, p, stats):
    y = batch_norm(conv(x, params[f"{name}.conv.weight"], None, stride, True, p),
                   params, name, stats)
    return F.relu(y) if relu else y


def resnet18(x, params: dict, prefix: str, p: Precision, stats: dict | None):
    y = _conv_bn(x, params, f"{prefix}.conv1", 2, True, p, stats)
    (h0, h1), (w0, w1) = _same_pad(y.shape[2], 3, 2), _same_pad(y.shape[3], 3, 2)
    y = F.max_pool2d(F.pad(y, (w0, w1, h0, h1), value=float("-inf")), 3, 2)
    for stage in ("conv2", "conv3", "conv4", "conv5"):
        for j in (1, 2):
            name = f"{prefix}.{stage}_{j}"
            first = j == 1 and stage != "conv2"
            short = (conv(y, params[f"{name}.shortcut.conv.weight"], None, 2, True, p)
                     if first else y)
            z = _conv_bn(y, params, f"{name}.conv_1", 2 if first else 1, True, p, stats)
            z = _conv_bn(z, params, f"{name}.conv_2", 1, False, p, stats)
            y = F.relu(z + short)
    return y


# ---------------------------------------------------------------------------
# DFTs


def dft_bases(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    k = np.arange(n)
    ang = -2.0 * np.pi * np.outer(k, k) / n
    return (torch.tensor(np.cos(ang), dtype=torch.float32, device=device),
            torch.tensor(np.sin(ang), dtype=torch.float32, device=device))


def hann(n: int, device) -> torch.Tensor:
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)
    return torch.tensor(w, dtype=torch.float32, device=device)


def stft_frames(x: torch.Tensor, g: Geometry):
    """Real and imaginary parts of frames [enc_ss, enc_ss + n_enc) of the
    hop = wind/4 STFT of x (B, 1, N): (B, 1, n_enc, wind) each."""
    wind, hop = g.wind, g.hop
    n_pad = -(-g.n_enc // 4) * 4
    need = (g.enc_ss + n_pad - 1) * hop + wind
    if need > x.shape[-1]:
        x = F.pad(x, (0, need - x.shape[-1]))
    frames = x.unfold(-1, wind, hop)[..., g.enc_ss: g.enc_ss + g.n_enc, :]
    frames = frames * hann(wind, x.device)
    c, s = dft_bases(wind, x.device)
    return frames @ c, frames @ s


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


# The precision a product is declared in, where it differs from its
# operands' dtype: set around the masked ISTFT's GEMMs (float32 tensors
# holding bf16 values), read by reference.work's count of operations.
declared = [None]


class _RoundedSynthesis(torch.autograd.Function):
    """A @ Cb + B @ Sb with A, B and the bases already rounded, whose
    backward rounds the cotangent to bf16 before its two GEMMs (the
    declared bf16 route of the product and of its gradient)."""

    @staticmethod
    def forward(ctx, a, b, c, s):
        ctx.save_for_backward(c, s)
        declared[0] = "bf16"
        try:
            return a @ c + b @ s
        finally:
            declared[0] = None

    @staticmethod
    def backward(ctx, dz):
        c, s = ctx.saved_tensors
        dz = _bf16(dz)
        declared[0] = "bf16"
        try:
            return dz @ c.transpose(0, 1), dz @ s.transpose(0, 1), None, None
        finally:
            declared[0] = None


def overlap_add(x: torch.Tensor, hop: int) -> torch.Tensor:
    """Comb-stream overlap-add of per-frame inverse DFTs (..., T, F): stream
    k (frames t % 4 == k) butt-joined from sample (3 - k) * hop, the four
    averaged (reference myutils.py:181-211)."""
    *lead, t, f = x.shape
    n_w = t // 4
    x = x[..., : n_w * 4, :].reshape(*lead, n_w, 4, f).transpose(-2, -3)
    x = x.reshape(*lead, 4, n_w * f)
    length = n_w * f - 3 * hop
    return sum(x[..., k, (3 - k) * hop: (3 - k) * hop + length] for k in range(4)) / 4.0


def masked_istft(re, im, mask, p: Precision):
    """re, im (B, 1, T, F); mask (B, 1, tracks, T, F) -> (B, 1, tracks, L)."""
    f = re.shape[-1]
    m = mask.float()
    a, b = re[:, :, None] * m, im[:, :, None] * m
    c, s = dft_bases(f, re.device)
    if p.istft_bf16:
        # rounded forward values, gradient passed straight through
        a = a + (_bf16(a) - a).detach()
        b = b + (_bf16(b) - b).detach()
        z = _RoundedSynthesis.apply(a, b, _bf16(c), _bf16(s))
    else:
        z = a @ c + b @ s
    return overlap_add(z / float(f), f // 4)


# ---------------------------------------------------------------------------
# the model


def forward(params: dict, batch: dict, m: ModelShape, p: Precision,
            new_stats: dict | None = None) -> torch.Tensor:
    """The train-mode forward (visual BN on batch statistics) of a batch
    {ambix (B, snd_size, 4) float32, video / flow (B, T, H, W, 3)} ->
    (B, snd_dur, 3). The moved BN averages go into `new_stats`."""
    g = m.geometry
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return _forward(params, batch, m, p, new_stats, g)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev


def _forward(params, batch, m, p, stats, g):
    mono = batch["ambix"][:, :, :1].transpose(1, 2)             # (B, 1, N)
    re, im = stft_frames(mono, g)
    mag = torch.sqrt(re * re + im * im)
    if p.compute is not None:
        mag = mag.to(p.compute)
    acts = [mag]
    for i, s in enumerate(AUDIO_STRIDES):
        name = f"audio_encoder.conv{i + 1}.conv"
        acts.append(F.relu(conv(acts[-1], params[f"{name}.weight"], params[f"{name}.bias"],
                                s, False, p)))
    b = mono.shape[0]
    audio = acts[-1]
    t_audio = audio.shape[2]
    parts = [F.relu(dense(audio.permute(0, 2, 3, 1).reshape(b, t_audio, -1),
                          params["bottleneck.audio-fc.dense.weight"],
                          params["bottleneck.audio-fc.dense.bias"], p))]
    for enc in m.visual:
        frames = batch[enc]
        if frames.dtype == torch.uint8:
            frames = frames.float() / 255.0 - 0.5
        x = frames.flatten(0, 1).permute(0, 3, 1, 2)
        if p.compute is not None:
            x = x.to(p.compute)
        y = resnet18(x.contiguous(), params, f"{enc}_encoder", p, stats)
        y = F.relu(dense(y.permute(0, 2, 3, 1), params[f"bottleneck.{enc}-fc-red.dense.weight"],
                         params[f"bottleneck.{enc}-fc-red.dense.bias"], p))
        y = y.reshape(b, g.vid_dur, -1)
        y = F.relu(dense(y, params[f"bottleneck.{enc}-fc.dense.weight"],
                         params[f"bottleneck.{enc}-fc.dense.bias"], p))
        parts.append(y.repeat_interleave(t_audio // g.vid_dur, dim=1))
    feats = torch.cat(parts, dim=2)

    x = feats
    n_loc = len(m.loc_units)
    for i in range(n_loc + 1):
        x = dense(x, params[f"localization.fc{i + 1}.dense.weight"],
                  params[f"localization.fc{i + 1}.dense.bias"], p)
        if i < n_loc:
            x = F.relu(x)
    x = x.reshape(b, t_audio, 3, 1, m.tracks + 1)
    weights, biases = x[..., :-1], x[..., -1]

    # separation U-Net over the encoder's activations
    x = F.relu(dense(feats, params["separation.fc-feats.dense.weight"],
                     params["separation.fc-feats.dense.bias"], p))
    x = x.transpose(1, 2)[..., None].expand(-1, -1, -1, audio.shape[3])
    x = torch.cat([audio, x], dim=1)
    deconv_ss = g.mask_ss - g.enc_ss
    lo = max(0, -(-(deconv_ss - (AUDIO_KERNELS[0][0] - 1)) // AUDIO_STRIDES[0][0]))
    hi = (deconv_ss + g.n_mask - 1) // AUDIO_STRIDES[0][0] + 1
    for layer in reversed(range(len(AUDIO_FILTERS))):
        if layer == 0:
            # only frames [deconv_ss, deconv_ss + n_mask) of deconv1's output
            # are used; they depend on input frames [lo, hi) alone
            x = x[:, :, lo:hi]
        name = f"separation.deconv{layer + 1}.deconv"
        x = deconv(x, params[f"{name}.weight"], params[f"{name}.bias"],
                   AUDIO_STRIDES[layer], p)
        if layer:
            x = torch.cat([F.relu(x), acts[layer]], dim=1)
    start = deconv_ss - lo * AUDIO_STRIDES[0][0]
    mask = torch.sigmoid(x.float())
    if p.compute is not None:
        mask = mask.to(p.compute)
    mask = mask[:, :, start: start + g.n_mask][:, None]           # (B, 1, tracks, T, F)
    lo_f = g.mask_ss - g.enc_ss
    sep = masked_istft(re[:, :, lo_f: lo_f + g.n_mask], im[:, :, lo_f: lo_f + g.n_mask],
                       mask, p)[..., g.out_ss: g.out_ss + g.snd_dur]

    # decode: each video-rate coefficient covers snd_dur / t_audio samples
    s = sep.unflatten(3, (t_audio, g.snd_dur // t_audio))        # (B, 1, tr, T, r)
    ambi = torch.einsum("btoik,biktr->btro", weights.float(), s)
    ambi = ambi + biases[..., 0].float()[:, :, None]
    return ambi.reshape(b, g.snd_dur, 3)


def loss_stft(x: torch.Tensor, window: int):
    """Loss-side STFT (reference myutils.py:151-178): window rounded up to
    a power of two, two overlapping streams of whole windows concatenated.
    x (B, N, C) -> (re, im) (B, C, n_windows, window)."""
    window = int(2 ** math.ceil(math.log2(window)))
    stride = window // 2
    n = x.shape[1]
    parts = []
    for i in range(2):
        n_w = int(float(n - i * stride - 1) / window)
        parts.append(x[:, i * stride: i * stride + window * n_w].reshape(
            x.shape[0], n_w, window, x.shape[2]))
    frames = torch.cat(parts, dim=1).permute(0, 3, 1, 2) * hann(window, x.device)
    c, s = dft_bases(window, x.device)
    return frames @ c, frames @ s


def training_loss(params: dict, pred, target, channel_mask, m: ModelShape,
                  weight_decay: float = 5e-4) -> torch.Tensor:
    """Masked STFT-MSE x100, averaged over channels, plus wd/2 times the sum
    of squares of every kernel except the localization output layer's
    (reference model.py:156-159, train.py:139-144)."""
    window = int(0.025 * m.geometry.audio_rate)
    gr, gi = loss_stft(target, window)
    pr, pi = loss_stft(pred, window)
    per = ((gr - pr) ** 2 + (gi - pi) ** 2).mean(dim=(2, 3))         # (B, C)
    per_channel = (per * channel_mask).sum(0) / channel_mask.sum(0).clamp(min=1.0)
    loss = 100.0 * per_channel.mean()
    out_layer = f"localization.fc{len(m.loc_units) + 1}."
    kernels = [params[name] for name, _, role in param_spec(m)
               if role == "kernel" and not name.startswith(out_layer)]
    reg = torch.stack([(k.float() ** 2).sum() for k in kernels]).sum()
    return loss + 0.5 * weight_decay * reg
