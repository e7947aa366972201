"""Work and peaks: the operations of one reference step counted from its
shapes, the published peaks of one NVIDIA H100 SXM, and the work of one
masked-ISTFT kernel call (K1 forward, K2 backward) with its bound.

Peaks: NVIDIA H100 SXM data sheet, dense rates without sparsity, at the
card's full 700 W power limit: 67 TFLOP/s float32 outside the tensor
cores, 495 TFLOP/s TF32 (3xTF32, three passes: 495/3), 989 TFLOP/s
bf16/fp16, 1979 TFLOP/s fp8, 3.35 TB/s of HBM3.

The count runs the reference's forward (and backward) on meta tensors
under a dispatch mode that charges each matrix product and convolution
with torch.utils.flop_counter's formulas (the table FlopCounterMode uses),
grouped by the precision the configuration declares for it: the dtype of
its operands, TF32 where the precision allows it for float32, or the
masked ISTFT's declared bf16 route. So the count follows the reference,
not how the program computes.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from port_bench.reference import model as ref_model

PEAK_FLOPS = {"f32": 67e12, "tf32": 495e12, "3xtf32": 495e12 / 3, "bf16": 989e12,
              "fp8": 1979e12}
HBM_BYTES_PER_S = 3.35e12
ROUTE_PEAK = {"default": PEAK_FLOPS["bf16"], "highest": PEAK_FLOPS["3xtf32"]}
PEAK_SOURCE = "NVIDIA H100 SXM data sheet, dense, 700 W"


class _CountByPrecision(TorchDispatchMode):
    def __init__(self, tf32: bool):
        super().__init__()
        self.tf32 = tf32
        self.flops: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        counter = flop_registry.get(func._overloadpacket)
        if counter is not None:
            n = counter(*args, **kwargs, out_val=out)
            key = ref_model.declared[0] or self._precision(args)
            self.flops[key] = self.flops.get(key, 0) + n
        return out

    def _precision(self, args) -> str:
        dtype = next(a.dtype for a in args if isinstance(a, torch.Tensor))
        if dtype == torch.float32:
            return "tf32" if self.tf32 else "f32"
        if dtype in (torch.bfloat16, torch.float16):
            return "bf16"
        return "fp8" if dtype.itemsize == 1 else "f32"


def meta_batch(m: ref_model.ModelShape, batch: int) -> dict:
    g = m.geometry
    out = {"ambix": torch.empty(batch, g.snd_size, 4, device="meta"),
           "audio_mask": torch.empty(batch, 4, device="meta")}
    h, w = m.frame_hw
    for enc in m.visual:
        out[enc] = torch.empty(batch, g.vid_dur, h, w, 3, device="meta",
                               dtype=torch.uint8 if enc == "video" else torch.float32)
    return out


def count_flops(m: ref_model.ModelShape, p: ref_model.Precision, batch: int,
                backward: bool) -> dict:
    """{precision: operations} of one forward (with the loss and the
    backward when `backward`) at `batch` rows."""
    from port_bench.reference.train import split   # the step's target and mask

    params = {name: torch.empty(shape, device="meta", requires_grad=backward
                                and role not in ("bn_mean", "bn_var"))
              for name, shape, role in ref_model.param_spec(m)}
    data = meta_batch(m, batch)
    mode = _CountByPrecision(p.tf32)
    with mode, torch.set_grad_enabled(backward):
        pred = ref_model.forward(params, data, m, p, {} if backward else None)
        if backward:
            target, mask = split(data, m.geometry)
            loss = ref_model.training_loss(params, pred, target, mask, m)
            torch.autograd.grad(loss, [t for t in params.values() if t.requires_grad])
    return mode.flops


def least_seconds(flops: dict) -> float:
    """The least time of `flops` at the published peaks."""
    return sum(n / PEAK_FLOPS[key] for key, n in flops.items())


def istft_work(batch: int, n_in: int, tracks: int, frames: int, f: int, route: str,
               mask_bytes: int) -> tuple[float, float]:
    """(operations, bytes) of one K1 or K2 call: the GEMM over (track,
    frame) rows of the used frames, depth F against [C | S]; re, im and
    both bases read once (bases in bf16 on the "default" route, float32
    otherwise), the mask read once. Each output is written once: K1's
    tracks (float32), K2's mask gradient and the spectra's."""
    t_use = (frames // 4) * 4
    rows = batch * n_in * tracks * t_use
    flops = 2.0 * rows * (2 * f) * f
    spectra = 2 * batch * n_in * frames * f * 4 + 2 * f * f * (2 if route == "default" else 4)
    mask = batch * n_in * tracks * frames * f * mask_bytes
    return flops, spectra + mask


def bound_seconds(flops: float, nbytes: float, route: str) -> float:
    """The least time the card could take for one call on `route`: the
    larger of operations over the route's peak and bytes over HBM's."""
    return max(flops / ROUTE_PEAK[route], nbytes / HBM_BYTES_PER_S)
