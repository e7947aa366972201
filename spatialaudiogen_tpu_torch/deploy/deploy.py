"""Full-video mono->FOA inference by batched sliding windows (port of
spatialaudiogen_tpu.deploy.deploy, reference deploy.py:41-152 W2XYZ).

The model predicts 0.1 s of Y/Z/X per window from 1 s of mono context plus
frames; windows slide by 0.1 s and are batched; the mono W channel passes
through untouched. As in the JAX engine:

  * one contiguous audio span per batch goes to the device with the window
    offsets, and the windows are gathered there (an `unfold` view of the
    span indexed by the offsets); PCM16-exact spans ship as int16;
  * frames ship as uint8 (RGB, or raw I420 planes when the native decoder
    can give them) and are normalised on the device;
  * pad lanes of the last batch travel as offset -1 and are zeroed, not
    dropped: the visual encoder's BatchNorm runs on batch statistics, so
    real lanes see the pad lanes through the batch moments;
  * predictions may come back as float16 (`f16_fetch`);
  * an optional Hann crossfade blends a second pass offset by half a window.

Flow configs (the reference's default audio+flow+video model) take the JAX
engine's other route, per-window host assembly (`_predict_span_host`): the
SampleReader's float32 windows (audio, video frames after the
x/255 - 0.5 prep, decoded flow maps) are stacked per batch on the host, a
partial last batch is padded with zero windows that stay in the forward
(the pad lanes reach the real ones through the visual encoders' batch
statistics, as in the JAX engine), and predictions come back as float32,
one batch behind the dispatch.

Both routes run cuDNN's deterministic algorithms (deterministic_cudnn), so
the same window gives the same bits on every run: the streaming server
(deploy/stream.py) promises to equal a batch-1 deploy bit for bit.

Spans (utils.profiling): a call is `deploy.call` (id = the engine's call
count) holding `deploy.reader` (opening the clip), and per batch
`deploy.wait` (blocked on the background reader), `deploy.upload`,
`deploy.forward` (the forward's launch and the start of its copy back) and
`deploy.drain` (the wait for a copy and the store), then `deploy.join`
(the output assembled); the reader thread records `deploy.read` per batch
under the call's id. Counters: `deploy.windows`, `deploy.lanes` (the batch
size per batch, so lanes - windows are pad lanes), and `deploy.h2d_bytes`
and `deploy.d2h_bytes` (the bytes handed to and fetched from the device,
copied or not).

Host buffers are pinned and the copies are non-blocking: decode runs in a
background thread and the copy back of a batch's predictions is read two
batches after it was issued, so the host and the card overlap.

With a mesh (parallel.mesh, n_model = 1: the JAX engine's P('data')
sharding) every rank reads the same clip into the same batches, uploads
and runs only its contiguous block of each batch's rows (its sub-span of
the audio, its offsets and frames), and the predictions come back to rank
0 in rank order, which alone returns the result. Every BatchNorm takes its
moments over the data group, so the pad lanes of the last batch reach the
real ones wherever they sit, as on one card.
"""

from __future__ import annotations

import itertools
import os
from collections import deque

import numpy as np
import torch

from spatialaudiogen_tpu_torch.config import FLOW, VIDEO, TrainConfig
from spatialaudiogen_tpu_torch.data.generic import BackgroundGenerator
from spatialaudiogen_tpu_torch.data.packed import PackedVideoReader, is_packed
from spatialaudiogen_tpu_torch.data.readers import SampleReader, VideoFrameReader, img_prep_default
from spatialaudiogen_tpu_torch.models.convert import load_params
from spatialaudiogen_tpu_torch.models.sptaudiogen import SptAudioGen
from spatialaudiogen_tpu_torch.ops.dft import deterministic_cudnn
from spatialaudiogen_tpu_torch.parallel.mesh import (
    all_gather_rows,
    gather_host_rows,
    row_block,
    shard_model,
)
from spatialaudiogen_tpu_torch.utils import profiling
from spatialaudiogen_tpu_torch.utils.io_audio import pcm16_exact

DEPLOY_DURATION = 0.1  # deploy.py:49


def _triangle_up2(c: torch.Tensor, dim: int) -> torch.Tensor:
    """2x upsample along `dim` with libjpeg's "fancy" (3,1)/4 triangle
    filter, edge-replicated (jdsample.c h2v2_fancy_upsample semantics)."""
    dim = dim % c.dim()
    n = c.shape[dim]
    prev = torch.cat([c.narrow(dim, 0, 1), c.narrow(dim, 0, n - 1)], dim)
    nxt = torch.cat([c.narrow(dim, 1, n - 1), c.narrow(dim, n - 1, 1)], dim)
    st = torch.stack([(3.0 * c + prev) * 0.25, (3.0 * c + nxt) * 0.25], dim + 1)
    return st.flatten(dim, dim + 1)


def yuv420_planes_to_rgb01(planes: torch.Tensor, height: int) -> torch.Tensor:
    """(..., H*3/2, W) uint8 I420 planes -> (..., H, W, 3) float RGB in
    [0, 1], with the chroma triangle-upsampled and libjpeg's BT.601
    full-range coefficients (jdcolor.c)."""
    h = height
    w = planes.shape[-1]
    lead = planes.shape[:-2]
    y = planes[..., :h, :].float()
    u = planes[..., h:h + h // 4, :].reshape(lead + (h // 2, w // 2))
    v = planes[..., h + h // 4:, :].reshape(lead + (h // 2, w // 2))
    u = _triangle_up2(_triangle_up2(u.float(), -2), -1) - 128.0
    v = _triangle_up2(_triangle_up2(v.float(), -2), -1) - 128.0
    r = y + 1.402 * v
    g = y - 0.344136 * u - 0.714136 * v
    b = y + 1.772 * u
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 255.0) / 255.0


def host_rgb_to_i420(rgb: np.ndarray) -> np.ndarray:
    """(T, H, W, 3) uint8 -> (T, H*3/2, W) uint8 I420 (BT.601 full range,
    2x2 box chroma): host fallback for frames that are not 4:2:0 jpgs."""
    t, h, w, _ = rgb.shape
    f = rgb.astype(np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    v = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    out = np.empty((t, h * 3 // 2, w), np.uint8)
    out[:, :h] = np.clip(y + 0.5, 0, 255)
    for plane, dst0 in ((u, h), (v, h + h // 4)):
        sub = plane.reshape(t, h // 2, 2, w // 2, 2).mean(axis=(2, 4))
        out[:, dst0: dst0 + h // 4] = np.clip(sub + 0.5, 0, 255).reshape(t, h // 4, w)
    return out


def video_input(video_u8: torch.Tensor | None, valid: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor | None:
    """(B, T, H, W, 3) RGB or (B, T, H*3/2, W) I420 planes, uint8 on the
    device -> the model's (B, T, H, W, 3) input, x/255 - 0.5, with the lanes
    where `valid` is 0 zeroed (the deploy's pad lanes, the stream batcher's
    idle lanes). None stays None."""
    if video_u8 is None:
        return None
    if video_u8.dim() == 4:                # raw I420 planes
        h = video_u8.shape[2] * 2 // 3
        video = yuv420_planes_to_rgb01(video_u8, h) - 0.5
    else:
        video = video_u8.float() / 255.0 - 0.5
    return video.to(dtype) * valid[:, None, None, None, None]


class MonoToAmbix:
    """Sliding-window deploy engine (reference W2XYZ, deploy.py:41-152).

    `model_dir` holds train-params.json and params.npz (models.convert).
    Predictions depend slightly on batch composition, because the visual
    encoder's BatchNorm runs on batch statistics (the reference quirk):
    batch_size=10 reproduces the reference's numbers.

    `mesh` (parallel.mesh.Mesh, n_model = 1) shards each batch's rows over
    the data ranks (module docstring); batch_size must divide over them.
    deploy() then returns the result on rank 0 and None on the others.
    """

    def __init__(self, model_dir: str, batch_size: int = 32, device: str = "cuda",
                 compute_dtype: str | None = None, yuv_frames: bool | None = None,
                 f16_fetch: bool = True, mesh=None):
        if mesh is not None and batch_size % mesh.n_data:
            raise ValueError(f"batch_size {batch_size} must divide over {mesh.n_data} "
                             f"data ranks")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but torch.cuda.is_available() is False")
        self.mesh = mesh if mesh is not None and mesh.data_group is not None else None
        # yuv_frames: ship frames as raw 4:2:0 planes and convert on the
        # device; None = when the native decoder supports the frame dir.
        self.yuv_frames = yuv_frames
        # f16_fetch: copy predictions back as float16 (~5e-4 relative).
        self.f16_fetch = f16_fetch
        self.cfg = TrainConfig.load(model_dir, compute_dtype=compute_dtype)
        self.cfg.model_dir = model_dir
        self.cfg.sample_dur = DEPLOY_DURATION
        self.batch_size = batch_size
        mcfg = self.cfg.model_config()
        self.geometry = mcfg.geometry
        self.model = SptAudioGen(mcfg, frame_hw=tuple(self.cfg.frame_hw))
        self.model.load_state_dict(load_params(model_dir), strict=True)
        if self.mesh is not None:
            shard_model(self.model, self.mesh)
        self.model.to(self.device).eval()
        self._n_out = self.geometry.num_ambi_channels - self.geometry.num_in_channels
        self._rows = row_block(batch_size, self.mesh)   # this rank's lanes of a batch
        self._calls = 0                                  # deploy() calls: the span id

    # ------------------------------------------------------------------
    @torch.no_grad()
    @deterministic_cudnn()
    def fwd_span(self, span: torch.Tensor, rel: torch.Tensor,
                 video_u8: torch.Tensor | None) -> torch.Tensor:
        """Forward over windows gathered on the device from one audio span.

        span: (L, n_in) float32 or int16 PCM; rel: (B,) int window offsets
        into span, pad lanes -1; video_u8: (B, T, H, W, 3) RGB or
        (B, T, H*3/2, W) I420 planes, uint8, or None. -> (B, snd_dur, n_out).
        """
        g = self.geometry
        dtype = next(self.model.parameters()).dtype   # float32 unless .double()d
        if span.dtype == torch.int16:
            span = span.float() / 32768.0          # exact: wav decode is int16/32768
        span = span.to(dtype)
        valid = (rel >= 0).to(dtype)
        windows = span.unfold(0, g.snd_size, 1)    # (L - snd_size + 1, n_in, snd_size)
        audio = windows[rel.clamp(min=0)].transpose(1, 2) * valid[:, None, None]
        return self.model(audio, video_input(video_u8, valid, dtype))

    def fwd_windows(self, audio: np.ndarray, video: np.ndarray | None,
                    flow: np.ndarray | None) -> torch.Tensor:
        """Forward over host-assembled float32 windows (flow configs):
        audio (B, snd_size, n_in), video (B, T, H, W, 3) after the x/255 -
        0.5 prep, flow (B, T, H, W, 3) decoded maps, or None. Uploaded as
        _upload does; -> (B, snd_dur, n_out) float32 on the engine's
        device. The batch deploy's host route and the stream's flow route
        share it, so a batch-1 stream equals a batch-1 deploy bit for bit."""
        return self._fwd_uploaded(*self._upload_windows(audio, video, flow))

    def _upload_windows(self, *arrays) -> list:
        """fwd_windows' upload: each array to the device in the model's
        dtype (None stays None)."""
        dtype = next(self.model.parameters()).dtype   # float32 unless .double()d
        return [None if x is None else self._upload(x).to(dtype) for x in arrays]

    @torch.no_grad()
    @deterministic_cudnn()
    def _fwd_uploaded(self, audio: torch.Tensor, video: torch.Tensor | None,
                      flow: torch.Tensor | None) -> torch.Tensor:
        return self.model(audio, video, flow).float()

    def _reader(self, input_folder: str, start: float, duration: float | None):
        reader = SampleReader(
            input_folder,
            ambi_order=self.cfg.ambi_order,
            audio_rate=self.cfg.audio_rate,
            video_rate=self.cfg.video_rate,
            context=self.cfg.context,
            duration=DEPLOY_DURATION,
            return_video=VIDEO in self.cfg.encoders,
            img_prep=img_prep_default,
            return_flow=FLOW in self.cfg.encoders,
            skip_silence_thr=None,
            shuffle=False,
            random_rotations=False,
            skip_rate=None,
            start_time=start,
            sample_duration=duration,
            rng=np.random.RandomState(0))
        # align the first window exactly to `start` (deploy.py:106-107)
        if reader.chunks_t:
            dt = reader.chunks_t[0] - start
            reader.chunks_t = [t - dt for t in reader.chunks_t]
        return reader

    def _span_batches(self, reader, input_folder: str, trace_id=None):
        """Host side: per batch, one contiguous mono span + int32 window
        offsets + uint8 frames (runs in a background thread; each batch a
        `deploy.read` span under `trace_id`)."""
        g = self.geometry
        rate = self.cfg.audio_rate
        B = self.batch_size
        # fixed span length; +16 slack absorbs float-time rounding
        span_len = (B - 1) * g.snd_dur + g.snd_size + 16
        video_reader = None
        if VIDEO in self.cfg.encoders:
            vdir = os.path.join(input_folder, "video")
            if os.path.isdir(vdir):
                video_reader = VideoFrameReader(vdir, self.cfg.video_rate,
                                                img_prep=lambda x: x)
            else:
                # no jpg dir: serve decoded frames from the pack
                if not is_packed(input_folder):
                    raise FileNotFoundError(f"no video/ dir or pack in {input_folder}")
                video_reader = PackedVideoReader(input_folder, self.cfg.video_rate,
                                                 img_prep=lambda x: x)

        def yuv_ok():
            return (hasattr(video_reader, "yuv420_supported")
                    and video_reader.yuv420_supported())

        use_yuv = (video_reader is not None and self.yuv_frames is not False
                   and yuv_ok())
        if self.yuv_frames and video_reader is not None:
            if not yuv_ok():
                raise ValueError("yuv_frames=True but the frame dir has no native "
                                 "4:2:0 path")

        def read_frames(t):
            if not use_yuv:
                return video_reader.get_by_index(t, g.vid_dur)
            planes = video_reader.get_yuv420_by_index(t, g.vid_dur)
            if planes is None:  # odd non-4:2:0 frame mid-dir: convert on host
                planes = host_rgb_to_i420(video_reader.get_by_index(t, g.vid_dur))
            return planes

        ts = reader.chunks_t
        ar = reader.audio_reader

        def read(batch_ts):
            n = len(batch_ts)
            starts = [g.chunk_start_sample(t) for t in batch_ts]
            rel = np.array(starts, np.int64) - starts[0]
            assert rel.max() + g.snd_size <= span_len, "window drift > slack"
            rel = np.concatenate([rel, np.full(B - n, -1, np.int64)])
            span = ar.get(starts[0] / rate, span_len, None)[:, :g.num_in_channels]
            video_u8 = None
            if video_reader is not None:
                frames = [read_frames(t) for t in batch_ts]
                frames += [frames[-1]] * (B - n)
                video_u8 = np.stack(frames, 0)
            mono = np.concatenate(
                [span[r + g.nosep_ss: r + g.nosep_ss + g.snd_dur] for r in rel[:n]], 0)
            i16 = pcm16_exact(span)
            if i16 is not None:
                span = i16
            return n, span, rel, video_u8, mono

        for k in range(0, len(ts), B):
            with profiling.span("deploy.read", trace_id):
                batch = read(ts[k: k + B])
            yield batch

    def _upload(self, arr: np.ndarray | None) -> torch.Tensor | None:
        if arr is None:
            return None
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _local_span(self, span: np.ndarray, rel: np.ndarray, video_u8):
        """This rank's part of a batch of the on-device gather: its lanes'
        offsets, frames and the sub-span their windows cover (offsets made
        relative to it; pad lanes stay -1). The whole batch without a mesh."""
        if self.mesh is None:
            return span, rel, video_u8
        rel = rel[self._rows]
        real = rel[rel >= 0]
        lo = int(real.min()) if real.size else 0
        hi = (int(real.max()) if real.size else 0) + self.geometry.snd_size
        rel = np.where(rel >= 0, rel - lo, -1)
        return (span[lo:hi], rel, None if video_u8 is None
                else np.ascontiguousarray(video_u8[self._rows]))

    def _copy_back(self, out: torch.Tensor):
        """Start the copy of a batch's predictions to the host -> (host
        tensor or None, copy-done event or None). Under NCCL the ranks'
        blocks are gathered on the card first and only rank 0 copies; under
        gloo each rank copies its block (_copied gathers them)."""
        if self.mesh is not None and self.mesh.backend == "nccl":
            out = all_gather_rows(out, self.mesh)
            if not self.mesh.is_primary:
                return None, None
        profiling.count("deploy.d2h_bytes", out.nbytes)
        if self.device.type != "cuda":
            return out, None
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _copied(self, host, done) -> torch.Tensor | None:
        """The whole batch's predictions on the host of rank 0 (None on the
        other ranks), once the copy _copy_back started has landed. Every
        rank calls it in the same batch order: under gloo it gathers."""
        if done is not None:
            done.synchronize()
        if self.mesh is not None and self.mesh.backend != "nccl":
            host = gather_host_rows(host, self.mesh)
        return host

    @staticmethod
    def _batches(gen):
        """Iterate the batches `gen` makes in a background thread, each wait
        for the next a `deploy.wait` span."""
        it = iter(BackgroundGenerator(gen, depth=2))
        while True:
            with profiling.span("deploy.wait"):
                item = next(it, None)
            if item is None:
                return
            yield item

    def _count_batch(self, n: int, arrays) -> None:
        """A batch's counters: its real windows, its lanes and the bytes of
        this rank's `arrays` handed to the device."""
        profiling.count("deploy.windows", n)
        profiling.count("deploy.lanes", self.batch_size)
        profiling.count("deploy.h2d_bytes", sum(a.nbytes for a in arrays if a is not None))

    def _predict_span(self, input_folder: str, start: float, duration: float | None):
        """One sliding pass -> (mono (N, n_in), pred (N, n_out)): flow
        configs through per-window host assembly, the others through the
        on-device gather, as the JAX engine's _predict_span routes them."""
        if FLOW not in self.cfg.encoders:
            return self._predict_span_ondevice(input_folder, start, duration)
        return self._predict_span_host(input_folder, start, duration)

    def _window_batches(self, reader, trace_id=None):
        """Host-side batch assembly of whole windows (flow configs; runs in
        a background thread so window reads overlap the card): per batch
        (n real windows, audio (B, snd_size, n_in), video, flow
        (B, T, H, W, 3) float32 or None, mono passthrough), each a
        `deploy.read` span under `trace_id`. A partial last batch is padded
        with zero windows, as the JAX engine pads it."""
        g = self.geometry
        n_in = g.num_in_channels
        batch = {"ambix": [], "video": [], "flow": []}

        def assemble():
            n = len(batch["ambix"])
            pad = self.batch_size - n

            def padded(stack):
                if not stack:
                    return None
                arr = np.stack(stack, 0).astype(np.float32)
                if pad:
                    arr = np.concatenate(
                        [arr, np.zeros((pad,) + arr.shape[1:], np.float32)], 0)
                return arr

            ambix, video, flow = (padded(batch[k]) for k in ("ambix", "video", "flow"))
            mono = ambix[:n, g.nosep_ss: g.nosep_ss + g.snd_dur, :n_in] \
                .reshape(n * g.snd_dur, n_in).copy()
            for stack in batch.values():
                stack.clear()
            return n, np.ascontiguousarray(ambix[:, :, :n_in]), video, flow, mono

        chunks = iter(reader.loop_chunks())
        while True:
            with profiling.span("deploy.read", trace_id):
                for chunk in itertools.islice(chunks, self.batch_size):
                    for key in batch:
                        if key in chunk:
                            batch[key].append(chunk[key])
                item = assemble() if batch["ambix"] else None
            if item is None:
                return
            yield item

    def _predict_span_host(self, input_folder: str, start: float, duration: float | None):
        """One sliding pass through per-window host assembly (the JAX
        engine's _predict_span_host) -> (mono (N, n_in), pred (N, n_out))."""
        g = self.geometry
        with profiling.span("deploy.reader"):
            reader = self._reader(input_folder, start, duration)
        monos, preds = [], []
        pending = deque()   # (n, host tensor, copy-done event): one batch behind

        def drain(n, host, done):
            with profiling.span("deploy.drain"):
                host = self._copied(host, done)
                if host is not None:
                    preds.append(host[:n].numpy().reshape(n * g.snd_dur, -1))

        rows = self._rows
        for n, audio, video, flow, mono in self._batches(
                self._window_batches(reader, profiling.TRACER.current_id())):
            monos.append(mono)
            local = [None if x is None else np.ascontiguousarray(x[rows])
                     for x in (audio, video, flow)]
            with profiling.span("deploy.upload"):
                self._count_batch(n, local)
                dev = self._upload_windows(*local)
            with profiling.span("deploy.forward"):
                pending.append((n,) + self._copy_back(self._fwd_uploaded(*dev)))
            if len(pending) > 1:
                drain(*pending.popleft())
        while pending:
            drain(*pending.popleft())
        if not monos:
            raise ValueError(f"no windows to deploy in {input_folder}")
        return np.concatenate(monos, 0), np.concatenate(preds, 0) if preds else None

    def _predict_span_ondevice(self, input_folder: str, start: float,
                               duration: float | None):
        """One sliding pass through the on-device window gather (configs
        without flow) -> (mono (N, n_in), pred (N, n_out))."""
        g = self.geometry
        with profiling.span("deploy.reader"):
            reader = self._reader(input_folder, start, duration)
        n_windows = len(reader.chunks_t)
        if not n_windows:
            raise ValueError(f"no windows to deploy in {input_folder}")
        total = n_windows * g.snd_dur
        mono_out = np.empty((total, g.num_in_channels), np.float32)
        pred_out = np.empty((total, self._n_out), np.float32)
        mono_fill = pred_fill = 0
        pending = deque()   # (n, host tensor, copy-done event)

        def drain(n, host, done):
            nonlocal pred_fill
            with profiling.span("deploy.drain"):
                host = self._copied(host, done)
                if host is None:       # not rank 0 of a mesh
                    return
                rows = n * g.snd_dur
                # float16 -> float32 widening fuses into this store
                pred_out[pred_fill: pred_fill + rows] = host[:n].numpy().reshape(rows, -1)
                pred_fill += rows

        for n, span, rel, video_u8, mono in self._batches(
                self._span_batches(reader, input_folder, profiling.TRACER.current_id())):
            mono_out[mono_fill: mono_fill + mono.shape[0]] = mono
            mono_fill += mono.shape[0]
            span, rel, video_u8 = self._local_span(span, rel, video_u8)
            with profiling.span("deploy.upload"):
                self._count_batch(n, (span, rel, video_u8))
                dev = (self._upload(span), self._upload(rel), self._upload(video_u8))
            with profiling.span("deploy.forward"):
                out = self.fwd_span(*dev)
                if self.f16_fetch:
                    out = out.half()
                pending.append((n,) + self._copy_back(out))
            if len(pending) > 2:
                drain(*pending.popleft())
        while pending:
            drain(*pending.popleft())
        if pred_fill == 0:         # not rank 0 of a mesh
            return mono_out, None
        assert mono_fill == pred_fill == total
        return mono_out, pred_out

    def deploy(self, input_folder: str, deploy_start: float = 0.0,
               deploy_duration: float | None = 10.0,
               crossfade: bool = False) -> np.ndarray:
        """(N, n_in + n_out) ambisonics: the input passthrough channels
        followed by the predicted ones (a complete ACN layout); None on the
        ranks of a mesh other than rank 0."""
        g = self.geometry
        self._calls += 1
        with profiling.span("deploy.call", self._calls):
            mono, pred = self._predict_span(input_folder, deploy_start, deploy_duration)
            if crossfade:
                # second pass offset by half a window, Hann-blended
                half = DEPLOY_DURATION / 2.0
                mono2, pred2 = self._predict_span(input_folder, deploy_start + half,
                                                  deploy_duration)
            if pred is None:
                return None
            with profiling.span("deploy.join"):
                if crossfade:
                    win = np.hanning(g.snd_dur)[:, None]
                    t = min(pred.shape[0], pred2.shape[0] + g.snd_dur // 2)
                    h1 = np.tile(win, (pred.shape[0] // g.snd_dur, 1))[:t]
                    blended = pred[:t] * h1
                    weight = h1.copy()
                    off = g.snd_dur // 2
                    h2 = np.tile(win, (pred2.shape[0] // g.snd_dur, 1))
                    n2 = min(pred2.shape[0], t - off)
                    blended[off: off + n2] += pred2[:n2] * h2[:n2]
                    weight[off: off + n2] += h2[:n2]
                    pred = blended / np.maximum(weight, 1e-3)
                    mono = mono[:t]
                return np.concatenate([mono, pred], axis=1)
