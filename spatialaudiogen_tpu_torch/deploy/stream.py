"""Streaming mono->FOA serving (port of spatialaudiogen_tpu.deploy.stream):
incremental windows with fixed latency.

The batch engine (deploy.MonoToAmbix) needs the whole clip on disk; this
wraps the same forward in a push API for live sources: feed mono samples
(and 10 fps frames for video models) as they arrive, and each 0.1 s FOA
chunk is emitted as soon as its input window is complete. One window is a
batch-1 span with rel=[0].

Latency model (48 kHz, context 1.0 s, duration 0.1 s):
  * algorithmic: the window for output [t, t+0.1) spans [t-0.5, t+0.6)
    (geometry.chunk_start_sample), so the model needs 0.5 s of future
    context beyond the emitted chunk's end: inherent to the reference
    architecture, not to this wrapper;
  * compute: one batch-1 forward plus the copies to and from the card.

Exactness: the emitted stream is bit for bit MonoToAmbix(batch_size=1,
yuv_frames=False).deploy() over the same samples: the same fwd_span call
at the same shapes (fwd_windows for flow configs), the same window
arithmetic and the same fetch dtype. Batch-1 serving sidesteps the
batch-statistics BatchNorm quirk: each window sees only itself.

Multi-session serving: StreamBatcher multiplexes up to `capacity` sessions
into one batched forward per tick. Each session owns a lane of a
(capacity, snd_size) float32 rolling context that lives on the card, so a
tick ships only the new 0.1 s of audio per session (the other 10/11 of the
window is already there).
"""

from __future__ import annotations

import numpy as np
import torch

from spatialaudiogen_tpu_torch.config import FLOW, VIDEO
from spatialaudiogen_tpu_torch.data.readers import raw_frame_indices
from spatialaudiogen_tpu_torch.deploy.deploy import MonoToAmbix, deterministic_cudnn, video_input
from spatialaudiogen_tpu_torch.parallel.mesh import gather_rows
from spatialaudiogen_tpu_torch.utils import profiling

FRAMES_FPS = 10.0  # the frames/ layout raw rate (preprocess.py:98-143)


class _SessionState:
    """Host-side bookkeeping for one streaming session: sample/frame
    buffers, window readiness, frame pairing with drop substitution, and
    bounded-memory gc. No device work: StreamingMonoToAmbix couples one of
    these to a batch-1 engine; StreamBatcher couples many to one batched
    engine."""

    def __init__(self, cfg, geometry):
        self.cfg = cfg
        self.geometry = geometry
        g = geometry
        rate = cfg.audio_rate
        self._needs_video = VIDEO in cfg.encoders
        self._needs_flow = FLOW in cfg.encoders
        # window k emits [t_k, t_k + duration), t_k = context/2 + k*duration
        self._chunk_t = lambda k: cfg.context / 2.0 + k * g.snd_dur / rate
        self._buf = np.zeros((0,), np.float32)   # mono samples
        self._buf_start = 0                      # absolute index of _buf[0]
        self._pushed = 0                         # samples incl. flush padding
        self._pushed_real = 0                    # caller-pushed samples only
        self._frames: dict[int, np.ndarray] = {}
        self._frames_pushed = 0
        # flow frames stream at the same 10 fps cadence as video frames and
        # share the pairing/substitution policy
        self._flows: dict[int, np.ndarray] = {}
        self._flows_pushed = 0
        self.next_window = 0
        # live sources drop frames: once the audio runs `frame_patience_s`
        # past a missing frame's due time, the latest available frame is
        # substituted (the standard repeat-last-frame policy) instead of
        # stalling the stream forever; substitutions are counted per
        # modality (video/flow) so a video+flow session's monitoring can
        # tell which stream dropped; `frames_substituted` is the aggregate.
        self.frame_patience_s = 0.3
        self.video_frames_substituted = 0
        self.flow_frames_substituted = 0

    @property
    def frames_substituted(self) -> int:
        """Total substitutions across modalities (back-compat aggregate)."""
        return self.video_frames_substituted + self.flow_frames_substituted

    # --- input side ---------------------------------------------------
    def push(self, samples: np.ndarray | None, frame: np.ndarray | None,
             flow: np.ndarray | None = None):
        if samples is not None and len(samples) > 0:
            s = np.asarray(samples, np.float32).reshape(-1)
            self._buf = np.concatenate([self._buf, s])
            self._pushed += len(s)
            self._pushed_real += len(s)
        if frame is not None:
            assert self._needs_video, "model without video encoder given a frame"
            assert frame.dtype == np.uint8, "frames stream as uint8"
            # (H, W, 3) RGB or (H*3/2, W) raw I420 planes: the device
            # conversion picks the branch by rank; a session must not mix
            # the two. Flow configs assemble windows on the host (the
            # host-assembly forward, like batch deploy's flow path): RGB only.
            assert frame.ndim in (2, 3), frame.shape
            assert frame.ndim == 3 or not self._needs_flow, \
                "flow configs take RGB frames (host assembly), not I420"
            if self._frames:
                assert frame.ndim == next(iter(self._frames.values())).ndim, \
                    "mixed RGB/I420 frames within one session"
            self._frames[self._frames_pushed] = frame
            self._frames_pushed += 1
        if flow is not None:
            assert self._needs_flow, "model without flow encoder given flow"
            # (H, W, 3) float (dx, dy, mag) as the model consumes it
            # (FlowFrameReader semantics, reference feeder.py:147-161), or
            # (H, W, 2) raw (dx, dy) from a live flow estimator, the
            # magnitude channel derived here
            f = np.asarray(flow, np.float32)
            assert f.ndim == 3 and f.shape[-1] in (2, 3), f.shape
            if f.shape[-1] == 2:
                f = np.concatenate(
                    [f, np.hypot(f[..., :1], f[..., 1:2])], axis=-1)
            self._flows[self._flows_pushed] = f
            self._flows_pushed += 1

    # --- window readiness ----------------------------------------------
    def start_sample(self, k: int) -> int:
        return self.geometry.chunk_start_sample(self._chunk_t(k))

    def window_ready(self, k: int) -> bool:
        g = self.geometry
        if self._pushed < self.start_sample(k) + g.snd_size:
            return False
        for store in self._frame_stores():
            for i in self._frame_indices(k):
                if i in store:
                    continue
                # frame i is due at audio time i/10 s; substitute once the
                # audio cadence has run frame_patience_s past it (liveness
                # over exactness for dropped frames), else wait
                due = (i / FRAMES_FPS + self.frame_patience_s) * self.cfg.audio_rate
                if self._pushed < due or not store:
                    return False
        return True

    def _frame_stores(self) -> list:
        """The per-modality 10 fps frame dicts this config streams (video
        and/or flow): readiness, substitution and gc treat them alike."""
        return ([self._frames] if self._needs_video else []) + \
               ([self._flows] if self._needs_flow else [])

    def next_ready(self) -> bool:
        return self.window_ready(self.next_window)

    def _frame_indices(self, k: int) -> list:
        # VideoFrameReader.frame_indices for an unbounded stream: no
        # clamping against a known frame count (live sources grow)
        t = self._chunk_t(k)
        return raw_frame_indices(t, FRAMES_FPS, self.cfg.video_rate,
                                 self.geometry.vid_dur, num_frames=1 << 62)

    # --- window contents -------------------------------------------------
    def window_samples(self, k: int) -> np.ndarray:
        """(snd_size,) float32 input window of window k."""
        g = self.geometry
        lo = self.start_sample(k) - self._buf_start
        return self._buf[lo: lo + g.snd_size]

    def window_mono(self, k: int) -> np.ndarray:
        """(snd_dur, 1) mono W passthrough of window k."""
        g = self.geometry
        w = self.window_samples(k)
        return w[g.nosep_ss: g.nosep_ss + g.snd_dur, None].astype(np.float32)

    def window_frames(self, k: int) -> np.ndarray | None:
        """(T, H, W, 3) RGB or (T, H*3/2, W) I420 uint8 frames of window k
        (None for audio-only), whichever form the session pushes."""
        if not self._needs_video:
            return None
        return self._stack_window(self._frames, k)

    def window_flow(self, k: int) -> np.ndarray | None:
        """(T, H, W, 3) float32 (dx, dy, mag) flow of window k (None unless
        the config has a flow encoder)."""
        if not self._needs_flow:
            return None
        return self._stack_window(self._flows, k)

    def _stack_window(self, store: dict, k: int) -> np.ndarray:
        counter = ("video_frames_substituted" if store is self._frames
                   else "flow_frames_substituted")
        frames = []
        for i in self._frame_indices(k):
            if i not in store:  # dropped frame: repeat the latest
                setattr(self, counter, getattr(self, counter) + 1)
                i = max(store)
            frames.append(store[i])
        return np.stack(frames, 0)

    def advance(self):
        self.next_window += 1
        self._gc()

    # --- end of stream ---------------------------------------------------
    def flush_pending(self) -> bool:
        """True while a window whose OUTPUT lies within the real pushed
        audio has not emitted yet."""
        g = self.geometry
        return (self.start_sample(self.next_window) + g.nosep_ss
                < self._pushed_real)

    def pad_for_flush(self):
        """Zero-pad the future context (and repeat the last frame) so the
        next pending window becomes ready; padding never counts as real
        input, keeping flush idempotent at end of stream."""
        g = self.geometry
        self._buf = np.concatenate([self._buf, np.zeros(g.snd_dur, np.float32)])
        self._pushed += g.snd_dur
        if self._needs_video and self._frames:
            self._frames[self._frames_pushed] = self._frames[max(self._frames)]
            self._frames_pushed += 1
        if self._needs_flow and self._flows:
            self._flows[self._flows_pushed] = self._flows[max(self._flows)]
            self._flows_pushed += 1

    def _gc(self):
        """Drop consumed history: samples/frames earlier than the next
        window's reach (bounded memory for unbounded streams)."""
        g = self.geometry
        keep_from = self.start_sample(self.next_window)
        drop = keep_from - self._buf_start
        if drop > 4 * g.snd_size:  # amortize the copy
            self._buf = self._buf[drop:].copy()
            self._buf_start += drop
        for store in self._frame_stores():
            if not store:
                continue
            # keep the newest frame even when it is older than the next
            # window's range: it is the substitution source for dropped
            # frames (a gc that removed it would stall the stream)
            first_needed = min(self._frame_indices(self.next_window)[0],
                               max(store))
            for i in [i for i in store if i < first_needed]:
                del store[i]


def _fetch(out: torch.Tensor, f16: bool) -> np.ndarray:
    """Predictions to the host as float32, copied back as float16 when
    `f16` (the deploy engine's f16_fetch transport)."""
    if f16:
        out = out.half()
    return out.cpu().numpy().astype(np.float32)


class StreamingMonoToAmbix:
    """Push-based wrapper over the batch-1 deploy forward.

    Usage:
        stream = StreamingMonoToAmbix(model_dir)
        for block, frame in source:            # any block sizes; frames at
            for foa in stream.push(block, frame):   # video_rate if needed
                sink(foa)                       # (snd_dur, 4) W+YZX chunks

    Video models: push frames in display order at the frames-layout raw
    rate (10 fps: one frame per 0.1 s of audio), starting at t=0; the
    engine then pairs frames with windows exactly like
    VideoFrameReader.frame_indices (subsampling when the model's
    video_rate is below 10).
    """

    def __init__(self, model_dir: str, compute_dtype: str | None = None,
                 f16_fetch: bool = True, device: str = "cuda"):
        # f16_fetch halves the prediction copy-back (see MonoToAmbix).
        # Flow-encoder configs ignore it: their windows run the
        # host-assembly forward (engine.fwd_windows), which, like batch
        # deploy's flow route (_predict_span_host), always fetches float32;
        # that shared path is what makes the flow stream bit for bit
        # MonoToAmbix(batch_size=1).deploy().
        self.engine = MonoToAmbix(model_dir, batch_size=1, device=device,
                                  compute_dtype=compute_dtype,
                                  yuv_frames=False, f16_fetch=f16_fetch)
        self.cfg = self.engine.cfg
        self.geometry = self.engine.geometry
        # deploy's (B-1)*snd_dur + snd_size + 16 at B=1: the same span shape
        self._span_len = self.geometry.snd_size + 16
        self._session = _SessionState(self.cfg, self.geometry)

    # back-compat introspection used by tests/soaks
    @property
    def frames_substituted(self) -> int:
        return self._session.frames_substituted

    @property
    def video_frames_substituted(self) -> int:
        return self._session.video_frames_substituted

    @property
    def flow_frames_substituted(self) -> int:
        return self._session.flow_frames_substituted

    @property
    def frame_patience_s(self) -> float:
        return self._session.frame_patience_s

    @frame_patience_s.setter
    def frame_patience_s(self, v: float):
        self._session.frame_patience_s = v

    def push(self, samples: np.ndarray | None = None,
             frame: np.ndarray | None = None,
             flow: np.ndarray | None = None) -> list:
        """Feed new mono samples and/or one video/flow frame; returns the
        list of (snd_dur, num_ambi_channels) float32 FOA chunks that became
        computable (possibly empty, possibly several after a large block).

        samples: 1-D float32 mono (any length, including 0).
        frame: (H, W, 3) uint8 RGB, or (H*3/2, W) raw I420 planes (half the
        frame bytes, for sources that produce 4:2:0 natively), at the
        training resolution; push one per 0.1 s of audio (the 10 fps
        frames-layout rate), starting at t=0.
        flow (flow-encoder configs): (H, W, 3) float32 (dx, dy, mag) as the
        model consumes it, or (H, W, 2) raw (dx, dy) from a live flow
        estimator (magnitude derived); same 10 fps cadence as frames.
        """
        self._session.push(samples, frame, flow)
        return self._drain()

    def _drain(self) -> list:
        out = []
        while self._session.next_ready():
            out.append(self._run_window(self._session.next_window))
            self._session.advance()
        return out

    def _run_window(self, k: int) -> np.ndarray:
        g = self.geometry
        s = self._session
        eng = self.engine
        if s._needs_flow:
            # batch deploy's host-assembly route (_predict_span_host):
            # per-window float arrays into engine.fwd_windows
            audio = s.window_samples(k).astype(np.float32)[None, :, None]
            video = s.window_frames(k)
            if video is not None:
                # img_prep_default's f32 arithmetic: cast to f32 FIRST, then
                # /255 - 0.5, as the deploy reader does (f64-then-cast
                # differs by 1 ulp for pixel values 64-191)
                video = (video.astype(np.float32) / 255.0 - 0.5)[None]
            flow = s.window_flow(k)[None]
            pred = _fetch(eng.fwd_windows(audio, video, flow), False)
        else:
            span = np.zeros((self._span_len, 1), np.float32)
            span[: g.snd_size, 0] = s.window_samples(k)
            rel = np.zeros((1,), np.int64)  # lane 0 valid (rel >= 0)
            frames = s.window_frames(k)
            video_u8 = None if frames is None else frames[None]  # (1, T, H, W, 3)
            out = eng.fwd_span(eng._upload(span), eng._upload(rel), eng._upload(video_u8))
            pred = _fetch(out, eng.f16_fetch)
        return np.concatenate([s.window_mono(k), pred.reshape(g.snd_dur, -1)], axis=1)

    def flush(self) -> list:
        """End of stream: zero-pad the future context so every window whose
        OUTPUT lies within the pushed audio still emits (the batch engine
        zero-pads past clip end the same way, audio_window_bounds). Video
        models repeat the last pushed frame. Returns the remaining chunks.
        """
        s = self._session
        assert not (s.flush_pending() and s._needs_video and not s._frames), \
            "flush() of a video model needs at least one pushed frame"
        assert not (s.flush_pending() and s._needs_flow and not s._flows), \
            "flush() of a flow model needs at least one pushed flow frame"
        out = []
        while s.flush_pending():
            s.pad_for_flush()
            out += self._drain()
        return out

    @property
    def algorithmic_latency_s(self) -> float:
        """Seconds of future input required past an emitted chunk's end."""
        g = self.geometry
        s = self._session
        need = s.start_sample(0) + g.snd_size
        end = s.start_sample(0) + g.nosep_ss + g.snd_dur
        return (need - end) / self.cfg.audio_rate


class StreamBatcher:
    """Multiplex up to `capacity` streaming sessions into ONE batched
    forward per tick: the reference's deploy batching idea (deploy.py:
    112-148) applied across sessions instead of across one clip's windows.

    Each session owns a lane of a (capacity, snd_size) float32 rolling
    context on the card. Consecutive windows of a session overlap by 10/11,
    so a tick ships only the new snd_dur samples per emitting lane and the
    buffer rolls on the card before the forward: one upload of chunks and
    masks (plus frames), one forward, one float16 fetch per round, whatever
    the session count. Sessions join and leave between ticks; joining
    uploads the lane's first full window once.

    Parity: for audio-only models every lane is independent (the audio
    path's BatchNorm uses running averages at eval), so a lane's output is
    bit for bit the same whatever its neighbours hold. For video models the
    reference's batch-statistics BatchNorm quirk couples lanes exactly like
    the batch deploy engine couples windows: batched serving then matches
    MonoToAmbix's batch semantics, NOT N isolated batch-1 streams.

    With a `mesh` (parallel.mesh, n_model = 1) the lanes split over the
    data ranks in contiguous blocks, as the JAX batcher shards its lane
    axis: every rank keeps the same sessions and bookkeeping, holds its
    block of the rolling context on its card, ships only its lanes'
    chunks, masks and frames each tick, and rank 0 gathers the
    predictions; tick() and flush() return the chunks on rank 0 and
    nothing on the others. capacity must divide over the ranks.

    Spans (utils.profiling): `serve.push` per push() (id = the round it
    feeds); per round `serve.tick` (id = the round) holding
    `serve.assemble` (the emitting sessions' chunks and masks),
    `serve.stage` (the frames), `serve.upload`, `serve.forward` and
    `serve.fetch` (the predictions to the host, which waits for the card).
    Counters: `serve.rounds`, `serve.lanes_emitting` and `serve.h2d_bytes`
    (this rank's bytes handed to the device).
    """

    def __init__(self, model_dir: str, capacity: int = 16,
                 compute_dtype: str | None = None, f16_fetch: bool = True,
                 device: str = "cuda", mesh=None):
        if mesh is not None and capacity % mesh.n_data:
            raise ValueError(f"capacity {capacity} must divide over {mesh.n_data} data "
                             f"ranks")
        self.engine = MonoToAmbix(model_dir, batch_size=capacity, device=device,
                                  compute_dtype=compute_dtype,
                                  yuv_frames=False, f16_fetch=f16_fetch, mesh=mesh)
        self.mesh = self.engine.mesh
        self._lanes = self.engine._rows      # this rank's lanes
        self.cfg = self.engine.cfg
        self.geometry = self.engine.geometry
        self.capacity = capacity
        self._needs_video = VIDEO in self.cfg.encoders
        assert FLOW not in self.cfg.encoders, \
            "batched serving of flow configs is not wired (flow windows " \
            "are float host-assembled arrays, deploy.py " \
            "_predict_span_host); serve them via StreamingMonoToAmbix"
        self._sessions: dict[int, _SessionState] = {}
        self._lane_of: dict[int, int] = {}
        self._warm: dict[int, bool] = {}   # lane buffer holds a valid window
        self._consumed: dict[int, int] = {}  # absolute sample index shipped
        self._next_sid = 0
        self._round = 0                     # rounds run: the next round's span id
        self._free_lanes = list(range(capacity))
        n_local = self._lanes.stop - self._lanes.start
        self._buf = torch.zeros((n_local, self.geometry.snd_size), dtype=torch.float32,
                                device=self.engine.device)

    def _local_row(self, lane: int) -> int | None:
        """The row of `lane` in this rank's block, None when another owns it."""
        lo, hi = self._lanes.start, self._lanes.stop
        return lane - lo if lo <= lane < hi else None

    def _set_lane(self, lane: int, window: np.ndarray):
        """Copy one (snd_size,) window into its lane's row on the card (on
        the rank that owns the lane)."""
        row = self._local_row(lane)
        if row is not None:
            window = np.ascontiguousarray(window, dtype=np.float32)
            profiling.count("serve.h2d_bytes", window.nbytes)
            self._buf[row].copy_(self.engine._upload(window))

    # --- session management -------------------------------------------
    def add_session(self) -> int:
        assert self._free_lanes, f"at capacity ({self.capacity} sessions)"
        sid = self._next_sid
        self._next_sid += 1
        lane = self._free_lanes.pop(0)
        self._sessions[sid] = _SessionState(self.cfg, self.geometry)
        self._lane_of[sid] = lane
        self._warm[sid] = False
        self._consumed[sid] = 0
        return sid

    def remove_session(self, sid: int):
        lane = self._lane_of.pop(sid)
        del self._sessions[sid], self._warm[sid], self._consumed[sid]
        self._free_lanes.append(lane)
        # zero the stale lane so video-model batch statistics see the same
        # zeros an empty deploy pad lane would contribute
        row = self._local_row(lane)
        if row is not None:
            self._buf[row].zero_()

    @property
    def n_sessions(self) -> int:
        return len(self._sessions)

    def push(self, sid: int, samples: np.ndarray | None = None,
             frame: np.ndarray | None = None):
        """Buffer input for session `sid`; compute happens at tick()."""
        with profiling.span("serve.push", self._round):
            self._sessions[sid].push(samples, frame)

    # --- the batched tick ------------------------------------------------
    @torch.no_grad()
    @deterministic_cudnn()
    def _tick_fn(self, chunk: np.ndarray, do_shift: np.ndarray, valid: np.ndarray,
                 video_u8: torch.Tensor | None) -> np.ndarray | None:
        """Roll the emitting lanes by snd_dur and run the batched forward;
        -> the (capacity, snd_dur, n_out) predictions on the host of rank 0
        (None on the other ranks of a mesh).

        chunk (C, snd_dur) f32 new samples (zeros for non-shifting lanes);
        do_shift/valid (C,) f32 masks; video_u8 the frames _stage_frames
        staged, or None; C is this rank's lanes. Non-emitting lanes are
        zeroed into the forward: the batch deploy's pad-lane convention.
        cuDNN runs deterministic
        algorithms, as in the deploy forward. The chunk and masks go up
        through engine._upload, which pins a fresh host buffer per call;
        the frames' buffer comes from the same caching host allocator. It
        hands a block out again only once the block's non-blocking copy has
        finished, so the next tick cannot overwrite data still in flight.
        """
        g = self.geometry
        eng = self.engine
        dtype = next(eng.model.parameters()).dtype   # float32 unless .double()d
        with profiling.span("serve.upload"):
            profiling.count("serve.h2d_bytes", sum(
                x.nbytes for x in (chunk, do_shift, valid, video_u8) if x is not None))
            chunk_d, shift_d, valid_d = (eng._upload(x) for x in (chunk, do_shift, valid))
            if video_u8 is not None:
                video_u8 = video_u8.to(eng.device, non_blocking=True)
        with profiling.span("serve.forward"):
            shifted = torch.cat([self._buf[:, g.snd_dur:], chunk_d], dim=1)
            self._buf = torch.where(shift_d[:, None] > 0, shifted, self._buf)
            valid_d = valid_d.to(dtype)
            audio = (self._buf.to(dtype) * valid_d[:, None])[..., None]  # (C, snd_size, 1)
            video = video_input(video_u8, valid_d, dtype)
            out = eng.model(audio, video)
        with profiling.span("serve.fetch"):
            host = gather_rows(out.half() if eng.f16_fetch else out, self.mesh)
            return None if host is None else host.numpy().astype(np.float32)

    def _stage_frames(self, lane_frames: dict) -> torch.Tensor:
        """One tick's (capacity, ...) uint8 frames in host memory a copy to
        the card can start from: pinned on the card's route, from the
        caching host allocator, whose blocks stay mapped from tick to tick
        (a fresh 38.5 MB numpy array at capacity 128 faults in every page,
        about 30 ms a tick on an H100 host: PERF.md). Lanes that
        do not emit are zero. The frame form is whatever the sessions push,
        (T, H, W, 3) RGB or (T, H*3/2, W) I420 planes (video_input branches
        on the rank); one batcher must see ONE form (mixed lanes cannot
        stack). Only this rank's lanes are staged."""
        shapes = {f.shape for f in lane_frames.values()}
        assert len(shapes) == 1, f"mixed frame forms across sessions: {shapes}"
        lanes = range(self._lanes.start, self._lanes.stop)
        staging = torch.empty((len(lanes),) + shapes.pop(), dtype=torch.uint8,
                              pin_memory=self.engine.device.type == "cuda")
        frames = staging.numpy()
        for row, lane in enumerate(lanes):
            frames[row] = lane_frames.get(lane, 0)
        return staging

    def tick(self, max_rounds: int | None = None) -> dict:
        """Run batched forwards until no session has a ready window (or
        max_rounds). Returns {sid: [(snd_dur, 1+n_out) chunks...]} for
        sessions that emitted (rank 0 of a mesh; {} on the others)."""
        out: dict[int, list] = {}
        rounds = 0
        while max_rounds is None or rounds < max_rounds:
            emitting = [(sid, s) for sid, s in self._sessions.items()
                        if s.next_ready()]
            if not emitting:
                break
            rounds += 1
            with profiling.span("serve.tick", self._round):
                self._round += 1
                host, metas = self._run_round(emitting)
            if host is None:      # not rank 0 of a mesh
                continue
            for sid, lane, mono in metas:
                chunkout = np.concatenate([mono, host[lane]], axis=1)
                out.setdefault(sid, []).append(chunkout)
        return out

    def _run_round(self, emitting: list):
        """One batched round over the emitting sessions -> (the
        predictions on the host, None off rank 0; [(sid, lane, mono)])."""
        g = self.geometry
        profiling.count("serve.rounds")
        profiling.count("serve.lanes_emitting", len(emitting))
        with profiling.span("serve.assemble"):
            chunk = np.zeros((self.capacity, g.snd_dur), np.float32)
            do_shift = np.zeros((self.capacity,), np.float32)
            valid = np.zeros((self.capacity,), np.float32)
            lane_frames: dict[int, np.ndarray] = {}
            metas = []
            for sid, s in emitting:
                lane = self._lane_of[sid]
                k = s.next_window
                s0 = s.start_sample(k)
                if not self._warm[sid]:
                    # one-time full-window upload for a fresh lane
                    self._set_lane(lane, s.window_samples(k))
                    self._warm[sid] = True
                else:
                    # rolling update: ship only the new snd_dur samples
                    # [consumed, consumed + snd_dur); windows advance by
                    # exactly snd_dur (chunk_start_sample rounds k*0.1 s to
                    # the sample grid; exact for any realistic stream length)
                    assert s0 + g.snd_size == self._consumed[sid] + g.snd_dur, \
                        "window cadence drifted off snd_dur"
                    lo = self._consumed[sid] - s._buf_start
                    chunk[lane] = s._buf[lo: lo + g.snd_dur]
                    do_shift[lane] = 1.0
                valid[lane] = 1.0
                self._consumed[sid] = s0 + g.snd_size
                if self._needs_video:
                    lane_frames[lane] = s.window_frames(k)
                metas.append((sid, lane, s.window_mono(k)))
                s.advance()
        with profiling.span("serve.stage"):
            video_u8 = self._stage_frames(lane_frames) if self._needs_video else None
        lanes = self._lanes
        return self._tick_fn(chunk[lanes], do_shift[lanes], valid[lanes], video_u8), metas

    def flush(self, sid: int) -> dict:
        """End-of-stream for one session: pad its future context until all
        its real-audio windows emitted (other sessions may ride along in
        the same rounds). Returns the same {sid: chunks} dict as tick()."""
        s = self._sessions[sid]
        assert not (s.flush_pending() and s._needs_video and not s._frames), \
            "flush() of a video model needs at least one pushed frame"
        merged: dict[int, list] = {}
        while s.flush_pending():
            s.pad_for_flush()
            for k, v in self.tick().items():
                merged.setdefault(k, []).extend(v)
        return merged
