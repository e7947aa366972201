"""Streaming serve CLI of the PyTorch port: the flags of
spatialaudiogen_tpu.cli.serve, plus --device.

Reads INPUT_WAV's first channel in 0.1 s blocks (plus 10 fps frames from
--frames_dir for video models), pushes them through StreamingMonoToAmbix,
and writes the FOA output wav. `--realtime` paces the pushes at wall-clock
rate and reports whether serving kept up; without it the stream is pushed
as fast as the card drains it. Per-window serve latency stats print either
way.

    python -m spatialaudiogen_tpu_torch.cli.serve MODEL_DIR input.wav output.wav \
        [--frames_dir D] [--flow_dir D] [--realtime] [--compute_dtype bfloat16] \
        [--device cuda]

The predictions are bit for bit those of `cli.deploy --batch_size 1
--rgb_frames` over the same samples (before the PCM16 wav rounding).

Multi-session serving: pass comma-separated input/output lists and the
sessions are multiplexed through ONE StreamBatcher: one batched forward
per 0.1 s tick for all of them. Video models list one frames dir per
input (lanes then share batch statistics exactly like batch deploy,
deploy/stream.py):

    python -m spatialaudiogen_tpu_torch.cli.serve MODEL_DIR a.wav,b.wav oa.wav,ob.wav \
        [--frames_dir d1,d2]

A frames dir is a folder of 10 fps jpgs, or a clip folder packed by
data/packed.py (its decoded frames), as deploy reads either. --n_data > 1
(multi-device serving) is parsed and refused with NotImplementedError.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from spatialaudiogen_tpu_torch.config import FLOW, VIDEO


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("model_dir")
    parser.add_argument("input_wav", help="Mono (or first-channel) source.")
    parser.add_argument("output_wav")
    parser.add_argument("--frames_dir", default=None,
                        help="10 fps jpg frames dir, or a packed clip folder "
                             "(video models).")
    parser.add_argument("--flow_dir", default=None,
                        help="10 fps compressed-flow jpg dir incl. "
                             "flow_limits.npy (flow models; single-session "
                             "serving only).")
    parser.add_argument("--realtime", action="store_true",
                        help="Pace pushes at wall-clock rate instead of "
                             "as-fast-as-possible.")
    parser.add_argument("--compute_dtype", default=None,
                        choices=["float32", "bfloat16"])
    parser.add_argument("--n_data", type=int, default=None,
                        help="Shard the batched tick over N devices (one so far).")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda).")
    return parser.parse_args(argv)


def refuse_unported(args) -> None:
    """NotImplementedError for the flags whose paths are not ported yet."""
    if args.n_data is not None and args.n_data > 1:
        raise NotImplementedError("--n_data > 1 (multi-device serving) is not ported "
                                  "yet; see ROADMAP.md, 'Modules to port', item 14b")


def _frame_reader(path: str):
    """Lazy 10 fps uint8 RGB frames from a jpg dir or a packed clip folder."""
    from spatialaudiogen_tpu_torch.data.packed import PackedVideoReader, is_packed
    from spatialaudiogen_tpu_torch.data.readers import VideoFrameReader

    if is_packed(path):
        return PackedVideoReader(path, rate=PackedVideoReader.RAW_RATE,
                                 img_prep=lambda x: x)
    return VideoFrameReader(path, rate=VideoFrameReader.RAW_RATE, img_prep=lambda x: x)


def _load_mono(fn: str, rate: int) -> np.ndarray:
    from spatialaudiogen_tpu_torch.utils.io_audio import load_wav

    data, _ = load_wav(fn, rate, dtype=np.float32)
    return data if data.ndim == 1 else data[:, 0]


def _summary(lat: list, realtime: bool, what: str) -> str:
    lat_ms = np.array(lat) * 1e3
    p90 = np.percentile(lat_ms, 90)
    return (f"{what} median {np.median(lat_ms):.1f} ms / p90 {p90:.1f} ms"
            + (f"; kept_up={bool(p90 < 100.0)}" if realtime else ""))


def _pace(realtime: bool, t_start: float, end_sample: int, rate: float) -> None:
    """Under --realtime, wait until a live source would have captured the
    block ending at `end_sample`: pacing at the block's START would hand
    the model its last 0.1 s early and flatter the kept_up verdict."""
    if realtime:
        delay = t_start + end_sample / rate - time.perf_counter()
        if delay > 0:
            time.sleep(delay)


def main(argv=None) -> dict:
    """Serve, write the output wav(s) and print the summary. Returns
    {"served_s", "wall_s", "latency_s"}: FOA seconds written (summed over
    sessions), the wall seconds, and the latency of each push (single
    session) or tick (batched) that ran a forward."""
    args = parse_arguments(argv)
    refuse_unported(args)
    inputs = args.input_wav.split(",")
    outputs = args.output_wav.split(",")
    assert len(inputs) == len(outputs), \
        f"{len(inputs)} inputs vs {len(outputs)} outputs"
    if len(inputs) > 1:
        return _serve_batched(args, inputs, outputs)

    from spatialaudiogen_tpu_torch.deploy.stream import StreamingMonoToAmbix
    from spatialaudiogen_tpu_torch.utils.io_audio import save_wav

    stream = StreamingMonoToAmbix(args.model_dir, compute_dtype=args.compute_dtype,
                                  device=args.device)
    rate = stream.cfg.audio_rate
    block = stream.geometry.snd_dur  # one 0.1 s push per frame period
    mono = _load_mono(args.input_wav, rate)

    # frames decode lazily, one per pushed block: a long input must not sit
    # fully decoded in RAM (an hour of 224x448 would be ~11 GB)
    frame_reader = None
    if VIDEO in stream.cfg.encoders:
        assert args.frames_dir, "video model: pass --frames_dir"
        frame_reader = _frame_reader(args.frames_dir)
    flow_reader = None
    if FLOW in stream.cfg.encoders:
        assert args.flow_dir, "flow model: pass --flow_dir"
        from spatialaudiogen_tpu_torch.data.readers import FlowFrameReader, VideoFrameReader

        flow_reader = FlowFrameReader(
            args.flow_dir, os.path.join(args.flow_dir, "flow_limits.npy"),
            rate=VideoFrameReader.RAW_RATE)

    chunks, lat = [], []
    t_start = time.perf_counter()
    for k in range(0, len(mono), block):
        _pace(args.realtime, t_start, min(k + block, len(mono)), rate)
        frame = flow = None
        if frame_reader is not None:
            frame = frame_reader.get_by_index((k // block) / 10.0, 1)[0]
        if flow_reader is not None:
            flow = flow_reader.get_by_index((k // block) / 10.0, 1)[0]
        t0 = time.perf_counter()
        out = stream.push(mono[k: k + block], frame, flow)
        if out:
            lat.append(time.perf_counter() - t0)
            chunks.extend(out)
    # end of stream: emit the windows still waiting on future context
    # (zero-padded exactly like batch deploy past clip end)
    chunks.extend(stream.flush())

    assert chunks, "input shorter than one serving window (need > 0.6 s)"
    foa = np.concatenate(chunks, axis=0)
    save_wav(args.output_wav, foa, rate)
    served = foa.shape[0] / rate
    wall = time.perf_counter() - t_start
    print(f"served {served:.1f} s of FOA in {wall:.1f} s ({served / wall:.1f}x realtime); "
          + _summary(lat, args.realtime, "per-window serve latency"))
    print(f"wrote {args.output_wav} ({foa.shape[0]} frames x "
          f"{foa.shape[1]} ch @ {rate} Hz)")
    return {"served_s": served, "wall_s": wall, "latency_s": lat}


def _serve_batched(args, inputs: list, outputs: list) -> dict:
    """N sessions through one StreamBatcher: one batched forward per tick.
    Sessions whose input ends early are flushed and leave their lane; the
    remaining sessions keep ticking."""
    from spatialaudiogen_tpu_torch.deploy.stream import StreamBatcher
    from spatialaudiogen_tpu_torch.utils.io_audio import save_wav

    batcher = StreamBatcher(args.model_dir, capacity=len(inputs),
                            compute_dtype=args.compute_dtype, device=args.device)
    rate = batcher.cfg.audio_rate
    block = batcher.geometry.snd_dur

    # per-session frame readers for video models: --frames_dir lists one
    # frames dir per input, comma-separated like the wav lists; frames
    # decode lazily, one per pushed block. Video lanes share batch
    # statistics exactly like the batch deploy couples windows
    # (deploy/stream.py).
    frame_readers = None
    if VIDEO in batcher.cfg.encoders:
        assert args.frames_dir, \
            "video model: pass --frames_dir d1,d2,... (one dir per input)"
        dirs = args.frames_dir.split(",")
        assert len(dirs) == len(inputs), \
            f"{len(dirs)} frame dirs vs {len(inputs)} inputs"
        frame_readers = [_frame_reader(d) for d in dirs]

    monos = [_load_mono(fn, rate) for fn in inputs]
    sids = [batcher.add_session() for _ in monos]
    out_chunks = {sid: [] for sid in sids}

    def collect(result):
        for sid, chunks in result.items():
            out_chunks[sid].extend(chunks)

    lat = []
    live = set(sids)
    longest = max(map(len, monos))
    t_start = time.perf_counter()
    for k in range(0, longest, block):
        _pace(args.realtime, t_start, min(k + block, longest), rate)
        for i, sid in enumerate(sids):
            if sid in live and k < len(monos[i]):
                frame = None
                if frame_readers is not None:
                    frame = frame_readers[i].get_by_index((k // block) / 10.0, 1)[0]
                batcher.push(sid, monos[i][k: k + block], frame)
        t0 = time.perf_counter()
        res = batcher.tick()
        if any(res.values()):
            # only ticks that ran a forward count toward the latency stats
            # (ticks with no ready window return at once and would flatter
            # the median and the kept_up verdict)
            lat.append(time.perf_counter() - t0)
        collect(res)
        for i, sid in enumerate(sids):
            if sid in live and k + block >= len(monos[i]):
                collect(batcher.flush(sid))  # end of this session's input
                batcher.remove_session(sid)
                live.discard(sid)
    for sid in list(live):
        collect(batcher.flush(sid))

    wall = time.perf_counter() - t_start
    total_served = 0.0
    for i, (sid, out_fn) in enumerate(zip(sids, outputs)):
        assert out_chunks[sid], f"input {inputs[i]} shorter than one window"
        foa = np.concatenate(out_chunks[sid], axis=0)
        save_wav(out_fn, foa, rate)
        total_served += foa.shape[0] / rate
        print(f"wrote {out_fn} ({foa.shape[0]} frames x {foa.shape[1]} ch)")
    print(f"served {len(inputs)} sessions, {total_served:.1f} s of FOA total "
          f"in {wall:.1f} s ({total_served / wall:.1f}x realtime aggregate); "
          + _summary(lat, args.realtime, "per-tick latency"))
    return {"served_s": total_served, "wall_s": wall, "latency_s": lat}


if __name__ == "__main__":
    main()
