"""Dataset preprocessing: raw downloads -> the frames layout the feeder reads
(the port's copy of spatialaudiogen_tpu.etl.preprocess).

Parity with reference scraping/preprocess.py:
  * prepare_ambisonics: 48 kHz resample + codec-specific channel remap to
    ACN order — aac streams arrive [Y, Z, W, ?, X] permuted and need
    pan c0..c3 = c2,c1,c4,c0; vorbis/opus are already WYZX
    (preprocess.py:21-28)
  * prepare_video: ER crop/scale, or EAC -> equirect through generated
    PGM coordinate maps + ffmpeg `remap` (preprocess.py:37-95)
  * extract_frames: 1-second wavs + jpg frames (preprocess.py:98-143)
  * compute_audio_pow: "t rms" index every 0.1 s from t=0.5
    (preprocess.py:146-153)
  * compress_flow: float flow fields -> angle/magnitude jpgs +
    flow_limits.npy (the encoding FlowReader expects, preprocess.py:156-204;
    FlowNet2 inference itself stays an external model — any (T, H, W, 2)
    flow source can be ingested)
  * worker pool across processes (preprocess.py:234-285); flow on a torch
    device (--flow tpu) runs after the pool, serially in the parent

ffmpeg steps are built as command lists and run via run_system_cmd
(dry_run supported); the pure-python steps run anywhere.
"""

from __future__ import annotations

import multiprocessing as mp
import os

import numpy as np

from spatialaudiogen_tpu_torch.etl.projections import gen_eac2eqr_maps, save_pgm
from spatialaudiogen_tpu_torch.utils.cmd import run_system_cmd
from spatialaudiogen_tpu_torch.utils.io_audio import load_wav, save_wav

AAC_REMAP = (2, 1, 4, 0)
IDENTITY_REMAP = (0, 1, 2, 3)


def ambisonics_cmd(inp_fn: str, out_fn: str, inp_codec: str) -> list:
    if inp_codec == "aac":
        remap = AAC_REMAP
    elif inp_codec in ("vorbis", "opus"):
        remap = IDENTITY_REMAP
    else:
        raise ValueError(f"{inp_fn}: unknown input codec: {inp_codec}")
    pan = "pan=4c|" + "|".join(f"c{i}=c{c}" for i, c in enumerate(remap))
    return ["ffmpeg", "-y", "-i", inp_fn, "-vn", "-ar", "48000", "-af", pan, out_fn]


def prepare_ambisonics(inp_fn: str, out_fn: str, inp_codec: str,
                       overwrite: bool = False, dry_run: bool = False):
    if os.path.exists(out_fn) and not overwrite:
        return None
    cmd = ambisonics_cmd(inp_fn, out_fn, inp_codec)
    run_system_cmd(cmd, dry_run=dry_run)
    return cmd


def video_cmds(inp_fn: str, stereopsis: str, projection: str, out_fn: str,
               out_shape, out_rate: int, in_shape=None, pgm_dir: str = "pgms",
               write_pgms: bool = True) -> list:
    """ffmpeg command(s) for ER/EAC videos; generates remap PGMs for EAC
    (skipped when write_pgms is False — dry runs must not touch disk)."""
    cmds = []
    if projection == "ER":
        filters = []
        if stereopsis == "STEREO":
            filters.append("crop=in_w:in_h/2:0:0")
        filters.append(f"scale={out_shape[1]}:{out_shape[0]}")
        cmds.append(["ffmpeg", "-y", "-i", inp_fn, "-an", "-r", str(out_rate),
                     "-pix_fmt", "yuv420p", "-vf", ",".join(filters), out_fn])
    elif projection == "EAC":
        assert in_shape is not None, "EAC remap needs the input frame shape"
        height, width = in_shape
        # maps rendered at 2x then downscaled, like preprocess.py:56-60
        hi_shape = (out_shape[0] * 2, out_shape[1] * 2)
        tag = f"{height}x{width}_{hi_shape[0]}x{hi_shape[1]}_{stereopsis}"
        xmap_fn = os.path.join(pgm_dir, f"xmap_{tag}.pgm")
        ymap_fn = os.path.join(pgm_dir, f"ymap_{tag}.pgm")
        if write_pgms and not (os.path.isfile(xmap_fn) and os.path.isfile(ymap_fn)):
            os.makedirs(pgm_dir, exist_ok=True)
            xmap, ymap = gen_eac2eqr_maps((height, width), hi_shape, stereopsis)
            with open(xmap_fn, "w") as f:
                save_pgm(f, xmap.astype(np.uint16), 2 ** 16 - 1)
            with open(ymap_fn, "w") as f:
                save_pgm(f, ymap.astype(np.uint16), 2 ** 16 - 1)
        tmp_fn = out_fn + ".remap.mp4"
        cmds.append(["ffmpeg", "-y", "-i", inp_fn, "-i", xmap_fn, "-i", ymap_fn,
                     "-an", "-r", str(out_rate), "-lavfi", "remap", tmp_fn])
        cmds.append(["ffmpeg", "-y", "-i", tmp_fn, "-pix_fmt", "yuv420p",
                     "-vf", f"scale={out_shape[1]}:{out_shape[0]}", out_fn])
    else:
        raise ValueError(f"unknown projection: {projection}")
    return cmds


def prepare_video(inp_fn: str, stereopsis: str, projection: str, out_fn: str,
                  out_shape=(224, 448), out_rate: int = 10, in_shape=None,
                  overwrite: bool = False, dry_run: bool = False,
                  pgm_dir: str | None = None):
    if os.path.exists(out_fn) and not overwrite:
        return None
    if pgm_dir is None:
        # next to the prepared video, never cwd-relative
        pgm_dir = os.path.join(os.path.dirname(os.path.abspath(out_fn)), "pgms")
    cmds = video_cmds(inp_fn, stereopsis, projection, out_fn, out_shape,
                      out_rate, in_shape, pgm_dir, write_pgms=not dry_run)
    for cmd in cmds:
        run_system_cmd(cmd, dry_run=dry_run)
    return cmds


def extract_frames(audio_fn: str, video_fn: str | None, frames_dir: str,
                   rate: int = 48000, video_rate: float = 10.0):
    """Split a prepared 4-channel wav into 1 s chunks and a video into jpgs.

    Both streams are truncated to ``int(min(audio_dur, video_dur))`` seconds
    like the reference (scraping/preprocess.py:123-124 duration_secs =
    int(min(...))), so the on-disk layout matches for A/V-length-mismatched
    videos instead of the audio chunks outrunning the jpgs.
    """
    audio_dir = os.path.join(frames_dir, "ambix")
    os.makedirs(audio_dir, exist_ok=True)
    data, _ = load_wav(audio_fn, rate)
    n_secs = data.shape[0] // rate

    reader = None
    if video_fn is not None:
        from spatialaudiogen_tpu_torch.utils.io_video import BasicVideoReader

        reader = BasicVideoReader(video_fn, rate=video_rate)
        if reader.duration:
            n_secs = min(n_secs, int(reader.duration))

    for i in range(n_secs):
        save_wav(os.path.join(audio_dir, f"{i:06d}.wav"),
                 data[i * rate: (i + 1) * rate], rate)

    if reader is not None:
        from PIL import Image

        video_dir = os.path.join(frames_dir, "video")
        os.makedirs(video_dir, exist_ok=True)
        n_frames = int(video_rate * n_secs)
        for i in range(n_frames):
            frame = reader.get()
            if frame is None:
                break
            Image.fromarray(frame).save(os.path.join(video_dir, f"{i:06d}.jpg"),
                                        quality=92)
    return n_secs


def compute_audio_pow(frames_dir: str, rate: int = 48000):
    """Write audio_pow.lst: W-channel rms per 0.1 s window from t=0.5."""
    from spatialaudiogen_tpu_torch.data.readers import AudioChunkReader

    reader = AudioChunkReader(os.path.join(frames_dir, "ambix"), rate)
    out_fn = os.path.join(frames_dir, "audio_pow.lst")
    win = rate // 10
    with open(out_fn, "w") as f:
        for i in range((reader.duration - 1) * 10):
            t = i / 10.0 + 0.5
            sig = reader.get(t, win)
            f.write(f"{t} {np.sqrt((sig[:, 0] ** 2).mean())}\n")
    return out_fn


def flow_frame_rgb(flow_frame: np.ndarray):
    """Encode one (H, W, 2) float flow field exactly like the reference
    (scraping/preprocess.py:185-199):

      * ``ang = arctan2(fy, fx) + pi`` — NOT mod 2pi. Decoding with the
        FlowReader formula (feeder.py:156-160) therefore yields pi-rotated
        vectors; that is the convention every released flow checkpoint was
        trained on, so the encoder reproduces it bit-for-bit.
      * angles are zeroed where ``mag < 0.005``;
      * ``m_max`` is clamped to ``m_min + 1`` when the range is < 1, and the
        flow_limits row stores the CLAMPED pair;
      * uint8 assignment truncates (C cast), no rounding.

    Returns (rgb uint8 (H, W, 3), (m_min, m_max)).
    """
    fx, fy = flow_frame[:, :, 0], flow_frame[:, :, 1]
    mag = np.sqrt(fx ** 2 + fy ** 2)
    ang = np.arctan2(fy, fx) + np.pi
    ang[mag < 0.005] = 0
    m_min, m_max = float(mag.min()), float(mag.max())
    if m_max - m_min < 1:  # avoid 0 division (preprocess.py:190-191)
        m_max = m_min + 1
    rgb = np.zeros(flow_frame.shape[:2] + (3,), np.uint8)
    rgb[:, :, 0] = ang * 255.0 / (np.pi * 2.0)
    rgb[:, :, 2] = (mag - m_min) / (m_max - m_min) * 255.0
    return rgb, (m_min, m_max)


def compress_flow(flow: np.ndarray, flow_dir: str):
    """Store (T, H, W, 2) float flow as angle/magnitude jpgs + limits.

    Byte-compatible with reference-made artifacts (the per-frame encoding is
    flow_frame_rgb; scraping/preprocess.py:185-204): jpg ch0 = angle
    quantized over [0, 2pi] with the atan2+pi convention, ch2 = magnitude
    normalized per frame by flow_limits.npy rows (min, clamped max).
    """
    from PIL import Image

    os.makedirs(flow_dir, exist_ok=True)
    n = flow.shape[0]
    lims = np.zeros((n, 2), np.float32)
    for i in range(n):
        rgb, lims[i] = flow_frame_rgb(flow[i])
        Image.fromarray(rgb).save(os.path.join(flow_dir, f"{i:06d}.jpg"), quality=95)
    np.save(os.path.join(flow_dir, "flow_limits.npy"), lims)
    return lims


HR_SHAPE = (1080, 1920)  # deployment-mux resolution (preprocess.py:253)
HR_RATE = 30


def preprocess_video_worker(job: dict):
    """One video end-to-end (the per-process unit of the ETL pool).

    Covers every per-video stage the reference's worker runs
    (preprocess.py:239-264): ambisonics remap, low-res video, optional HR
    video (1080x1920 @ 30 fps for deployment muxing), frame extraction,
    audio power index, and — when ``job["flow"]`` is set — optical flow,
    so one `sag-torch-preprocess` invocation yields the complete frames
    layout including ``flow/`` and the pool parallelism covers the most
    expensive stage. ``job["flow"] == "tpu"`` (the solver on the card)
    runs only in a pool of one.
    """
    dry_run = job.get("dry_run", False)
    prepare_ambisonics(job["audio_fn"], job["prep_audio_fn"], job["codec"],
                       dry_run=dry_run)
    if job.get("video_fn"):
        in_shape = job.get("in_shape")
        if in_shape is None and job.get("projection") == "EAC":
            # the EAC remap maps are keyed by the input resolution; probe it
            # like the reference does (preprocess.py:44-45)
            if dry_run:
                in_shape = (1920, 3840)  # placeholder: command shape only
            else:
                from spatialaudiogen_tpu_torch.utils.io_video import get_ffprobe_meta

                meta = get_ffprobe_meta(job["video_fn"])["video"]
                in_shape = (int(meta["height"]), int(meta["width"]))
        prepare_video(job["video_fn"], job.get("stereopsis", "MONO"),
                      job.get("projection", "ER"), job["prep_video_fn"],
                      in_shape=in_shape, dry_run=dry_run)
        if job.get("prep_hr_video_fn"):
            # second 1080p@30 render for `sag-torch-deploy --save_video`
            # (preprocess.py:250-256 --prep_hr_video)
            prepare_video(job["video_fn"], job.get("stereopsis", "MONO"),
                          job.get("projection", "ER"), job["prep_hr_video_fn"],
                          out_shape=HR_SHAPE, out_rate=HR_RATE,
                          in_shape=in_shape, dry_run=dry_run)
    if not dry_run:
        extract_frames(job["prep_audio_fn"], job.get("prep_video_fn"),
                       job["frames_dir"])
        compute_audio_pow(job["frames_dir"])
        if job.get("flow") and job.get("prep_video_fn"):
            # flow inside the worker like the reference (preprocess.py:264),
            # so the pool parallelism covers it
            from spatialaudiogen_tpu_torch.etl.flow import ExternalFlowModel, flow_for_frames

            builtin = job["flow"] in ("farneback", "tpu")
            model = None if builtin else ExternalFlowModel(job["flow"])
            flow_for_frames(os.path.join(job["frames_dir"], "video"),
                            os.path.join(job["frames_dir"], "flow"),
                            model=model,
                            method=job["flow"] if builtin else "farneback")
    return job["frames_dir"]


def preprocess_all(jobs: list, n_workers: int = 4):
    """Process-parallel ETL over per-video jobs (preprocess.py:234-285)."""
    assert n_workers <= 1 or not any(j.get("flow") == "tpu" for j in jobs), \
        "flow='tpu' must not run inside the worker pool (CUDA cannot be " \
        "initialised in a forked worker); run it as a post-pass (see main)"
    if n_workers <= 1:
        return [preprocess_video_worker(j) for j in jobs]
    with mp.Pool(n_workers) as pool:
        return pool.map(preprocess_video_worker, jobs)


def build_jobs(db_lst_fn: str, orig_dir: str, prep_dir: str, frames_dir: str,
               low_res: bool = False, dry_run: bool = False,
               prep_hr_dir: str | None = None, flow: str | None = None) -> list:
    """Per-video job dicts from a downloads dir (preprocess.py:268-273).

    Downloaded streams are named `<id>.audio.f<fmt>.<ext>` / `<id>.video.<ext>`
    (etl.download templates); codec / stereopsis / projection come from the
    vendored meta/formats tables (columns 3-4, preprocess.py:240-248). Ids
    missing a stream or a table row are skipped like the reference.
    """
    import glob

    from spatialaudiogen_tpu_torch.etl.download import (
        AUDIO_FORMATS_FN,
        VIDEO_FORMATS_FN,
        VIDEO_FORMATS_LOWRES_FN,
    )

    def rows(fn):
        table = {}
        for line in open(fn):
            parts = line.split()
            if len(parts) >= 3:
                table[parts[0]] = parts[1:]
        return table

    audio_meta = rows(AUDIO_FORMATS_FN)
    video_meta = rows(VIDEO_FORMATS_LOWRES_FN if low_res else VIDEO_FORMATS_FN)
    audio_files = {os.path.basename(fn).split(".")[0]: fn
                   for fn in glob.glob(os.path.join(orig_dir, "*.audio.*"))}
    video_files = {os.path.basename(fn).split(".")[0]: fn
                   for fn in glob.glob(os.path.join(orig_dir, "*.video.*"))}

    jobs = []
    for yid in (line.strip().split()[0] for line in open(db_lst_fn) if line.strip()):
        if yid not in audio_files or yid not in audio_meta:
            continue
        job = {
            "audio_fn": audio_files[yid],
            "prep_audio_fn": os.path.join(prep_dir, f"{yid}-ambix.m4a"),
            "codec": audio_meta[yid][1],
            "frames_dir": os.path.join(frames_dir, yid),
            "dry_run": dry_run,
        }
        if yid in video_files and yid in video_meta:
            job["video_fn"] = video_files[yid]
            job["prep_video_fn"] = os.path.join(prep_dir, f"{yid}-video.mp4")
            job["stereopsis"] = video_meta[yid][1]
            job["projection"] = video_meta[yid][2]
            if prep_hr_dir:
                job["prep_hr_video_fn"] = os.path.join(
                    prep_hr_dir, f"{yid}-video.mp4")
            if flow:
                job["flow"] = flow
        jobs.append(job)
    return jobs


def main(argv=None) -> None:
    """CLI parity with `python scraping/preprocess.py db.lst`
    (preprocess.py:207-285)."""
    import argparse

    parser = argparse.ArgumentParser(
        description="Preprocess downloaded videos into the frames layout.")
    parser.add_argument("db_list", help="File with one youtube id per line.")
    parser.add_argument("--orig_dir", default="data/orig")
    parser.add_argument("--output_prep_dir", default="data/preproc")
    parser.add_argument("--output_frames_dir", default="data/frames")
    parser.add_argument("--num_workers", default=4, type=int)
    parser.add_argument("--low_res", action="store_true")
    parser.add_argument("--prep_hr_video", action="store_true",
                        help="Also render 1080x1920@30 videos for deployment "
                             "muxing (reference preprocess.py:250-256).")
    parser.add_argument("--output_prep_hr_dir", default="data/preproc-hr")
    parser.add_argument("--flow", default=None,
                        help="Compute optical flow inside the worker pool: "
                             "'farneback' for the built-in OpenCV estimator, "
                             "'tpu' for the pyramidal Horn-Schunck solver "
                             "on --device (ops/flow.py), or a command "
                             "template with {frames_dir} and {output_fn} "
                             "placeholders (an external model; reference "
                             "preprocess.py:264 --flownet2_dir).")
    parser.add_argument("--device", default="cuda",
                        help="torch device of --flow tpu (default cuda).")
    parser.add_argument("--dry_run", action="store_true",
                        help="Print the ffmpeg commands without running them.")
    args = parser.parse_args(argv)
    if args.low_res:
        assert not args.prep_hr_video, \
            "HR prep needs the full-res downloads (preprocess.py:223-224)"

    os.makedirs(args.output_prep_dir, exist_ok=True)
    os.makedirs(args.output_frames_dir, exist_ok=True)
    if args.prep_hr_video:
        os.makedirs(args.output_prep_hr_dir, exist_ok=True)
    # --flow tpu must NOT run inside the worker pool: CUDA cannot be
    # initialised in a forked worker, and N workers would each hold a
    # context on the card. The device solves the frame pairs of a video in
    # batches anyway, so device flow runs as a serial post-pass in this
    # process while the pool keeps covering the ffmpeg/decode stages
    # (host-side flow stays inside the workers, reference
    # preprocess.py:264 semantics).
    pool_flow = None if args.flow == "tpu" else args.flow
    jobs = build_jobs(args.db_list, args.orig_dir, args.output_prep_dir,
                      args.output_frames_dir, low_res=args.low_res,
                      dry_run=args.dry_run,
                      prep_hr_dir=args.output_prep_hr_dir if args.prep_hr_video else None,
                      flow=pool_flow)
    print(f"{len(jobs)} videos to preprocess")
    preprocess_all(jobs, n_workers=1 if args.dry_run else args.num_workers)
    if args.flow == "tpu" and not args.dry_run:
        from spatialaudiogen_tpu_torch.etl.flow import flow_for_frames

        for job in jobs:
            video_dir = os.path.join(job["frames_dir"], "video")
            flow_dir = os.path.join(job["frames_dir"], "flow")
            if not os.path.isdir(video_dir) or \
                    os.path.exists(os.path.join(flow_dir, "flow_limits.npy")):
                continue
            flow_for_frames(video_dir, flow_dir, method="tpu", device=args.device)
            print(f"flow (tpu): {job['frames_dir']}")


if __name__ == "__main__":
    main()
