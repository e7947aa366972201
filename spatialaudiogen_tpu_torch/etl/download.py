"""Dataset acquisition: yt-dlp command construction + archive resume (the
port's copy of spatialaudiogen_tpu.etl.download).

Parity with reference scraping/download.py: per-video pinned audio/video
format ids come from format tables (scraping/{audio,video}_formats(.lowres)
.txt layout: "<youtube_id> <format_id> ..." lines, vendored under
meta/formats/ as dataset metadata), downloads resume via per-kind
download-archive files (download.py:34-47), and ids missing from either
table are skipped (download.py:66-67). yt-dlp replaces youtube-dl.

All functions build command lists; `download_all(..., dry_run=True)` returns
them without executing.
"""

from __future__ import annotations

import os

from spatialaudiogen_tpu_torch.utils.cmd import run_system_cmd

META_FORMATS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "meta", "formats")
AUDIO_FORMATS_FN = os.path.join(META_FORMATS_DIR, "audio_formats.txt")
VIDEO_FORMATS_FN = os.path.join(META_FORMATS_DIR, "video_formats.txt")
VIDEO_FORMATS_LOWRES_FN = os.path.join(META_FORMATS_DIR,
                                       "video_formats_lowres.txt")


def dir_to_samples(path: str):
    """Map downloaded media files to youtube ids (scraping/utils.py:9-18)."""
    exts = ("webm", "mp4", "mkv", "m4a")
    files = [fn for fn in os.listdir(path)
             if fn != "downloaded.txt" and fn.split(".")[-1] in exts]
    samples: dict = {}
    for fn in files:
        samples.setdefault(fn.split(".")[0], []).append(os.path.join(path, fn))
    return samples, list(samples.keys())


def non_zero_channels(input_fn: str, probe_seconds: int = 300) -> list:
    """Which audio channels carry signal (scraping/utils.py:21-30); needs ffmpeg."""
    import tempfile

    import numpy as np

    from spatialaudiogen_tpu_torch.utils.io_audio import load_wav

    tmp = tempfile.mktemp(suffix=".wav")
    run_system_cmd(["ffmpeg", "-y", "-t", str(probe_seconds), "-i", input_fn,
                    "-map", "a", "-ar", "10000", tmp])
    data, _ = load_wav(tmp)
    os.remove(tmp)
    return list((data != 0).sum(axis=0) > 0)


def extract_clip_cmd(input_fn: str, output_fn: str, rate: int = 10,
                     seek: float | None = None, duration: float | None = None) -> list:
    """Low-res preview clip command (scraping/utils.py:33-51)."""
    cmd = ["ffmpeg", "-y"]
    if seek is not None:
        cmd += ["-ss", f"{seek:.10f}"]
    cmd += ["-i", input_fn]
    if duration is not None:
        cmd += ["-t", f"{duration:.10f}"]
    cmd += ["-an", "-vf", "scale=720:360", "-r", str(rate),
            "-vcodec", "libx264", "-crf", "5", output_fn]
    return cmd


def load_format_table(fn: str) -> dict:
    table = {}
    for line in open(fn):
        parts = line.split()
        if len(parts) >= 2:
            table[parts[0]] = parts[1]
    return table


def build_download_cmd(youtube_id: str, output_dir: str, fmt: str | None,
                       archive_fn: str, kind: str) -> list:
    """yt-dlp command for one stream (download.py:34-47).

    Output templates mirror the reference: video lands as
    `<id>.video.<ext>`, audio as `<id>.audio.f<format_id>.<ext>` so the
    preprocessor can tell the streams apart by filename.
    """
    url = f"https://youtu.be/{youtube_id}"
    if kind == "audio":
        out_tmpl = os.path.join(output_dir, "%(id)s.audio.f%(format_id)s.%(ext)s")
    else:
        out_tmpl = os.path.join(output_dir, "%(id)s.video.%(ext)s")
    cmd = ["yt-dlp", "--ignore-errors", "--download-archive", archive_fn,
           "-o", out_tmpl]
    if fmt is not None:
        cmd += ["-f", fmt]
    elif kind == "audio":
        cmd += ["-f", "bestaudio"]
    else:
        cmd += ["-f", "bestvideo"]
    cmd.append(url)
    return cmd


def download_all(db_lst_fn: str, output_dir: str,
                 audio_formats_fn: str | None = None,
                 video_formats_fn: str | None = None,
                 low_res: bool = False,
                 skip_unpinned: bool | None = None,
                 dry_run: bool = False) -> list:
    """Download audio+video streams for every id in a db list file.

    With the default (vendored) tables, ids absent from either table are
    skipped entirely, matching scraping/download.py:66-67 — the reference
    never downloads a video it cannot pin both stream formats for. Passing
    custom partial tables switches to best-effort mode (bestaudio/bestvideo
    fallback) unless `skip_unpinned` is forced.
    """
    using_defaults = audio_formats_fn is None and video_formats_fn is None
    if audio_formats_fn is None:
        audio_formats_fn = AUDIO_FORMATS_FN
    if video_formats_fn is None:
        video_formats_fn = (VIDEO_FORMATS_LOWRES_FN if low_res
                            else VIDEO_FORMATS_FN)
    if skip_unpinned is None:
        skip_unpinned = using_defaults

    os.makedirs(output_dir, exist_ok=True)
    ids = [line.strip().split()[0] for line in open(db_lst_fn) if line.strip()]
    audio_fmt = (load_format_table(audio_formats_fn)
                 if os.path.exists(audio_formats_fn) else {})
    video_fmt = (load_format_table(video_formats_fn)
                 if os.path.exists(video_formats_fn) else {})
    commands = []
    for yid in ids:
        if skip_unpinned and (yid not in audio_fmt or yid not in video_fmt):
            continue
        for kind, table in (("audio", audio_fmt), ("video", video_fmt)):
            archive = os.path.join(output_dir, f"downloaded_{kind}.txt")
            cmd = build_download_cmd(yid, output_dir, table.get(yid), archive, kind)
            commands.append(cmd)
            if not dry_run:
                run_system_cmd(cmd, check=False)
    return commands


def main(argv=None) -> None:
    """CLI parity with `python scraping/download.py db.lst` (download.py:51-75)."""
    import argparse

    parser = argparse.ArgumentParser(
        description="Download the spatialaudiogen dataset (pinned formats).")
    parser.add_argument("db_list", help="File with one youtube id per line.")
    parser.add_argument("--output_dir", default="data/orig")
    parser.add_argument("--low_res", action="store_true",
                        help="Use the low-resolution video format table.")
    parser.add_argument("--dry_run", action="store_true",
                        help="Print the yt-dlp commands without running them.")
    args = parser.parse_args(argv)
    cmds = download_all(args.db_list, args.output_dir, low_res=args.low_res,
                        dry_run=args.dry_run)
    if args.dry_run:
        for cmd in cmds:
            print(" ".join(cmd))


if __name__ == "__main__":
    main()
