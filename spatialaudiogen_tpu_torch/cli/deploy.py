"""Deploy CLI of the PyTorch port: the flags of spatialaudiogen_tpu.cli.deploy,
plus --device.

    python -m spatialaudiogen_tpu_torch.cli.deploy MODEL_DIR INPUT_FOLDER [VIDEO] \
        [--deploy_start 0] [--deploy_duration 10] [--output_fn out] \
        [--save_ambix] [--save_video] [--overlay_map] [--VR] \
        [--batch_size 32] [--crossfade] [--device cuda]

MODEL_DIR holds train-params.json and params.npz (export a JAX model dir
with tools/export_torch_weights.py). --save_video muxes the predicted
ambisonics with VIDEO (trimmed to the deployed span by ffmpeg) through
deploy.mux.gen_360video, as the JAX CLI does: a binaural W+-Y stereo mp4,
or with --VR the ambisonics with SA3D and spherical-video metadata;
--overlay_map blends the spherical power map over the frames. ffmpeg must
be on PATH for it.

--n_data N shards each window batch over N ranks on this host (one card
each on CUDA, CPU processes under --device cpu; ranks that share a card
run their collectives over gloo): each rank runs its block of every
batch's rows, and rank 0 gathers the predictions and writes the wav and
the video. --batch_size must divide by N.

    python -m spatialaudiogen_tpu_torch.cli.deploy MODEL_DIR INPUT_FOLDER \
        --save_ambix --output_fn out --n_data 2
"""

from __future__ import annotations

import argparse
import sys


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("model_dir", help="Directory with train-params.json + params.npz.")
    parser.add_argument("input_folder", help="Folder with input sample (frames layout).")
    parser.add_argument("video", nargs="?", default="", help="High resolution video.")
    parser.add_argument("--deploy_start", default=0.0, type=float)
    parser.add_argument("--deploy_duration", default=10.0, type=float)
    parser.add_argument("--output_fn", default="output")
    parser.add_argument("--save_ambix", action="store_true")
    parser.add_argument("--save_video", action="store_true")
    parser.add_argument("--overlay_map", action="store_true")
    parser.add_argument("--VR", action="store_true", help="360 video output.")
    parser.add_argument("--batch_size", default=32, type=int)
    parser.add_argument("--n_data", default=1, type=int,
                        help="Ranks to shard each window batch over (one card each "
                             "on CUDA).")
    parser.add_argument("--compute_dtype", default=None, choices=["float32", "bfloat16"],
                        help="Override the training compute dtype.")
    parser.add_argument("--crossfade", action="store_true",
                        help="Hann-blend half-offset passes at window seams.")
    parser.add_argument("--rgb_frames", action="store_true",
                        help="Force byte-exact RGB frame upload instead of "
                             "raw 4:2:0 planes.")
    parser.add_argument("--f32_fetch", action="store_true",
                        help="Copy predictions back as float32 instead of float16.")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda).")
    args = parser.parse_args(argv)
    if args.deploy_duration <= 0:
        args.deploy_duration = None
    return args


def check_arguments(args) -> None:
    """ValueError, before any model is loaded, for --save_video without
    VIDEO and for --n_data that cannot shard --batch_size."""
    if args.save_video and not args.video:
        raise ValueError("--save_video requires the VIDEO argument")
    if args.n_data < 1 or args.batch_size % args.n_data:
        raise ValueError(f"--batch_size {args.batch_size} must divide over --n_data "
                         f"{args.n_data}")


def rank_main(argv: list, coordinator: str, n_ranks: int, rank: int):
    """One rank of the --n_data form (parallel.distributed.spawn_local);
    -> what main returns on this rank."""
    from spatialaudiogen_tpu_torch.parallel.distributed import run_as_rank

    return run_as_rank(main, argv, coordinator, n_ranks, rank, parse_arguments(argv).device)


def main(argv=None):
    """Deploy; -> the (N, channels) ambisonics on rank 0 (None on the other
    ranks, and from the command that spawned the ranks of --n_data)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_arguments(argv)
    check_arguments(args)
    from spatialaudiogen_tpu_torch.parallel.distributed import is_distributed, spawn_local

    if args.n_data > 1 and not is_distributed():
        return spawn_local("spatialaudiogen_tpu_torch.cli.deploy", argv, args.n_data)
    from spatialaudiogen_tpu_torch.deploy.deploy import MonoToAmbix
    from spatialaudiogen_tpu_torch.parallel.mesh import data_mesh
    from spatialaudiogen_tpu_torch.utils.io_audio import save_wav

    device, mesh = data_mesh(args.n_data, args.device)
    model = MonoToAmbix(args.model_dir, batch_size=args.batch_size,
                        device=device, compute_dtype=args.compute_dtype,
                        yuv_frames=False if args.rgb_frames else None,
                        f16_fetch=not args.f32_fetch, mesh=mesh)
    print("Generating ambisonics...")
    ambi = model.deploy(args.input_folder, args.deploy_start, args.deploy_duration,
                        crossfade=args.crossfade)
    if ambi is None:       # not rank 0
        return None
    print(f"Predicted {ambi.shape[0] / model.cfg.audio_rate:.1f}s of "
          f"{ambi.shape[1]}-channel ambisonics")
    if args.save_ambix:
        out = args.output_fn if args.output_fn.endswith(".wav") else args.output_fn + ".wav"
        save_wav(out, ambi, model.cfg.audio_rate)
        print(f"Saved ambisonics wav: {out}")
    if args.save_video:
        save_video(args, ambi, model.cfg.audio_rate, model.cfg.ambi_order)
    return ambi


def save_video(args, ambi, rate: int, ambi_order: int) -> None:
    """The JAX CLI's video output: trim VIDEO to the deployed span with
    ffmpeg, then mux it with the ambisonics (deploy.mux.gen_360video);
    the temporaries are removed. A --deploy_duration of 0 (the whole clip)
    trims no end, where the JAX CLI passes ffmpeg "-t None"."""
    import os
    import tempfile

    from spatialaudiogen_tpu_torch.deploy.mux import _run, gen_360video
    from spatialaudiogen_tpu_torch.utils.io_audio import save_wav

    tmp_ambix = tempfile.mktemp(prefix="sag_", suffix=".wav")
    tmp_video = tempfile.mktemp(prefix="sag_", suffix=".mp4")
    save_wav(tmp_ambix, ambi, rate)
    try:
        span = [] if args.deploy_duration is None else ["-t", str(args.deploy_duration)]
        _run(["ffmpeg", "-y", "-ss", str(args.deploy_start), "-i", args.video] + span
             + [tmp_video], False, [])
        gen_360video(tmp_ambix, tmp_video, args.output_fn, overlay_map=args.overlay_map,
                     inject_meta=args.VR, binauralize=not args.VR, ambi_order=ambi_order)
    finally:
        for fn in (tmp_ambix, tmp_video):
            if os.path.exists(fn):
                os.remove(fn)
    print(f"Saved video: {args.output_fn}")


if __name__ == "__main__":
    main()
