"""Trainer CLI of the PyTorch port: the flags of spatialaudiogen_tpu.cli.train
(reference train.py:16-59), plus --device.

    python -m spatialaudiogen_tpu_torch.cli.train DB_DIR MODEL_DIR \
        [--encoders audio flow video] --separation unet_mask --batch_size 32 ...

The default encoders (audio, flow and video) train; flow needs the dataset's
flow frames (flow/ jpgs or the packed flow.npy + flow_lims.npy).

Multi-device training, data parallel over n_data ranks and tensor parallel
over n_model (n_data x n_model ranks, parallel.mesh), runs in two forms:

    # one command starts every rank on this host (one card each on CUDA,
    # CPU processes under --device cpu), over a free localhost port
    python -m spatialaudiogen_tpu_torch.cli.train DB MODEL --n_data 2 [--n_model 1]

    # one command per rank, on any hosts that reach the coordinator
    python -m spatialaudiogen_tpu_torch.cli.train DB MODEL --n_data 2 \
        --coordinator HOST:PORT --n_processes 2 --process_id {0,1}

A rank that fails fails the command; a lost rank fails the others at their
next collective, after at most parallel.distributed.DEFAULT_TIMEOUT_S.
--tb_histograms N writes parameter and gradient histograms every N steps
(with --tb_activations also the model's tapped activations), and
--pretrained_resnet initialises the visual encoders from a resnet18.npy.
"""

from __future__ import annotations

import argparse
import os
import socket
import sys

from spatialaudiogen_tpu_torch.config import ENCODERS, FREQ_MASK, NO_SEPARATION


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("db_dir", help="Directory containing db.")
    parser.add_argument("model_dir", help="Directory to store model.")
    parser.add_argument("--subset_fn", default="")
    parser.add_argument("--encoders", nargs="*", type=str.lower, choices=list(ENCODERS),
                        default=["audio", "flow", "video"], help="List of encoders.")
    parser.add_argument("--separation", type=str.lower, default=FREQ_MASK,
                        choices=[NO_SEPARATION, FREQ_MASK])
    parser.add_argument("--ambi_order", type=int, default=1)
    parser.add_argument("--audio_rate", type=int, default=48000)
    parser.add_argument("--video_rate", type=int, default=10)
    parser.add_argument("--context", type=float, default=1.0)
    parser.add_argument("--sample_dur", type=float, default=0.1)
    parser.add_argument("--n_iters", type=int, default=1000000)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--lr_decay", type=float, default=0.5)
    parser.add_argument("--lr_iters", type=int, default=250000)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--num_sep_tracks", type=int, default=32)
    parser.add_argument("--fft_window", type=float, default=0.025)
    parser.add_argument("--context_units", nargs="+", type=int, default=[64, 128, 128])
    parser.add_argument("--freq_mask_units", nargs="*", type=int, default=[256])
    parser.add_argument("--loc_units", nargs="+", type=int, default=[512, 512])
    # framework extensions
    parser.add_argument("--n_workers", type=int, default=8)
    parser.add_argument("--log_every", type=int, default=20)
    parser.add_argument("--ckpt_every", type=int, default=5000)
    parser.add_argument("--tb_histograms", type=int, default=0,
                        help="Parameter and gradient TensorBoard histograms "
                             "every N steps (0: none).")
    parser.add_argument("--tb_activations", action="store_true",
                        help="With --tb_histograms: also histogram the "
                             "model's tapped activations.")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--frame_hw", nargs=2, type=int, default=[224, 448])
    parser.add_argument("--n_data", type=int, default=None,
                        help="data-parallel size (default: the processes over "
                             "--n_model)")
    parser.add_argument("--n_model", type=int, default=1,
                        help="tensor-parallel size")
    parser.add_argument("--coordinator", default=None,
                        help="HOST:PORT of rank 0's store, for multi-process runs")
    parser.add_argument("--n_processes", type=int, default=None,
                        help="total number of trainer processes")
    parser.add_argument("--process_id", type=int, default=None,
                        help="this process's rank")
    parser.add_argument("--bf16", action="store_true",
                        help="run the conv/FC stacks in bfloat16 with float32 "
                             "master weights (compute_dtype=bfloat16)")
    parser.add_argument("--pretrained_resnet", default=None,
                        help="resnet18.npy applied to each visual encoder at "
                             "train start (fresh runs only)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default cuda).")
    args = parser.parse_args(argv)
    if len(args.subset_fn) == 0:
        args.subset_fn = None
    return args


def check_flags(args) -> int:
    """ValueError (or FileNotFoundError) for flags that cannot run
    together, before anything is written; -> the number of ranks."""
    n_ranks = (args.n_data or 1) * args.n_model
    multi = [v is not None for v in (args.coordinator, args.n_processes, args.process_id)]
    if any(multi) and not all(multi):
        raise ValueError("multi-process runs take --coordinator, --n_processes and "
                         "--process_id together")
    if args.n_processes is not None:
        if args.n_data is None and args.n_processes % args.n_model == 0:
            n_ranks = args.n_processes
        if n_ranks != args.n_processes:
            raise ValueError(f"multi-device: --n_data x --n_model = {n_ranks} must equal "
                             f"--n_processes {args.n_processes}")
        if not 0 <= args.process_id < args.n_processes:
            raise ValueError(f"multi-process: --process_id {args.process_id} is not a "
                             f"rank of {args.n_processes}")
    if min(args.n_model, args.n_data or 1) < 1:
        raise ValueError("multi-device: --n_data and --n_model must be positive")
    if args.tb_histograms < 0:
        raise ValueError(f"--tb_histograms {args.tb_histograms}: a step count, 0 for none")
    if args.pretrained_resnet and not os.path.isfile(args.pretrained_resnet):
        raise FileNotFoundError(f"--pretrained_resnet {args.pretrained_resnet}: no such file")
    return n_ranks


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, argv: list, port: int, n_ranks: int) -> None:
    """One rank of the spawn form: the CLI with the multi-process flags."""
    main(list(argv) + ["--coordinator", f"localhost:{port}", "--n_processes", str(n_ranks),
                       "--process_id", str(rank)])


def spawn_local(argv: list, n_ranks: int) -> None:
    """Every rank of the run on this host, one process each (started with
    spawn, so a CUDA rank initialises its own card); raises when a rank
    exits with an error (torch.multiprocessing terminates the others)."""
    import torch.multiprocessing as mp

    # by its module's name, also when this file runs as __main__ (python -m)
    from spatialaudiogen_tpu_torch.cli.train import _rank_main
    mp.start_processes(_rank_main, args=(argv, _free_port(), n_ranks), nprocs=n_ranks,
                       join=True, start_method="spawn")


def main(argv=None):
    """Train; -> (train state, steps) of this process. The spawn form
    (--n_data or --n_model > 1 with no --n_processes) returns None once
    every rank has finished."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_arguments(argv)
    n_ranks = check_flags(args)
    if args.n_processes is None and n_ranks > 1:
        return spawn_local(argv, n_ranks)
    from spatialaudiogen_tpu_torch.config import TrainConfig
    from spatialaudiogen_tpu_torch.parallel.distributed import initialize, shutdown
    from spatialaudiogen_tpu_torch.train.trainer import Trainer

    # min_t rule from train.py:83-84: the effective video rate covers the
    # shortest of (context, sample duration, one frame)
    min_t = min(args.context, args.sample_dur, 1.0 / args.video_rate)
    video_rate = int(1.0 / min_t)

    cfg = TrainConfig(
        db_dir=args.db_dir, model_dir=args.model_dir, subset_fn=args.subset_fn,
        encoders=tuple(args.encoders), separation=args.separation,
        ambi_order=args.ambi_order, audio_rate=args.audio_rate,
        video_rate=video_rate, context=args.context, sample_dur=args.sample_dur,
        n_iters=args.n_iters, lr=args.lr, lr_decay=args.lr_decay,
        lr_iters=args.lr_iters, batch_size=args.batch_size,
        num_sep_tracks=args.num_sep_tracks, fft_window=args.fft_window,
        context_units=tuple(args.context_units),
        freq_mask_units=tuple(args.freq_mask_units),
        loc_units=tuple(args.loc_units), resume=args.resume,
        n_workers=args.n_workers, log_every=args.log_every,
        ckpt_every=args.ckpt_every, seed=args.seed,
        tb_histograms=args.tb_histograms, tb_activations=args.tb_activations,
        frame_hw=tuple(args.frame_hw), n_data=args.n_data, n_model=args.n_model,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        pretrained_resnet=args.pretrained_resnet)

    device = initialize(args.coordinator, args.n_processes, args.process_id, args.device)
    try:
        if not args.process_id:
            print("=" * 30 + " ARGUMENTS " + "=" * 30)
            for k, v in vars(args).items():
                print(f"{k}: {v}")
            sys.stdout.flush()
        trainer = Trainer(cfg, device=str(device))
        return trainer.train()
    finally:
        shutdown()


if __name__ == "__main__":
    main()
