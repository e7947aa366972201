"""Trainer CLI of the PyTorch port: the flags of spatialaudiogen_tpu.cli.train
(reference train.py:16-59), plus --device.

    python -m spatialaudiogen_tpu_torch.cli.train DB_DIR MODEL_DIR \
        [--encoders audio flow video] --separation unet_mask --batch_size 32 ...

The default encoders (audio, flow and video) train; flow needs the dataset's
flow frames (flow/ jpgs or the packed flow.npy + flow_lims.npy). Flags that
select paths not ported yet raise NotImplementedError naming their
ROADMAP.md item: --n_data/--n_model > 1,
--coordinator/--n_processes/--process_id, --tb_histograms and
--pretrained_resnet.
"""

from __future__ import annotations

import argparse
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
                             "every N steps (not ported yet: must stay 0).")
    parser.add_argument("--tb_activations", action="store_true",
                        help="With --tb_histograms: also histogram the "
                             "model's tapped activations (not ported yet).")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--frame_hw", nargs=2, type=int, default=[224, 448])
    parser.add_argument("--n_data", type=int, default=None,
                        help="data-parallel size (one device only so far)")
    parser.add_argument("--n_model", type=int, default=1,
                        help="tensor-parallel size (one device only so far)")
    parser.add_argument("--coordinator", default=None,
                        help="coordinator address for multi-process runs "
                             "(not ported yet)")
    parser.add_argument("--n_processes", type=int, default=None,
                        help="total number of trainer processes (not ported yet)")
    parser.add_argument("--process_id", type=int, default=None,
                        help="this process's rank (not ported yet)")
    parser.add_argument("--bf16", action="store_true",
                        help="run the conv/FC stacks in bfloat16 with float32 "
                             "master weights (compute_dtype=bfloat16)")
    parser.add_argument("--pretrained_resnet", default=None,
                        help="resnet18.npy applied to each visual encoder at "
                             "train start (not ported yet)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default cuda).")
    args = parser.parse_args(argv)
    if len(args.subset_fn) == 0:
        args.subset_fn = None
    return args


def refuse_unported(args) -> None:
    """NotImplementedError for the flags whose paths are not ported yet."""
    later = "is not ported yet; see ROADMAP.md, 'Modules to port', item"
    if args.n_model > 1 or (args.n_data or 1) > 1:
        raise NotImplementedError(f"--n_data/--n_model > 1 (multi-device) {later} 14")
    if any(v is not None for v in (args.coordinator, args.n_processes, args.process_id)):
        raise NotImplementedError(f"--coordinator/--n_processes/--process_id "
                                  f"(multi-process) {later} 14")
    if args.tb_histograms or args.tb_activations:
        raise NotImplementedError(f"--tb_histograms/--tb_activations {later} 11")
    if args.pretrained_resnet:
        raise NotImplementedError(f"--pretrained_resnet {later} 11")


def main(argv=None):
    args = parse_arguments(argv)
    refuse_unported(args)
    from spatialaudiogen_tpu_torch.config import TrainConfig
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

    print("=" * 30 + " ARGUMENTS " + "=" * 30)
    for k, v in vars(args).items():
        print(f"{k}: {v}")
    sys.stdout.flush()

    trainer = Trainer(cfg, device=args.device)
    return trainer.train()


if __name__ == "__main__":
    main()
