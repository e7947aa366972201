"""Deploy CLI of the PyTorch port (flags of spatialaudiogen_tpu.cli.deploy
that the port supports, plus --device).

    python -m spatialaudiogen_tpu_torch.cli.deploy MODEL_DIR INPUT_FOLDER \
        [--deploy_start 0] [--deploy_duration 10] [--output_fn out] \
        [--save_ambix] [--batch_size 32] [--crossfade] [--device cuda]

MODEL_DIR holds train-params.json and params.npz (export a JAX model dir
with tools/export_torch_weights.py).
"""

from __future__ import annotations

import argparse


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("model_dir", help="Directory with train-params.json + params.npz.")
    parser.add_argument("input_folder", help="Folder with input sample (frames layout).")
    parser.add_argument("--deploy_start", default=0.0, type=float)
    parser.add_argument("--deploy_duration", default=10.0, type=float)
    parser.add_argument("--output_fn", default="output")
    parser.add_argument("--save_ambix", action="store_true")
    parser.add_argument("--batch_size", default=32, type=int)
    parser.add_argument("--compute_dtype", default=None, choices=["float32"],
                        help="Override the training compute dtype (the port "
                             "runs float32 only so far).")
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


def main(argv=None):
    args = parse_arguments(argv)
    from spatialaudiogen_tpu.utils.io_audio import save_wav
    from spatialaudiogen_tpu_torch.deploy.deploy import MonoToAmbix

    model = MonoToAmbix(args.model_dir, batch_size=args.batch_size,
                        device=args.device, compute_dtype=args.compute_dtype,
                        yuv_frames=False if args.rgb_frames else None,
                        f16_fetch=not args.f32_fetch)
    print("Generating ambisonics...")
    ambi = model.deploy(args.input_folder, args.deploy_start, args.deploy_duration,
                        crossfade=args.crossfade)
    print(f"Predicted {ambi.shape[0] / model.cfg.audio_rate:.1f}s of "
          f"{ambi.shape[1]}-channel ambisonics")
    if args.save_ambix:
        out = args.output_fn if args.output_fn.endswith(".wav") else args.output_fn + ".wav"
        save_wav(out, ambi, model.cfg.audio_rate)
        print(f"Saved ambisonics wav: {out}")
    return ambi


if __name__ == "__main__":
    main()
