"""Evaluator CLI of the PyTorch port: the flags of spatialaudiogen_tpu.cli.eval
(reference eval.py:14-26), plus --n_workers and --device.

    python -m spatialaudiogen_tpu_torch.cli.eval MODEL_DIR [--subset_fn F]
        [--batch_size 16] [--overwrite] [--db_dir D] [--emd_ang_res 30]
        [--device_metrics] [--emd exact|sinkhorn] [--compute_dtype bfloat16]
        [--n_workers 4] [--device cuda]

MODEL_DIR holds train-params.json and params.npz (export a JAX model dir
with tools/export_torch_weights.py). Rows go to MODEL_DIR/eval-detailed.txt;
aggregate them with `python -m spatialaudiogen_tpu_torch.cli.parse_eval_results`.

--n_data N shards each eval batch over N ranks on this host (one card each
on CUDA, CPU processes under --device cpu): every rank forms the same
batches (the feeder on one thread), runs its block of rows, and rank 0
scores the gathered rows and writes the one eval-detailed.txt.
--batch_size must divide by N.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("model_dir")
    parser.add_argument("--subset_fn", default="")
    parser.add_argument("--batch_size", default=16, type=int)
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("--db_dir", default=None,
                        help="Override the dataset dir recorded at training time.")
    parser.add_argument("--emd_ang_res", default=30, type=float)
    parser.add_argument("--device_metrics", action="store_true",
                        help="Compute mel-LSD and envelope distance on the "
                             "device as matmuls (ops/eval_metrics.py, within "
                             "~1e-6 of the host implementations). Together "
                             "with --emd sinkhorn the whole eval battery "
                             "runs on the device.")
    parser.add_argument("--emd", default="exact", choices=["exact", "sinkhorn"],
                        help="EMD solver: 'exact' = per-sample native "
                             "min-cost flow on the host (reference pyemd "
                             "semantics); 'sinkhorn' = whole-batch annealed "
                             "Sinkhorn on the device (ops/sinkhorn.py).")
    parser.add_argument("--n_data", default=None, type=int,
                        help="Ranks to shard each eval batch over (one card each on "
                             "CUDA; the feeder then runs one thread).")
    parser.add_argument("--compute_dtype", default=None,
                        choices=["float32", "bfloat16"],
                        help="Override the training compute dtype, e.g. "
                             "force f32-exact metrics for a --bf16-trained "
                             "model (default: as trained).")
    parser.add_argument("--n_workers", default=4, type=int,
                        help="Feeder threads. With 1 the batches are formed "
                             "in one fixed order, so a rerun gives the same "
                             "rows (the visual encoders' BatchNorm runs on "
                             "batch statistics).")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda).")
    args = parser.parse_args(argv)
    if len(args.subset_fn) == 0:
        args.subset_fn = None
    return args


def check_flags(args) -> None:
    """ValueError for --n_data that cannot shard --batch_size."""
    n_data = args.n_data or 1
    if n_data < 1 or args.batch_size % n_data:
        raise ValueError(f"--batch_size {args.batch_size} must divide over --n_data {n_data}")


def guard_outputs(args) -> None:
    """FileExistsError when eval-detailed.txt (or a shard of it) exists and
    --overwrite is not given; with --overwrite they go."""
    eval_fn = os.path.join(args.model_dir, "eval-detailed.txt")
    if not os.path.exists(args.model_dir):
        raise FileNotFoundError(f"Model dir does not exist: {args.model_dir}")
    # the guard covers per-shard files too: sharded runs write
    # eval-detailed.txt.shard{K}, and stale shards from a previous run with
    # another shard count would otherwise be merged by parse_eval_results.
    # With --overwrite, all old shard files go, so a rerun with fewer shards
    # cannot leave stale ones behind.
    existing = sorted(glob.glob(eval_fn + "*"))
    if existing and not args.overwrite:
        raise FileExistsError(f"Evaluation file(s) already exist: {existing}")
    for fn in existing:
        os.remove(fn)


def rank_main(argv: list, coordinator: str, n_ranks: int, rank: int):
    """One rank of the --n_data form (parallel.distributed.spawn_local);
    -> what main returns on this rank."""
    from spatialaudiogen_tpu_torch.parallel.distributed import run_as_rank

    return run_as_rank(main, argv, coordinator, n_ranks, rank, parse_arguments(argv).device)


def main(argv=None):
    """Evaluate; -> (summary, rows) on rank 0 (({}, []) on the other ranks,
    None from the command that spawned the ranks of --n_data)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_arguments(argv)
    check_flags(args)
    n_data = args.n_data or 1
    import torch.distributed as dist

    from spatialaudiogen_tpu_torch.parallel.distributed import is_distributed, spawn_local

    sharded = n_data > 1 and is_distributed()
    if not sharded or dist.get_rank() == 0:
        # one guard, on rank 0 (and in the command that spawns the ranks)
        guard_outputs(args)
    if n_data > 1 and not sharded:
        return spawn_local("spatialaudiogen_tpu_torch.cli.eval", argv, n_data)

    from spatialaudiogen_tpu_torch.eval.evaluator import Evaluator
    from spatialaudiogen_tpu_torch.parallel.mesh import data_mesh

    device, mesh = data_mesh(n_data, args.device)
    evaluator = Evaluator(args.model_dir, subset_fn=args.subset_fn,
                          batch_size=args.batch_size, db_dir=args.db_dir,
                          n_workers=args.n_workers, emd_ang_res=args.emd_ang_res,
                          compute_dtype=args.compute_dtype, emd_mode=args.emd,
                          device_metrics=args.device_metrics, device=device,
                          mesh=mesh)
    primary = mesh is None or mesh.is_primary
    step = evaluator.restored_step
    if primary:
        print("Restored " + (f"checkpoint step {step}" if step is not None
                             else "params.npz (no train_state.pt: step unknown)"))
    summary, results = evaluator.run(output_fn=None)
    if primary:
        print(f"\nEvaluated {len(results)} samples")
        for key, value in summary.items():
            print(f"EVAL | {key}: {value:f}")
        sys.stdout.flush()
    return summary, results


if __name__ == "__main__":
    main()
