"""Aggregate eval-detailed.txt into headline numbers.

Parity with reference parse_eval_results.py:9-51: per-video averages with
the paper's rescalings — MSE as sqrt(mse*4800) (RMS over the 0.1 s window at
48 kHz), ENV/EMD as sqrt(x^2*4800), STFT raw mean.

Multi-host evals write one `eval-detailed.txt.shard{K}` per process
(eval/evaluator.py); pass all of them — rows are merged before the
per-video aggregation, so the printed numbers cover the full sample set.
"""

from __future__ import annotations

import numpy as np

SAMPLES_PER_SEC = 4800
HEADLINE = [("MSE ", "mse/avg"), ("STFT", "stft/avg"),
            ("ENV ", "env_mse/avg"), ("EMD ", "emd/dir")]


def parse_eval_detailed_file(fn):
    """Parse one eval-detailed file — or several (shard files), merged."""
    fns = [fn] if isinstance(fn, str) else list(fn)
    metrics = None
    sample_time: dict = {}
    sample_vals: dict = {}
    for one in fns:
        data = open(one).read().splitlines()
        header = data[0].split(" | ")[1].split()
        if metrics is None:
            metrics = header
        else:
            assert header == metrics, \
                f"{one}: metric columns differ from {fns[0]}"
        for line in data[1:]:
            head, vals = line.split(" | ")
            yid, t = head.split()
            sample_time.setdefault(yid, []).append(float(t))
            sample_vals.setdefault(yid, []).append([float(v) for v in vals.split()])
    for yid in sample_time:
        order = np.argsort(sample_time[yid])
        sample_time[yid] = np.asarray(sample_time[yid])[order]
        sample_vals[yid] = np.asarray(sample_vals[yid])[order]
    return sample_vals, sample_time, metrics


def aggregate(fn) -> dict:
    vals, _, keys = parse_eval_detailed_file(fn)
    out = {}
    for label, mt in HEADLINE:
        idx = keys.index(mt)
        if mt in ("emd/dir", "env_mse/avg"):
            per_video = [np.sqrt(vals[y][:, idx] ** 2 * SAMPLES_PER_SEC).mean() for y in vals]
        elif mt == "mse/avg":
            per_video = [np.sqrt(vals[y][:, idx] * SAMPLES_PER_SEC).mean() for y in vals]
        else:
            per_video = [vals[y][:, idx].mean() for y in vals]
        out[label.strip()] = float(np.mean(per_video))
    return out


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("eval_detailed_fn", nargs="+",
                        help="eval-detailed.txt, or every per-shard file of "
                             "a multi-host eval (rows are merged).")
    args = parser.parse_args(argv)
    for label, value in aggregate(args.eval_detailed_fn).items():
        print(f"{label} = {value:.3f}")


if __name__ == "__main__":
    main()
