"""Count the torch operations one pair-batch of the port's Horn-Schunck
solver (spatialaudiogen_tpu_torch.ops.flow.flow_pairs) dispatches.

Views (slices, reshapes, transposes) launch nothing and are not counted;
every other aten op is one CUDA launch or more on the card. The count
depends on the pyramid's depth and the iteration budget, not on the frame
size, so the solve runs on small CPU tensors with the depth the given
frame size would take.

    python tools/count_flow_ops.py [--hw 224 448] [--pair_batch 16]   # from the repo root
"""

from __future__ import annotations

import argparse
import collections
import os
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.getcwd())

VIEWS = ("aten::view", "aten::slice", "aten::select", "aten::unsqueeze",
         "aten::squeeze", "aten::_unsafe_view", "aten::transpose", "aten::expand",
         "aten::alias", "aten::detach", "aten::t", "aten::diagonal", "aten::reshape",
         "aten::unbind", "aten::split", "aten::as_strided")


class OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name
        if not name.startswith(VIEWS):
            self.counts[name] += 1
        return func(*args, **(kwargs or {}))


def count(hw, pair_batch: int, fb_occlusion: bool) -> collections.Counter:
    from spatialaudiogen_tpu_torch.ops import flow

    levels = flow._n_levels(*hw)
    small = (3 * 2 ** levels, 6 * 2 ** levels)
    gen = torch.Generator().manual_seed(0)
    i1, i2 = (torch.rand((pair_batch,) + small, generator=gen) for _ in range(2))
    with torch.inference_mode(), OpCounter() as counter:
        flow.flow_pairs(i1, i2, n_levels=levels, fb_occlusion=fb_occlusion)
    return counter.counts


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--hw", type=int, nargs=2, default=(224, 448))
    parser.add_argument("--pair_batch", type=int, default=16)
    args = parser.parse_args(argv)
    for fb in (False, True):
        counts = count(tuple(args.hw), args.pair_batch, fb)
        top = ", ".join(f"{name.split('::')[1]} {n}" for name, n in counts.most_common(6))
        print(f"fb_occlusion={'on' if fb else 'off'}: {sum(counts.values())} ops per "
              f"pair-batch of {args.pair_batch} at {args.hw[0]}x{args.hw[1]} ({top})")


if __name__ == "__main__":
    main()
