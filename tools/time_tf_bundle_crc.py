"""Time the TF1 bundle's CRC32C on the host: the port's numpy lanes
(spatialaudiogen_tpu_torch.utils.tf_bundle.crc32c) over a tensor as large
as the flagship's whole bundle, and the JAX package's byte loop over 1 MB.

    python tools/time_tf_bundle_crc.py [--mb 123.2]

Prints one JSON line: seconds for each, and the loop's seconds per MB.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--mb", type=float, default=123.2,
                        help="bytes for the lanes, in MB (the flagship's bundle: 123.2)")
    args = parser.parse_args(argv)

    from spatialaudiogen_tpu.utils import tf_bundle as jax_tf_bundle
    from spatialaudiogen_tpu_torch.utils import tf_bundle

    rng = np.random.RandomState(0)
    data = rng.bytes(int(args.mb * 1e6))
    t0 = time.perf_counter()
    lanes = tf_bundle.crc32c(data)
    lanes_s = time.perf_counter() - t0
    one_mb = data[:1 << 20]
    t0 = time.perf_counter()
    loop = jax_tf_bundle.crc32c(one_mb)
    loop_s = time.perf_counter() - t0
    assert loop == tf_bundle.crc32c(one_mb)
    print(json.dumps({"lanes_mb": args.mb, "lanes_s": round(lanes_s, 3), "lanes_crc": lanes,
                      "byte_loop_s_per_mb": round(loop_s, 3)}))


if __name__ == "__main__":
    main()
