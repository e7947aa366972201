"""What a traced window reads from torch.profiler: device time by kernel
name, the busy time as the union of kernel and memory-copy intervals, the
device operations by family, and the longest idle gaps named by what the
host was doing then."""

from __future__ import annotations

import dataclasses

# (family, substrings of the kernel name), first match wins
KERNEL_FAMILIES = (
    ("K3 masked_istft_nhwc (fwd)", ("masked_istft_nhwc",)),
    ("K1 masked_istft (fwd)", ("masked_istft_fwd",)),
    ("K2 masked_istft (bwd)", ("masked_istft_bwd",)),
    ("convolution (cuDNN)", ("conv", "fprop", "dgrad", "wgrad", "implicit_", "winograd",
                             "fft", "pointwise_mult_and_sum")),
    ("GEMM (cuBLAS)", ("gemm", "sm90_xmma", "cutlass", "ampere_sgemm", "Kernel2")),
    ("batch norm", ("batch_norm", "bn_")),
    ("optimizer (Adam)", ("multi_tensor", "adam", "Adam")),
    ("reduction", ("reduce", "Reduce")),
    ("copy / layout", ("copy", "Memcpy", "Memset", "cat", "transpose", "pad", "unfold",
                       "index", "scatter", "gather", "nchwToNhwc", "nhwcToNchw")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def family(name: str) -> str:
    return next((fam for fam, keys in KERNEL_FAMILIES if any(k in name for k in keys)),
                "other")


def union_length(intervals: list) -> float:
    """Total length covered by (start, end) intervals, overlaps counted once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: list, start: float, end: float) -> list:
    """[(gap start, gap end)] of [start, end) not covered by the intervals."""
    out, cur = [], start
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, end)))
        cur = max(cur, e)
        if cur >= end:
            break
    if cur < end:
        out.append((cur, end))
    return [(s, e) for s, e in out if e > s]


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: dict          # device seconds by kernel name
    kernel_calls: dict      # launches by kernel name
    breakdown: dict

    def seconds_of(self, substring: str) -> tuple[float, int]:
        """(device seconds, launches) of the kernels whose name holds it."""
        keys = [k for k in self.kernel_s if substring in k]
        return sum(self.kernel_s[k] for k in keys), sum(self.kernel_calls[k] for k in keys)


def summarize(prof, window_s: float, top: int = 10) -> TraceSummary:
    """Reduce a profile taken over exactly one window (the device idle at
    both ends) to a TraceSummary. Times in the trace are microseconds."""
    from torch.autograd import DeviceType

    device, host = [], []
    kernel_s: dict = {}
    calls: dict = {}
    # the profiler's raw events: no tree of FunctionEvents is built, which
    # for a window of some 10^6 events takes minutes
    for e in prof.profiler.kineto_results.events():
        name, kind = e.name(), e.device_type()
        start, end = e.start_ns() / 1e3, e.end_ns() / 1e3
        if e.is_user_annotation() or name.startswith("bench."):
            # record_function ranges, mirrored on the device's timeline
            if kind == DeviceType.CPU:
                host.append((start, end, name))
            continue
        if kind == DeviceType.CUDA:
            device.append((start, end))
            kernel_s[name] = kernel_s.get(name, 0.0) + (end - start) * 1e-6
            calls[name] = calls.get(name, 0) + 1
        elif kind == DeviceType.CPU:
            host.append((start, end, name))
    busy = union_length(device) * 1e-6
    fams: dict = {}
    for name, s in kernel_s.items():
        fams[family(name)] = fams.get(family(name), 0.0) + s
    idle = []
    if device:
        lo = min(s for s, _ in device)
        hi = lo + window_s * 1e6
        idle = sorted(gaps(device, lo, hi), key=lambda g: g[0] - g[1])[:top]
    named = [[_host_activity(host, (s + e) / 2), (e - s) * 1e-6] for s, e in idle]
    breakdown = {"device_ops": [[k, v] for k, v in
                                sorted(fams.items(), key=lambda kv: -kv[1])[:top]],
                 "idle_gaps": named}
    return TraceSummary(window_s, busy, kernel_s, calls, breakdown)


def _host_activity(host: list, t: float) -> str:
    """What the host was doing at time t: the innermost benchmark span
    (`bench.*`) and the innermost operation covering t, or else the last
    operation that ended before t."""
    covering = [(e - s, name) for s, e, name in host if s <= t <= e]
    bench = [c for c in covering if c[1].startswith("bench.")]
    ops = [c for c in covering if not c[1].startswith("bench.")]
    parts = [min(c)[1] for c in (bench, ops) if c]
    if parts:
        return "host: " + " > ".join(parts)
    before = [(e, name) for s, e, name in host if e < t and not name.startswith("bench.")]
    return "host: after " + max(before)[1] if before else "host: no traced activity"
