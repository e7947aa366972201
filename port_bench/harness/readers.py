"""Shared arithmetic of the per-layer metric readers (metrics/*.py). Each
returns None where its run has nothing to read: no trace, no launch of
the kernel, no span."""

from __future__ import annotations

from port_bench.reference.work import bound_seconds


def span_ms_per(ctx, span: str, count_key: str) -> float | None:
    """Mean milliseconds of `span` in the window per unit of work (the
    driver's info[count_key]: steps, ticks)."""
    spans = ctx.spans.closed.get(span)
    count = ctx.result.info.get(count_key) if ctx.result else None
    if not spans or not count:
        return None
    return sum(spans) / count * 1e3


def mfu_pct(ctx, per_key: str, count_key: str) -> float | None:
    """The work's least time at published peaks (info[per_key] per unit of
    info[count_key]) over the window's measured time."""
    info = ctx.result.info
    if not ctx.window_s or not info.get(count_key) or per_key not in info:
        return None
    return 100.0 * info[per_key] * info[count_key] / ctx.window_s


def kernel_roofline_pct(ctx, kernel: str) -> float | None:
    """The launches' least time by their work (info istft_flops /
    istft_bytes per launch, on info route) over their device time."""
    trace = ctx.trace_summary
    if trace is None:
        return None
    seconds, calls = trace.seconds_of(kernel)
    if not calls or not seconds:
        return None
    info = ctx.result.info
    return 100.0 * calls * bound_seconds(info["istft_flops"], info["istft_bytes"],
                                         info["route"]) / seconds


def device_idle_pct(ctx) -> float | None:
    trace = ctx.trace_summary
    if trace is None or not trace.busy_s:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def span_outside_ms_per(ctx, outer: str, inner: str, count_key: str) -> float | None:
    """Mean milliseconds per unit of work (info[count_key]) spent in the
    `outer` spans outside the `inner` ones they hold."""
    spans = ctx.spans.closed
    count = ctx.result.info.get(count_key) if ctx.result else None
    if not spans.get(outer) or not count:
        return None
    return (sum(spans[outer]) - sum(spans.get(inner, []))) / count * 1e3
