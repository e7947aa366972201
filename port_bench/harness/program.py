"""Readers of the program's own tracer (`spatialaudiogen_tpu_torch.utils.
profiling`): the spans and counters it recorded in a traced run's window.
The tracer records while a torch.profiler records, so a traced window
(`--trace 1`) holds them and an untraced one holds none. Each reader gives
None where there is nothing to read, including a checkout whose program
has no tracer."""

from __future__ import annotations


def window_trace(ctx):
    """The program's spans that started, and counts made, in the window;
    None outside a traced run or without the tracer."""
    if not ctx.trace or getattr(ctx, "_t0", None) is None or not ctx.window_s:
        return None
    try:
        from spatialaudiogen_tpu_torch.utils.profiling import TRACER
    except ImportError:
        return None
    start = int(ctx._t0 * 1e9)      # time.perf_counter() and perf_counter_ns() share a clock
    return TRACER.snapshot(start, start + int(ctx.window_s * 1e9))


def _per(ctx, count_key: str):
    count = ctx.result.info.get(count_key) if ctx.result else None
    return count or None


def program_span_ms_per(ctx, spans, count_key: str) -> float | None:
    """Milliseconds of the program's spans named `spans` (a name or a tuple
    of names) in the window per unit of work (the driver's info[count_key]:
    steps, calls, ticks)."""
    trace, count = window_trace(ctx), _per(ctx, count_key)
    names = (spans,) if isinstance(spans, str) else tuple(spans)
    found = [s for s in trace.spans if s.name in names] if trace is not None else []
    if not found or not count:
        return None
    return sum(s.end_ns - s.start_ns for s in found) / 1e6 / count


def program_count_per(ctx, counter: str, count_key: str, scale: float = 1.0) -> float | None:
    """The program's counter `counter` over the window, times `scale`, per
    unit of work (info[count_key])."""
    trace, count = window_trace(ctx), _per(ctx, count_key)
    if trace is None or counter not in trace.counters or not count:
        return None
    return trace.counters[counter] * scale / count


def program_count_ratio(ctx, counter: str, per: str, scale: float = 1.0) -> float | None:
    """The program's counter `counter` over its counter `per` in the window,
    times `scale`."""
    trace = window_trace(ctx)
    if trace is None or counter not in trace.counters or not trace.counters.get(per):
        return None
    return trace.counters[counter] * scale / trace.counters[per]
