"""Shared arithmetic of the per-layer readers (`portbench/metrics/`).

Each reader takes a traced run's reading (`trace.Traced.reading`: the
profiled calls or steps reduced, with their `flops`, and under `host` the
same number of calls or steps before them timed without the profiler)
and returns a number, or None where the traced calls held nothing to
read. Device times come from the profiled part; host times and the mfu
shares from the part without the profiler, whose own host cost would
slow a host-bound call. A share of a peak or a roofline is never returned
as 0 for want of data."""

from __future__ import annotations

from typing import Optional

from portbench import flops, peaks
from portbench.trace import kernel_seconds


def per_unit_ms(seconds: Optional[float], reading: dict) -> Optional[float]:
    if seconds is None or not reading['units']:
        return None
    return seconds / reading['units'] * 1e3


def span_device_ms(reading: dict, span: str) -> Optional[float]:
    if span not in reading['span_host_s']:
        return None
    return per_unit_ms(reading["span_device_s"].get(span) or None, reading)


def span_host_ms(reading: dict, span: str) -> Optional[float]:
    """Host ms a call or step inside `span`, without the profiler."""
    host = reading['host']
    if span not in host['span_s'] or not host['units']:
        return None
    return host['span_s'][span] / host['units'] * 1e3


def h2d_ms(reading: dict) -> Optional[float]:
    seconds = kernel_seconds(reading, 'Memcpy HtoD')
    return per_unit_ms(seconds, reading) if seconds else None


def nms_roofline(reading: dict) -> Optional[float]:
    """Percent: the launches' least time over the kernel's device time."""
    device = kernel_seconds(reading, 'nms_scores')
    calls = reading['notes'].get('nms', [])
    if not device or not calls:
        return None
    bound = sum(flops.nms_bound_s(int((out > 0).sum()), *shape)
                for out, shape in calls)
    return 100.0 * bound / device


def idle(reading: dict) -> Optional[float]:
    """Percent of the traced window with no device operation running."""
    if not reading['busy_s'] or not reading['window_s']:
        return None
    return 100.0 * (1.0 - reading['busy_s'] / reading['window_s'])


def idle_in_calls(reading: dict) -> Optional[float]:
    """Percent of the calls' own time with no device operation running
    (an open loop's waits for the next window left out)."""
    if not reading['busy_in_calls_s'] or not reading['call_s']:
        return None
    return 100.0 * (1.0 - reading['busy_in_calls_s'] / reading['call_s'])


def mfu(reading: dict, over: str = 'window') -> Optional[float]:
    """Percent of the float32 peak: the model's FLOPs of the calls or
    steps timed without the profiler over their wall time (`window`) or
    over the calls' own time (`call`, an open loop's waits left out)."""
    host = reading['host']
    seconds = (host['window_s'] if over == 'window'
               else host['span_s'].get(over))
    if not host['flops'] or not seconds or not reading['busy_s']:
        return None
    return 100.0 * host['flops'] / seconds / peaks.FP32_FLOPS


def conv_roofline(reading: dict) -> Optional[float]:
    """Percent: the convolutions' FLOPs at the float32 peak over the
    convolution kernels' device time."""
    if not reading.get('flops') or not reading['conv_s']:
        return None
    return 100.0 * reading['flops'] / peaks.FP32_FLOPS / reading['conv_s']


def batch_norm_ms(reading: dict) -> Optional[float]:
    if not reading['batch_norm_s']:
        return None
    return per_unit_ms(reading['batch_norm_s'], reading)
