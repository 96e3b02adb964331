"""Reduction of a `torch.profiler` chrome trace to what the per-layer
metrics and the breakdown read: the device's busy time (the union of
kernel, copy and set intervals, a frozen copy of `chip_smoke.py`'s
`union_us` / `trace_summary`), device seconds by kernel name, the
heaviest device operations, and the idle gaps between device intervals
labelled by the innermost host span open at their middle.
"""

from __future__ import annotations

import bisect
import json
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def merged(intervals) -> List[Tuple[float, float]]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class TraceSummary:
    """busy_s: seconds with a device operation running; kernel_s: device
    seconds by kernel name; device_ops / idle_gaps: the breakdown's
    lists, at most ten entries each."""

    def __init__(self, busy_s: float, kernel_s: Dict[str, float],
                 device_ops, idle_gaps, n_device_events: int):
        self.busy_s = busy_s
        self.kernel_s = kernel_s
        self.device_ops = device_ops
        self.idle_gaps = idle_gaps
        self.n_device_events = n_device_events

    def seconds_of(self, *fragments: str) -> float:
        """Device seconds of the kernels whose name holds any fragment."""
        return sum(s for n, s in self.kernel_s.items()
                   if any(f in n for f in fragments))


def summarize(path: str, window: str, host_spans,
              window_t0: float) -> Optional[TraceSummary]:
    """Summary of the chrome trace at path over the profiler span named
    `window`. host_spans: (start, end, name) of every thread on the
    perf_counter clock, window_t0 that clock at the window's start; the
    two clocks are aligned at the window's start, and each idle gap is
    labelled by the host span open at its middle that started last.
    None where the trace holds no device event or no such span."""
    with open(path) as fh:
        events = [e for e in json.load(fh).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    win = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("name") == window]
    if not dev or not win:
        return None
    t0, t1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    ivals = [(max(e["ts"], t0), min(e["ts"] + e["dur"], t1)) for e in dev]
    ivals = [(a, b) for a, b in ivals if b > a]
    busy = union_us(ivals)
    kernel_s: Dict[str, float] = {}
    for e in dev:
        n = e.get("name", "?")
        kernel_s[n] = kernel_s.get(n, 0.0) + e["dur"] / 1e6
    ops = sorted(((n[:120], s) for n, s in kernel_s.items()),
                 key=lambda kv: -kv[1])[:10]
    # idle gaps of the window, each labelled by the host span open at its
    # middle that started last (any thread)
    off = t0 - window_t0 * 1e6
    spans = sorted((a * 1e6 + off, b * 1e6 + off, name)
                   for a, b, name in host_spans if name != window)
    starts = [s[0] for s in spans]
    busy_iv = merged(ivals)
    edges = [t0] + [x for iv in busy_iv for x in iv] + [t1]
    gaps: Dict[str, float] = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        label = "no span"
        for s0, s1, name in reversed(spans[:bisect.bisect_right(starts,
                                                                mid)]):
            if s1 >= mid:
                label = name
                break
        gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e6
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return TraceSummary(busy / 1e6, kernel_s,
                        [[n, s] for n, s in ops], [[n, s] for n, s in idle],
                        len(dev))
