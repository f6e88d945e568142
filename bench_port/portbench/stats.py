"""The arithmetic of the metrics: whole-window rates and the union of
device intervals."""
from __future__ import annotations


def window_rate(work: float, seconds: float) -> float:
    """Work over the whole window: the total done over the total time."""
    if seconds <= 0:
        raise ValueError("a window of no time")
    return work / seconds


def union_length(intervals) -> float:
    """Length covered by the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, start: float, end: float) -> list:
    """The idle (start, end) gaps of [start, end] outside the union of the
    intervals, longest first."""
    out, at = [], start
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, end)))
        at = max(at, e)
        if at >= end:
            break
    if at < end:
        out.append((at, end))
    return sorted((g for g in out if g[1] > g[0]), key=lambda g: g[0] - g[1])
