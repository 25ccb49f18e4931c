"""Interval arithmetic over device activity, in seconds.

``union`` merges overlapping ``(start, end)`` pairs; ``covered`` is the
length of a union; ``subtract`` leaves what of one union no interval of
another covers; ``gaps`` lists the holes of a union inside a window.  The
idle share and the exposed communication are read from these, never from a
sum of kernel times, which counts twice what two streams run at once."""

from __future__ import annotations

Interval = tuple[float, float]


def union(intervals) -> list[Interval]:
    out: list[list[float]] = []
    for a, b in sorted((a, b) for a, b in intervals if b > a):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def covered(intervals) -> float:
    return sum(b - a for a, b in union(intervals))


def clip(intervals, lo: float, hi: float) -> list[Interval]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if min(b, hi) > max(a, lo)]


def subtract(intervals, cover) -> list[Interval]:
    """The parts of ``union(intervals)`` that ``union(cover)`` leaves open."""
    cover = union(cover)
    out: list[Interval] = []
    j = 0
    for a, b in union(intervals):
        while j < len(cover) and cover[j][1] <= a:
            j += 1
        start, k = a, j
        while k < len(cover) and cover[k][0] < b:
            ca, cb = cover[k]
            if ca > start:
                out.append((start, ca))
            start = max(start, cb)
            if start >= b:
                break
            k += 1
        if start < b:
            out.append((start, b))
    return out


def gaps(intervals, lo: float, hi: float) -> list[Interval]:
    """The holes of ``union(intervals)`` inside ``[lo, hi]``."""
    return subtract([(lo, hi)], intervals)
