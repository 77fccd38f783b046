"""A ``Trace``'s host ranges taken by their nesting: what the readers of
the program's inner ranges (``Table.from_pandas`` and the copies in it, a
join's hash builds and host reads) share. Spans are ``(start_ns, end_ns)``
pairs, sorted and disjoint, as ``trace.outermost`` gives them."""
from __future__ import annotations

import bisect


def _holder(spans: list, starts: list, s: int, e: int) -> int | None:
    """The index of the span that holds ``[s, e]``, or None; ``starts``
    are the spans' starts."""
    i = bisect.bisect_right(starts, s) - 1
    return i if i >= 0 and e <= spans[i][1] else None


def inside(trace, spans: list, match) -> list:
    """[[(start, end)]]: for each span, the host ranges inside it whose
    name ``match`` accepts (a name, or a predicate on names), in order."""
    test = match if callable(match) else (lambda n: n == match)
    out, starts = [[] for _ in spans], [a for a, _ in spans]
    for n, s, e in trace.ranges:
        if test(n):
            i = _holder(spans, starts, s, e)
            if i is not None:
                out[i].append((s, e))
    return out


def uncovered_ns(span: tuple, covers: list) -> int:
    """The time of ``span`` that no interval of ``covers`` covers."""
    s0, e0 = span
    free, t = 0, s0
    for s, e in sorted(covers):
        if e <= s0 or s >= e0:
            continue
        s, e = max(s, s0), min(e, e0)
        if s > t:
            free += s - t
        t = max(t, e)
    return free + max(e0 - t, 0)


def device_s_named(trace, spans: list, prefix: str) -> float:
    """Seconds of the device operations named ``prefix...`` whose launch
    lies inside ``spans``."""
    total, starts = 0, [a for a, _ in spans]
    for name, s, e, launch in trace.device:
        if launch is not None and name.startswith(prefix) \
                and _holder(spans, starts, launch, launch) is not None:
            total += e - s
    return total / 1e9
