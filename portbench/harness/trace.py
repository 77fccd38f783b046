"""The traced window: torch.profiler's events reduced to plain records.

``capture`` runs a function under the profiler (CPU and CUDA activity)
inside a ``portbench.window`` range; ``reduce`` turns the profiler's events
into a ``Trace`` of plain tuples, which the metric readers and the tests
use without a profiler:

- ``ranges``: host ranges, ``(name, start_ns, end_ns)``: the program's
  ``trace_op`` ranges, the benchmark's spans and the aten ops, on the
  thread that ran the window;
- ``device``: device operations (kernels, copies, sets), ``(name,
  start_ns, end_ns, launch_ns)``, where ``launch_ns`` is the host time of
  the runtime call that launched it (None where the profiler links none);
- ``window``: ``(start_ns, end_ns)`` of the traced window.
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict
from dataclasses import dataclass, field

WINDOW = "portbench.window"
DEVICE_KINDS = {"kernel", "gpu_memcpy", "gpu_memset"}
RUNTIME_KINDS = {"cuda_runtime", "cuda_driver"}


@dataclass
class Trace:
    window: tuple
    ranges: list = field(default_factory=list)
    device: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9


def capture(fn):
    """(fn()'s value, the profiler) with ``fn`` run under torch.profiler
    inside a ``portbench.window`` range that ends after a synchronize."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            out = fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    return out, prof


def _kind(e) -> str:
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return str(kind())
    if str(e.device_type()).endswith("CUDA"):
        return "gpu_user_annotation" if e.is_user_annotation() else "kernel"
    if e.is_user_annotation():
        return "user_annotation"
    return "cuda_runtime" if e.name().startswith("cu") else "cpu_op"


def reduce(prof) -> Trace:
    """The ``Trace`` of a profiler run made by ``capture``."""
    events = prof.profiler.kineto_results.events()
    window, thread = None, None
    for e in events:
        if e.name() == WINDOW and _kind(e) == "user_annotation":
            window, thread = (e.start_ns(), e.end_ns()), e.start_thread_id()
    if window is None:
        raise RuntimeError("the profiler recorded no window range")
    launches, ops_by_id = {}, {}
    ranges, device = [], []
    for e in events:
        kind = _kind(e)
        if kind in RUNTIME_KINDS:
            launches[e.correlation_id()] = e.start_ns()
        elif kind in ("cpu_op", "user_annotation"):
            ops_by_id[e.correlation_id()] = e.start_ns()
            if e.start_thread_id() == thread and e.name() != WINDOW:
                ranges.append((e.name(), e.start_ns(), e.end_ns()))
    for e in events:
        if _kind(e) in DEVICE_KINDS:
            launch = launches.get(e.correlation_id())
            if launch is None:
                launch = ops_by_id.get(e.linked_correlation_id())
            device.append((e.name(), e.start_ns(), e.end_ns(), launch))
    return Trace(window, sorted(ranges, key=lambda r: (r[1], -r[2])),
                 sorted(device, key=lambda d: d[1]))


# ------------------------------------------------------------ reductions
def _merge(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy(trace: Trace) -> list:
    """The merged intervals in which a device operation ran, inside the
    window."""
    w0, w1 = trace.window
    return _merge((max(s, w0), min(e, w1)) for _, s, e, _ in trace.device
                  if e > w0 and s < w1)


def busy_s(trace: Trace) -> float:
    return sum(e - s for s, e in busy(trace)) / 1e9


def outermost(trace: Trace, name: str) -> list:
    """The ``name`` ranges that no other ``name`` range holds."""
    out = []
    for n, s, e in trace.ranges:
        if n == name and not (out and s < out[-1][1]):
            out.append((s, e))
    return out


def range_share(trace: Trace, name: str) -> float | None:
    """The outermost ``name`` ranges' summed host time, in % of the window,
    or None where the window holds none."""
    spans = outermost(trace, name)
    if not spans:
        return None
    return 100 * sum(e - s for s, e in spans) / (trace.window[1] - trace.window[0])


def device_s_launched_in(trace: Trace, spans: list) -> float:
    """Seconds of the device operations whose launch lies inside ``spans``
    (sorted, disjoint)."""
    starts = [s for s, _ in spans]
    total = 0
    for _, s, e, launch in trace.device:
        if launch is None:
            continue
        i = bisect.bisect_right(starts, launch) - 1
        if i >= 0 and launch <= spans[i][1]:
            total += e - s
    return total / 1e9


# template wrappers and argument types that say nothing of what a kernel does
_GENERIC = {"gpu_kernel_impl", "gpu_kernel_impl_nocast", "gpu_index_kernel", "BinaryFunctor",
            "AUnaryFunctor", "BUnaryFunctor", "array", "operator", "function_traits",
            "TrivialOffsetCalculator", "OffsetCalculator", "ArrayRef", "Scalar", "Tensor",
            "TensorIteratorBase", "TensorIterator", "OpaqueType", "lambda"}


def kernel_name(name: str) -> str:
    """A CUDA kernel's demangled name cut to its template's name and the
    first functor or function inside it that is not a wrapper, with the
    element width of an index kernel: ``index_elementwise_kernel
    [index_kernel_impl/8]``. Copies, sets and plain names stay as they are."""
    n = (name[5:] if name.startswith("void ") else name).replace("(anonymous namespace)::", "")
    cut = re.search(r"[<(]", n)
    if cut is None or n.startswith(("Memcpy", "Memset")):
        return n
    head = n[:cut.start()].split("::")[-1]
    inner = [m for m in re.findall(r"([A-Za-z_]\w*)(?=[<(])", n[cut.start():])
             if m not in _GENERIC]
    if not inner:
        return head
    width = re.search(r"OpaqueType<(\d+)>", n)
    return f"{head}[{inner[0]}{'/' + width.group(1) if width else ''}]"


def top_device_ops(trace: Trace, top: int = 10) -> list:
    """[[name, seconds]]: the device operations that took most time,
    summed by ``kernel_name``."""
    by = defaultdict(int)
    for n, s, e, _ in trace.device:
        by[kernel_name(n)] += e - s
    return [[n, t / 1e9] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(trace: Trace, top: int = 10) -> list:
    """[[name, seconds]]: the window's idle time (no device operation
    running), summed by the innermost host range open at the middle of
    each gap; ``portbench.window`` where only the window was."""
    w0, w1 = trace.window
    gaps, t = [], w0
    for s, e in busy(trace):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    points = sorted(((s + e) // 2, e - s) for s, e in gaps)
    by = defaultdict(int)
    stack, i = [], 0
    ranges = trace.ranges
    for mid, length in points:
        while i < len(ranges) and ranges[i][1] <= mid:
            while stack and stack[-1][2] < ranges[i][1]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        by[stack[-1][0] if stack else WINDOW] += length
    return [[n, t / 1e9] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def linked_share(trace: Trace) -> float:
    """The share of device operations whose launch the profiler linked."""
    if not trace.device:
        return 0.0
    return sum(d[3] is not None for d in trace.device) / len(trace.device)
