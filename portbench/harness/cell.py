"""One run of one cell: set-up, the measured window, the comparison with
the reference, and the metrics.

The window is a closed loop with one client: each operation starts when
the one before it has brought its result to the host. An untraced run
measures for ``seconds`` and starts no operation after that; a traced run
records ``trace_blocks`` blocks of the traffic under the profiler. Each
execution takes its parameters from the configuration's ``PARAMETERS``
(none where it has no entry), drawn from the seed.

After the window the reference works out the answers of a sample of
``CHECKED`` executions drawn from the seed (of every execution in a
traced run, whose rooflines count the bytes of each), and each is held
against the program's.
"""
from __future__ import annotations

import contextlib
import gc
import sys
import time
import traceback
from dataclasses import dataclass, field

from portbench.harness import compare, manifest as mf, trace as tr, traffic

FORBIDDEN = {"jax", "jaxlib", "flax", "cudf_tpu"}
WARMUP_ROUNDS = 2  # each operation of the mix runs this often in set-up
CHECKED = 32       # executions of an untraced window that the reference checks


class Refused(RuntimeError):
    """A run that may print no result."""


@dataclass
class Context:
    """What a metric reader reads."""
    spec: dict
    setup_s: float
    window_s: float
    latencies: list                  # (operation, parameters, seconds) of each completed one
    peak_bytes: int | None = None    # max_memory_allocated over the window
    counts: dict = field(default_factory=dict)   # the reference's, by (operation, parameters)
    trace: tr.Trace | None = None


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def quiet_span(name):
    """A span that records nothing: the untraced window's."""
    return contextlib.nullcontext()


def _traced_span(device):
    """A span of the benchmark's own: a profiler range closed by a
    synchronize, so the device work begun inside it ends inside it."""
    @contextlib.contextmanager
    def span(name):
        import torch

        with torch.profiler.record_function(name):
            yield
            _sync(device)
    return span


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parameters(cfg, seed: int, stream: int):
    """``draw(operation)``: the parameters of the operation's next
    execution, from the seed's stream ``stream``."""
    import numpy as np

    rng = np.random.default_rng([seed, stream])
    table = getattr(cfg, "PARAMETERS", {})

    def draw(op):
        return table[op](rng) if op in table else ()
    return draw


def run(name: str, seed: int, seconds: float, traced: bool, device="cuda",
        sizes=None, t_start=None) -> dict:
    """The result of one run of cell ``name``. ``sizes`` overrides the
    configuration's sizes (``manifest.resize``: the CPU tests' tiny ones)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    m = mf.load()
    work = mf.cell(m, name)
    spec = mf.resize(mf.spec(m, work["config"]), sizes)
    mix = mf.traffic(work["traffic"])
    ops = list(mix["operations"])
    cfg = mf.config_module(work["config"])
    on_card = torch.device(device).type == "cuda"

    t0 = time.perf_counter()
    raw = cfg.generate(spec, seed, device)
    _sync(device)
    t1 = time.perf_counter()
    state = cfg.build(raw, spec, ops, device)
    del raw
    _sync(device)
    t2 = time.perf_counter()
    warm = parameters(cfg, seed, 2)
    for _ in range(WARMUP_ROUNDS):
        for op in ops:
            cfg.OPERATIONS[op](state, quiet_span, warm(op))
    _sync(device)
    # the set-up's objects out of the collector's way: the window's
    # collections then walk only what the operations themselves made
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    _log(f"setup: {setup_s:.3f} s: to the data {t0 - t_start:.3f} s, data {t1 - t0:.3f} s, "
         f"the port's state {t2 - t1:.3f} s, warm-up ({WARMUP_ROUNDS} rounds) "
         f"{t_start + setup_s - t2:.3f} s")
    setup_peak = torch.cuda.max_memory_allocated() if on_card else None
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    results, latencies, failed, attempted = [], [], 0, 0
    seq = traffic.sequence(mix, seed)
    draw = parameters(cfg, seed, 1)

    def one(span):
        nonlocal failed, attempted
        op = next(seq)
        params = draw(op)
        attempted += 1
        t0 = time.perf_counter()
        try:
            out = cfg.OPERATIONS[op](state, span, params)
        except Exception:  # an operation that fails counts as failed, and the run goes on
            failed += 1
            _log(f"operation {op}{params} failed:\n{traceback.format_exc()}")
            return
        latencies.append((op, params, time.perf_counter() - t0))
        results.append((op, params, out))

    trace = None
    w0 = time.perf_counter()
    if traced:
        n_ops = mix["trace_blocks"] * len(traffic.block(mix))
        _, prof = tr.capture(lambda: [one(_traced_span(device)) for _ in range(n_ops)])
    else:
        while time.perf_counter() - w0 < seconds:
            one(quiet_span)
    window_s = time.perf_counter() - w0
    peak = torch.cuda.max_memory_allocated() if on_card else None

    found = forbidden_modules()
    if found:
        raise Refused("modules of JAX or of the JAX package are loaded: " + ", ".join(found))
    if traced:
        trace = tr.reduce(prof)
        del prof
        _log(f"trace: {len(trace.device)} device operations, "
             f"{100 * tr.linked_share(trace):.1f}% linked to their launch; "
             f"{len(trace.ranges)} host ranges")

    del state
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # the reference, from the seed again: it takes nothing the program made
    ref = mf.reference_module(work["config"])
    checked = results if traced else sample(results, seed)
    raw = cfg.generate(spec, seed, device)
    want = ref.answers(raw, spec, [(op, p) for op, p, _ in checked],
                       getattr(torch, spec["precision"]))
    del raw
    reading = {"mismatches": 0, "max_rel_err": 0.0}
    for op, params, out in checked:
        reading = compare.merge(reading, compare.compare(out, want[(op, params)][0]))
    limits = spec["checks"]
    correct = bool(results) and failed == 0 and compare.passes(reading, limits)

    ctx = Context(spec, setup_s, trace.window_s if traced else window_s, latencies,
                  peak, {k: v[1] for k, v in want.items()}, trace)
    metrics = {}
    for metric in mf.metrics_of(m, work, traced):
        value = mf.metric_module(metric["name"]).read(ctx)
        if value is not None:
            metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    _log(f"window: {len(latencies)} operations completed of {attempted} attempted in "
         f"{ctx.window_s:.3f} s; " + ", ".join(
             f"{op} x{sum(1 for o, *_ in latencies if o == op)}" for op in ops)
         + f"; {len(checked)} checked, {len(want)} distinct")

    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": _device(device, setup_peak, peak)}
    if traced:
        out["device"]["busy_s"] = tr.busy_s(trace)
        out["device"]["window_s"] = trace.window_s
        out["breakdown"] = {"device_ops": tr.top_device_ops(trace),
                            "idle_gaps": tr.idle_gaps(trace)}
    out["checks"] = {k: {"value": reading[k], "limit": limits[k]} for k in compare.NUMBERS}
    return out


def sample(results: list, seed: int) -> list:
    """``CHECKED`` of the results, drawn from the seed, in window order."""
    import numpy as np

    if len(results) <= CHECKED:
        return results
    rng = np.random.default_rng([seed, 3])
    return [results[i] for i in sorted(rng.choice(len(results), CHECKED, replace=False))]


def _device(device, setup_peak, peak) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": None}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": max(setup_peak, peak)}
