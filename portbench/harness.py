"""What every cell shares: finding a cell's files by name, spans, the device
trace, kernel timing, and the result line.

Files are found by the names in ``BENCHMARK.json``: a workload's
configuration is ``configs/<config>.json``, its traffic
``traffic/<traffic>.json`` (whose ``driver`` names the module in
``drivers/`` that runs it), its correctness limits
``limits/<workload>.json``, and each per-layer metric a reader
``metrics/<metric>.py`` with ``read(ctx) -> float | None``.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Any, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: the kernel caches of the program and of torch, at fixed paths inside the
#: checkout, so that only a checkout's first run builds
CACHE_ENV = {
    "TORCH_EXTENSIONS_DIR": "build/portbench/torch_extensions",
    "TRITON_CACHE_DIR": "build/portbench/triton",
}
#: the prefix of every range the benchmark opens (its spans, the traced
#: part of the window): such ranges, and their device-side annotations, are
#: never counted as device work
OWN = "portbench."
#: top-level module names that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def set_cache_env(root: Path = ROOT) -> None:
    for k, rel in CACHE_ENV.items():
        os.environ[k] = str(root / rel)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``; 0 elsewhere)."""
    try:
        start_ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    per_layer: list
    end_to_end: list


def read_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = read_json(root / "BENCHMARK.json")
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg = read_json(HERE / "configs" / f"{wl['config']}.json")
    traffic = read_json(HERE / "traffic" / f"{wl['traffic']}.json")
    limits = read_json(HERE / "limits" / f"{name}.json")

    def applies(m: dict) -> bool:
        return name in m.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if applies(m) and m["moves"] in e2e_names]
    return Cell(wl, cfg, traffic, limits, layer, e2e)


def driver_class(traffic: dict):
    return importlib.import_module(f"portbench.drivers.{traffic['driver']}").Driver


def metric_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------


class Spans:
    """Host spans around the benchmark's calls into the program: (name,
    start, end, attrs) on ``time.perf_counter``. With ``profile`` each
    span is also a ``record_function`` range named ``OWN + name``, so the
    device trace can say what the host was doing in each idle gap, whatever
    driver opened it; with ``sync`` a span waits for the device before it
    closes."""

    def __init__(self, profile: bool = False, sync=None):
        self.items: list[tuple[str, float, float, dict]] = []
        self.profile, self.sync = profile, sync

    class _Span:
        def __init__(self, owner: "Spans", name: str, attrs: dict):
            self.owner, self.name, self.attrs = owner, name, attrs
            self.rf = None

        def __enter__(self):
            if self.owner.profile:
                import torch

                self.rf = torch.profiler.record_function(OWN + self.name)
                self.rf.__enter__()
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            if self.owner.sync is not None:
                self.owner.sync()
            t1 = time.perf_counter()
            if self.rf is not None:
                self.rf.__exit__(*exc)
            self.owner.items.append((self.name, self.t0, t1, self.attrs))
            return False

    def __call__(self, name: str, **attrs):
        return Spans._Span(self, name, attrs)

    def of(self, name: str) -> list[tuple[float, float, dict]]:
        return [(t0, t1, a) for n, t0, t1, a in self.items if n == name]


# ---------------------------------------------------------------------------
# The device trace
# ---------------------------------------------------------------------------


class Trace:
    """``torch.profiler`` over the first ``span`` seconds of the window. The
    profiler starts (``begin``) before the window does, since starting it
    takes seconds; ``tick`` stops it once ``span`` seconds have passed,
    ``stop`` at the window's end if it is shorter. From the trace:
    ``busy_s``, the union of the device's operations inside the traced
    part, ``window_s`` its length, the ten device operations that took
    most time, and the ten longest idle gaps summed by the innermost host
    span open at their midpoint."""

    def __init__(self, span: float):
        self.span = span
        self.prof = self.rf = None
        self.t_start: Optional[float] = None
        self.result: Optional[dict] = None

    def begin(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self.rf = torch.profiler.record_function(TRACED)
        self.rf.__enter__()
        self.t_start = time.perf_counter()

    def tick(self, t0: float, now: float) -> None:
        if self.prof is not None and now >= self.t_start + self.span:
            self.stop()

    def stop(self) -> None:
        if self.prof is None:
            return
        import torch

        torch.cuda.synchronize()
        host_s = time.perf_counter() - self.t_start
        self.rf.__exit__(None, None, None)
        self.prof.stop()
        self.result = reduce_trace(self.prof, host_s)
        self.prof = None


#: the name of the range around the traced part of the window
TRACED = OWN + "traced"


def _events(prof) -> list[tuple[str, bool, float, float]]:
    """(name, on the device, start s, end s) of every profiled event."""
    from torch.autograd import DeviceType

    out = []
    try:
        for ev in prof.profiler.kineto_results.events():
            t0 = ev.start_ns() * 1e-9
            out.append((ev.name(), ev.device_type() == DeviceType.CUDA, t0, t0 + ev.duration_ns() * 1e-9))
    except AttributeError:
        for ev in prof.events():
            t0 = ev.time_range.start * 1e-6
            out.append((ev.name, ev.device_type == DeviceType.CUDA, t0, ev.time_range.end * 1e-6))
    return out


def reduce_trace(prof, host_s: float) -> dict:
    """Busy time, the heaviest device operations and the idle gaps by host
    span, from a profile taken over ``host_s`` seconds of the host's clock.
    The traced window on the trace's clock is the ``TRACED`` range where
    the trace holds it whole, else the span of every event in the trace."""
    events = _events(prof)
    own = [(t0, t1) for n, d, t0, t1 in events if not d and n == TRACED]
    w0 = min(t0 for _, _, t0, _ in events)
    w1 = max(t1 for _, _, _, t1 in events)
    if own and own[0][1] - own[0][0] >= 0.9 * host_s:
        w0, w1 = own[0]
    dev = sorted((max(t0, w0), min(t1, w1), n) for n, d, t0, t1 in events
                 if d and not n.startswith(OWN) and t1 > w0 and t0 < w1)
    per_name: dict[str, float] = {}
    merged: list[list[float]] = []
    for t0, t1, name in dev:
        short = name.split("(")[0].split("<")[0].strip()[:120]
        per_name[short] = per_name.get(short, 0.0) + (t1 - t0)
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    busy = sum(t1 - t0 for t0, t1 in merged)
    gaps, prev = [], w0
    for t0, t1 in merged:
        if t0 > prev:
            gaps.append((prev, t0))
        prev = max(prev, t1)
    if w1 > prev:
        gaps.append((prev, w1))
    host = [(t0, t1, n) for n, d, t0, t1 in events if not d and n.startswith(OWN) and n != TRACED]
    by_host: dict[str, float] = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        inside = [(t1 - t0, n) for t0, t1, n in host if t0 <= mid <= t1]
        what = min(inside)[1][len(OWN):] if inside else "outside any span"
        by_host[what] = by_host.get(what, 0.0) + (g1 - g0)
    return {
        "busy_s": busy, "window_s": w1 - w0, "host_s": host_s,
        "events": len(events), "device_events": len(dev), "traced_range_s": [t1 - t0 for t0, t1 in own],
        "device_ops": sorted(([n, t] for n, t in per_name.items()), key=lambda x: -x[1])[:10],
        "idle_gaps": sorted(([n, t] for n, t in by_host.items()), key=lambda x: -x[1])[:10],
    }


# ---------------------------------------------------------------------------
# Kernel timing
# ---------------------------------------------------------------------------


#: the spin kernel of ``torch.cuda._sleep``, which marks each timed call
SPIN = "spin_kernel"


def kernel_ms(fn, reps: int = 10, spin: int = 50_000_000) -> Optional[float]:
    """Mean device time of ``fn`` in ms, from the profiler's trace: the
    union of the intervals of the device operations that each call ran. A
    256 MB buffer is written before each call, so that the 50 MB L2 holds
    nothing of its inputs; a spin kernel (about 25 ms at the H100's clock)
    holds the stream while the host enqueues the call, and a short one
    after it closes the call, so that the call's operations are those
    between the two spins, and the host's time between launches is not in
    the union. Calls whose count of operations is not the commonest are
    left out (the trace lost some); None where fewer than half remain."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(spin)
        fn()
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    prof.stop()
    dev = sorted((t0, t1, n) for n, d, t0, t1 in _events(prof) if d)
    calls, start = [], None
    for k, (t0, t1, n) in enumerate(dev):
        if SPIN not in n:
            continue
        if t1 - t0 >= 1e-3:
            start = k
        elif start is not None:
            calls.append(dev[start + 1:k])
            start = None
    counts = [len(c) for c in calls]
    whole = [c for c in calls if counts and len(c) == max(set(counts), key=counts.count)]
    if len(whole) < (reps + 1) // 2:
        print(f"kernel_ms: {len(dev)} device operations, {len(calls)} calls closed, operations a call {counts}",
              file=sys.stderr)
        return None
    return 1e3 * sum(union_s([(t0, t1) for t0, t1, _ in c]) for c in whole) / len(whole)


def union_s(intervals) -> float:
    """Seconds covered by the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted(intervals):
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    return busy


# ---------------------------------------------------------------------------
# Percentiles and the result
# ---------------------------------------------------------------------------


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between
    closest ranks, over every value."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def median(values) -> float:
    return percentile(values, 50.0)


def comparisons_text(checks: list[dict]) -> str:
    return "; ".join(f"{c['name']} {c['value']!r} limit {c['limit']!r}" for c in checks)
