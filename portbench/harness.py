"""The benchmark's general machinery, driven by `BENCHMARK.json`.

A cell (an entry of `workloads`) names a configuration, whose file the
`configs` entry gives, and a traffic mix, `portbench/traffic/<traffic>.json`,
which names the entry kind that drives it, `portbench/entries/<kind>.py`.
A per-layer metric `<stem>.<variant>` is read by `portbench/metrics/<name>.py`
or, where that file is missing, `portbench/metrics/<stem>.py`, called
`read(trace, variant) -> float | None`. Nothing here knows a cell, a mix or a
metric by name: a new one is new files and new entries.
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
import importlib.util
import json
import math
import pathlib
import statistics
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "halogen_tpu")
LAUNCH_KEYS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx")


def load_module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no such file: {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of `BENCHMARK.json` with everything it names."""

    root: pathlib.Path
    name: str
    config: dict
    traffic: dict
    e2e: list  # the end-to-end metric entries this cell reports
    per_layer: list  # the per-layer metric entries this cell reports
    chips: int = 1

    def entry(self):
        kind = self.traffic["entry"]
        return load_module(self.root / "portbench" / "entries" / f"{kind}.py",
                           f"portbench_entry_{kind}")

    def readers(self) -> dict:
        """{metric: its reader's `read(trace)`}."""
        return {m["name"]: reader(self.root, m["name"])
                for m in self.per_layer}


def reader(root: pathlib.Path, name: str):
    """`read(trace)` of the per-layer metric `name`: its own file, else
    its stem's, given the name's variant (the part after the first dot)."""
    metrics = root / "portbench" / "metrics"
    stem, _, variant = name.partition(".")
    own = metrics / f"{name}.py"
    path = own if own.exists() else metrics / f"{stem}.py"
    mod = load_module(path, "portbench_metric_"
                      + path.stem.replace(".", "_"))
    return functools.partial(mod.read, variant=variant or None)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(root: pathlib.Path, name: str) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return Cell(root, name, config, traffic, e2e, per_layer, w["chips"])


# ---------------------------------------------------------------- timing

def quantile(values, q: float) -> float:
    """The q-quantile of `values` by linear interpolation between order
    statistics (numpy's default)."""
    v = sorted(values)
    if not v:
        return math.nan
    pos = q * (len(v) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def window_stats(spans, window_start: float) -> dict:
    """Whole-window statistics of completed steps (start, end) on the host
    clock: their count, the window's seconds from its start to the last
    completion, each step's latency, and its median and 95th percentile.
    A rate is count over seconds: a stall inside the window counts in
    full, as no median of chunks would."""
    lat = [e - s for s, e in spans]
    seconds = spans[-1][1] - window_start
    return {"steps": len(spans), "seconds": seconds, "latency_s": lat,
            "rate": len(spans) / seconds,
            "median_s": statistics.median(lat),
            "p95_s": quantile(lat, 0.95)}


class Window:
    """Times steps for `seconds` on the host clock. `trace_steps` > 0 runs
    `torch.profiler` over the window's first steps (the traced stretch).
    Every `STRETCH_S` it notes the steps, wall and process CPU seconds of
    the stretch past (`stretches`), to tell a slower process from a busier
    host."""

    STRETCH_S = 5.0

    def __init__(self, seconds: float, trace_steps: int = 0):
        self.seconds, self.trace_steps = seconds, trace_steps
        self.spans: list = []
        self.stretches: list = []  # (steps, wall s, process CPU s)
        self.prof = None
        self.traced = None  # (start, end) of the traced stretch
        self.start = None
        self._last = None

    def begin(self):
        self.start = self._last = time.perf_counter()
        self._mark = (0, self.start, time.process_time())
        self._maybe_profile()

    def _maybe_profile(self):
        if self.trace_steps and self.prof is None:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
            self._trace_t0 = time.perf_counter()

    def stepped(self) -> bool:
        """Mark a step complete (the caller has synchronised); False once
        the window is over."""
        now = time.perf_counter()
        self.spans.append((self._last, now))
        self._last = now
        if now - self._mark[1] >= self.STRETCH_S:
            cpu = time.process_time()
            self.stretches.append((len(self.spans) - self._mark[0],
                                   now - self._mark[1], cpu - self._mark[2]))
            self._mark = (len(self.spans), now, cpu)
        if self.prof is not None and self.traced is None and \
                len(self.spans) == self.trace_steps:
            self.prof.stop()
            self.traced = (self._trace_t0, now)
        tracing = self.prof is not None and self.traced is None
        return tracing or now - self.start < self.seconds

    def run(self, step):
        self.begin()
        while True:
            step()
            if not self.stepped():
                break


def print_stretches(win: Window) -> None:
    """The window's stretches on standard error: steps a second and the
    process's CPU milliseconds a step, in order."""
    print("stretches (steps/s, CPU ms a step): " + ", ".join(
        f"{n / wall:.2f} {1e3 * cpu / n:.3f}"
        for n, wall, cpu in win.stretches), file=sys.stderr)


# ---------------------------------------------------------------- traces

def warm_profiler(device) -> None:
    """Start and stop `torch.profiler` once on `device` in set-up, so the
    traced stretch does not carry the tracer's own start-up."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        (torch.ones(1024, device=device) * 2).sum().item()

def _device_us(evt) -> float:
    from torch.autograd import DeviceType

    if evt.device_type != DeviceType.CUDA:
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def _short(key: str) -> str:
    return key.replace("(anonymous namespace)::", "").split("(")[0][:60]


def reduce_trace(prof, wall_s: float, steps: int) -> dict:
    """What a traced stretch shows: the device's busy seconds (the sum of
    every device row's own time), the kernel launches, the ten device
    operations that took most time, and the ten host operations under
    which the device idled longest (the innermost host operation open at
    each gap's middle, the gaps summed by its name)."""
    from torch.autograd import DeviceType

    rows = prof.key_averages()
    busy_us = sum(_device_us(r) for r in rows)
    launches = sum(r.count for r in rows if r.key in LAUNCH_KEYS)
    ops = sorted(((_short(r.key), _device_us(r) / 1e6) for r in rows
                  if _device_us(r) > 0), key=lambda x: -x[1])[:10]
    events = prof.events()
    dev = sorted((e.time_range.start, e.time_range.end) for e in events
                 if e.device_type == DeviceType.CUDA)
    host = sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.device_type == DeviceType.CPU),
                  key=lambda x: x[0])
    gaps, reach = [], None
    for s, e in dev:
        if reach is not None and s > reach:
            gaps.append((s - reach, reach, s))
        reach = e if reach is None else max(reach, e)
    by_name: dict = {}
    starts = [h[0] for h in host]
    for length, s, e in sorted(gaps, reverse=True)[:200]:
        mid = 0.5 * (s + e)
        i = bisect.bisect_right(starts, mid)
        best = None
        for hs, he, name in host[max(0, i - 4000):i]:
            if he >= mid and (best is None or he - hs < best[0]):
                best = (he - hs, name)
        name = best[1] if best else "(no host op)"
        by_name[name] = by_name.get(name, 0.0) + length / 1e6
    idle = sorted(by_name.items(), key=lambda x: -x[1])[:10]
    return {"busy_s": busy_us / 1e6, "wall_s": wall_s, "steps": steps,
            "launches": launches,
            "breakdown": {"device_ops": [[n, s] for n, s in ops],
                          "idle_gaps": [[n, s] for n, s in idle]}}


# ---------------------------------------------------------------- result

def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def result_line(cell: Cell, out: dict, trace: bool) -> dict:
    """The run's last line. `out` is what the entry returned: e2e values,
    the traced stretch, the device, the comparison."""
    if trace:
        metrics, readers = {}, cell.readers()
        for m in cell.per_layer:
            value = readers[m["name"]](out["trace"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]],
                               "unit": m["unit"]} for m in cell.e2e}
    device = dict(out["device"])
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = out["trace"]["busy_s"]
        device["window_s"] = out["trace"]["wall_s"]
        line["breakdown"] = out["trace"]["breakdown"]
    line["checks"] = out["checks"]
    return line


def check_lines(checks: dict) -> list:
    return [f"check {k}: {v['value']!r} limit {v['limit']!r} "
            f"({'within' if v['value'] <= v['limit'] else 'PAST'})"
            for k, v in checks.items()]


def judge(values: dict, limits: dict) -> tuple:
    """({name: {value, limit}}, correct): each compared number beside its
    limit; a number that is missing or not finite fails."""
    checks = {k: {"value": float(values.get(k, math.nan)),
                  "limit": float(limits[k])}
              for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return checks, ok
