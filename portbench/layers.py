"""The device's idle time charged to the program's layers, from the
program's spans, and the kernel calls of a traced stretch, from its
counters (both in `halogen_tpu_torch/utils/profiling.py`).

    python3 portbench/layers.py --workload <name> --seed <n> --seconds <s>

runs the cell as `run.py --trace 1` does and adds to its result line a key
`layers`: each layer's share of the traced stretch's wall time in which
the device idled (`driver`, `wrappers`, `loop`, `outside`; they sum to
`device_idle.<kind>`), the device time a step of the copies enqueued
inside `halogen.driver.readback`, the kernel calls a step, and for
comparison the profiler's own rows a step of the port's kernels and of
device-to-host copies. On standard error it prints every span with its
count a step, its host self-time and the idle time charged to it, in ms
a step. Where the program has no spans or counters, as before they were
added, all idle time is `outside` and the calls are left out.

The rule: every gap between the device's rows in the stretch (not only
the longest) is split at the spans' edges, and each piece goes to the
highest-ranked layer with a span open on any thread at that instant,
wrappers before the driver before the loop, else to `outside`; within
the layer to its innermost open span. The layers are ranked, not the
spans' depth, because autograd runs the card's backward on a thread of
its own, beside the fit loop's.
"""

from __future__ import annotations

import re
import sys
import time

RANK = ("wrap", "driver", "loop")  # charged first to last
LAYERS = {"wrap": "wrappers", "driver": "driver", "loop": "loop"}
OUTSIDE = "outside"
READBACK = "halogen.driver.readback"
# the port's own kernels among the device's rows (csrc/*.cu)
PORT_KERNEL = re.compile(r"^(void )?(\(anonymous namespace\)::)?"
                         r"(megakernel|adjoint_|reduce_blocks|sky_|traverse_)")


def layer_of(name: str) -> str | None:
    """The layer of a `halogen.<layer>.<what>` span, else None."""
    parts = name.split(".")
    if len(parts) >= 3 and parts[0] == "halogen" and parts[1] in LAYERS:
        return parts[1]
    return None


def merge(intervals) -> list:
    """Disjoint sorted union of (start, end) intervals."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def idle_gaps(device, t0: float, t1: float) -> list:
    """The pieces of [t0, t1] that no device row (start, end, ...)
    covers."""
    gaps, at = [], t0
    for s, e in merge((max(r[0], t0), min(r[1], t1)) for r in device
                      if r[1] > t0 and r[0] < t1):
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if t1 > at:
        gaps.append((at, t1))
    return gaps


def charge(gaps, spans) -> tuple:
    """({layer or `outside`: s}, {span name: s}) of the idle `gaps`
    (disjoint, sorted) under `spans` [(name, thread, start, end)]."""
    ranked = sorted((s for s in spans if layer_of(s[0])),
                    key=lambda s: s[2])
    edges = sorted({x for g in gaps for x in g}
                   | {x for s in ranked for x in s[2:]})
    by_layer = {LAYERS[k]: 0.0 for k in RANK}
    by_layer[OUTSIDE] = 0.0
    by_span: dict = {}
    opened, nxt, gi = [], 0, 0
    for p, q in zip(edges, edges[1:]):
        while nxt < len(ranked) and ranked[nxt][2] <= p:
            opened.append(ranked[nxt])
            nxt += 1
        opened = [s for s in opened if s[3] > p]
        while gi < len(gaps) and gaps[gi][1] <= p:
            gi += 1
        if gi == len(gaps) or gaps[gi][0] > p:
            continue  # the device is busy over (p, q)
        if not opened:
            by_layer[OUTSIDE] += q - p
            continue
        # the top layer first, then its innermost span
        best = min(opened, key=lambda s: (RANK.index(layer_of(s[0])), -s[2]))
        by_layer[LAYERS[layer_of(best[0])]] += q - p
        by_span[best[0]] = by_span.get(best[0], 0.0) + q - p
    return by_layer, by_span


def self_times(spans) -> dict:
    """{name: (count, host seconds inside it but outside the spans nested
    in it on its thread)}."""
    out: dict = {}
    by_thread: dict = {}
    for s in spans:
        by_thread.setdefault(s[1], []).append(s)
    for rows in by_thread.values():
        stack: list = []  # [name, end, self seconds]
        for name, _, s, e in sorted(rows, key=lambda r: (r[2], -r[3])):
            while stack and stack[-1][1] <= s:
                _close(stack.pop(), out)
            if stack:
                stack[-1][2] -= e - s
            stack.append([name, e, e - s])
        while stack:
            _close(stack.pop(), out)
    return out


def _close(entry, out: dict) -> None:
    n, t = out.get(entry[0], (0, 0.0))
    out[entry[0]] = (n + 1, t + entry[2])


def readback_s(device, spans) -> float:
    """Device seconds of the rows (start, end, launch, thread) whose launch
    lies inside a `halogen.driver.readback` span on its thread."""
    inside = [(t, s, e) for name, t, s, e in spans if name == READBACK]
    return sum(r[1] - r[0] for r in device if r[2] is not None and any(
        t == r[3] and s <= r[2] <= e for t, s, e in inside))


def reduce_layers(device, spans, t0: float, t1: float) -> dict:
    """`layer_idle_s`, `readback_s` and the spans' table of a stretch
    [t0, t1]: `device` [(start, end, launch or None, its thread)], `spans`
    [(name, thread, start, end)], all in seconds on one clock."""
    by_layer, by_span = charge(idle_gaps(device, t0, t1), spans)
    table = {name: {"count": n, "self_s": t, "idle_s": by_span.get(name, 0.0)}
             for name, (n, t) in self_times(spans).items()}
    return {"layer_idle_s": by_layer, "readback_s": readback_s(device, spans),
            "spans": table}


def kernel_calls(before: dict | None, after: dict | None) -> int | None:
    """The port's calls into its CUDA libraries between two reads of
    `profiling.counts()`: every `*launches` and `*calls` counter."""
    if before is None or after is None:
        return None
    return sum(after[k] - before[k] for k in after
               if k.endswith(("launches", "calls")))


def events_of(prof) -> tuple:
    """(device rows, spans, extras) of a stopped `torch.profiler` session,
    in seconds on the profiler's clock, the wall clock; extras: the port's
    kernel rows and the device-to-host copies' seconds. A device row's
    launch is the host call with its correlation id (`cudaLaunchKernel`,
    `cudaMemcpyAsync`, ...)."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    launch, rows, spans = {}, [], []
    for e in events:
        s = e.start_ns() / 1e9
        end = s + e.duration_ns() / 1e9
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if name.startswith("halogen."):
                spans.append((name, e.start_thread_id(), s, end))
            elif name.startswith("cu"):
                launch[e.correlation_id()] = (s, e.start_thread_id())
        elif e.device_type() == DeviceType.CUDA and \
                not e.is_user_annotation():
            rows.append((s, end, e.correlation_id(), name))
    device = [(s, end, *launch.get(c, (None, None))) for s, end, c, _ in rows]
    extras = {
        "port_kernel_rows": sum(1 for r in rows if PORT_KERNEL.match(r[3])),
        "dtoh_s": sum(r[1] - r[0] for r in rows
                      if r[3].startswith("Memcpy DtoH"))}
    return device, spans, extras


def _counts():
    try:
        from halogen_tpu_torch.utils.profiling import counts
    except ImportError:  # a program without the registry
        return None
    return counts()


def print_table(spans: dict, steps: int) -> None:
    """One line a span on standard error: count, host self-time and idle
    charged to it, a step."""
    print("span: count, self ms, idle ms (a step)", file=sys.stderr)
    for name in sorted(spans):
        v = spans[name]
        print(f"  {name}: {v['count'] / steps:.2f}, "
              f"{1e3 * v['self_s'] / steps:.4f}, "
              f"{1e3 * v['idle_s'] / steps:.4f}", file=sys.stderr)


def main(argv=None) -> int:
    from portbench import harness, run

    reduce_trace, result_line = harness.reduce_trace, harness.result_line

    class Window(harness.Window):
        """The harness's window, reading the wall clock and the counters
        as the traced stretch starts and ends."""

        last = None

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.marks = []  # (wall clock s, counts) at start and end
            Window.last = self
            _counts()  # imports the counters' modules outside the stretch

        def _maybe_profile(self):
            super()._maybe_profile()
            if self.prof is not None:
                self.marks.append((time.time_ns() / 1e9, _counts()))

        def stepped(self):
            now = time.time_ns() / 1e9
            tracing = self.prof is not None and self.traced is None
            more = super().stepped()
            if tracing and self.traced is not None:
                self.marks.append((now, _counts()))
            return more

    def reduce_with_layers(prof, wall_s, steps):
        out = reduce_trace(prof, wall_s, steps)
        device, spans, extras = events_of(prof)
        (t0, c0), (t1, c1) = Window.last.marks
        out.update(reduce_layers(device, spans, t0, t1))
        out["kernel_calls"] = kernel_calls(c0, c1)
        out.update(extras)
        print_table(out["spans"], steps)
        return out

    def line_with_layers(cell, out, trace):
        line = result_line(cell, out, trace)
        t = out["trace"]
        n, wall = t["steps"], t["wall_s"]
        line["layers"] = {
            **{f"{k}_idle": 100.0 * v / wall
               for k, v in t["layer_idle_s"].items()},
            "readback_ms": 1e3 * t["readback_s"] / n,
            "kernel_calls": (None if t["kernel_calls"] is None
                             else t["kernel_calls"] / n),
            "port_kernel_rows": t["port_kernel_rows"] / n,
            "dtoh_ms": 1e3 * t["dtoh_s"] / n}
        return line

    harness.Window = Window
    harness.reduce_trace = reduce_with_layers
    harness.result_line = line_with_layers
    return run.main([*(argv if argv is not None else sys.argv[1:]),
                     "--trace", "1"])


if __name__ == "__main__":
    import pathlib

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    sys.exit(main())
