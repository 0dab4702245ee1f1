"""Phase times of `chip_smoke.py` in two or more checkouts, run in the
order given (for two commits on one card: parent, change, change,
parent). Each run copies its checkout afresh into a temporary directory,
without the kernels' build (`chip_smoke.py` reads the build's register
report, which a reused build does not print), starts `python3
chip_smoke.py` there, stamps
every line of its output on arrival, and is stopped (its whole process
group) once a line matching `--until` has arrived. Prints one JSON line a
run: the seconds from each phase's first line to the next phase's first
line, the `[32] phases 1-31 took` figure the script printed, and the
seconds from phase 3's first line to the `--until` line (the phases after
the kernels' build).

    python3 perf/torch/smoke_phase_times.py DIR_A DIR_B DIR_B DIR_A \
        [--until '^\\[32\\] phases 1-31 took'] [--timeout 900]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

PHASE = re.compile(r"^\[(\d+)\]")


def run(directory: str, until: re.Pattern, timeout: float) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        copy = os.path.join(tmp, "checkout")
        shutil.copytree(directory, copy, ignore=shutil.ignore_patterns(
            "_build", "__pycache__", "_checkout"))
        rec = _run(copy, until, timeout)
    return {"dir": directory, **rec}


def _run(directory: str, until: re.Pattern, timeout: float) -> dict:
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "chip_smoke.py"],
                            cwd=directory, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    first, order, reported, stop, last, now = {}, [], None, None, "", 0.0
    try:
        for line in proc.stdout:
            now = time.perf_counter() - t0
            last = line.rstrip()
            m = PHASE.match(line)
            if m and m.group(1) not in first:
                first[m.group(1)] = now
                order.append(m.group(1))
            r = re.match(r"^\[32\] phases 1-31 took ([0-9.]+) s", line)
            if r:
                reported = float(r.group(1))
            if until.search(line):
                stop = now
                break
            if now > timeout:
                break
    finally:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
    spans = {p: round((first[q] if q else (stop or now)) - first[p], 3)
             for p, q in zip(order, order[1:] + [None])}
    return {"reached": stop is not None,
            "phases_1_31_reported_s": reported,
            "after_build_s": (round(stop - first["3"], 3)
                              if stop is not None and "3" in first
                              else None),
            "phase_s": spans, "last_line": last[:200]}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--until", default=r"^\[32\] phases 1-31 took")
    ap.add_argument("--timeout", type=float, default=900.0)
    args = ap.parse_args(argv)
    out = []
    for d in args.dirs:
        rec = run(d, re.compile(args.until), args.timeout)
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


if __name__ == "__main__":
    main()
