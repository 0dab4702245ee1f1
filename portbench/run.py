"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout with an NVIDIA GPU. Set-up builds the cell's
scene, warms up its shapes, then the window measures for `--seconds`;
`--trace 1` also profiles the window's first steps and reports the
cell's per-layer metrics instead of its end-to-end ones. Afterwards the
plain reference (`portbench/reference/`) checks what the window
produced. The last line of standard output is one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
# every cache at a fixed place inside the checkout, so a second run finds
# what the first one built
_CACHE = ROOT / "portbench" / ".cache"
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(_CACHE / _sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    cell = harness.find_cell(ROOT, args.workload)
    chips = cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = cell.entry().run(cell, seed=args.seed, seconds=args.seconds,
                           trace=bool(args.trace), t0=T0,
                           device=torch.device("cuda", 0))
    found = harness.forbidden_modules()
    if found:
        print("portbench: JAX or the JAX package was loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    line = harness.result_line(cell, out, bool(args.trace))
    for msg in harness.check_lines(out["checks"]):
        print(msg, file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
