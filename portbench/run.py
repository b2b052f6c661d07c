"""Run one cell of the benchmark once and print its result as the last line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, traffic mix, limits and per-layer metric
readers are found by name from ``BENCHMARK.json`` at the checkout's root.
With ``--trace 0`` the result holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics from a profiled window.  The run needs
as many CUDA devices as the cell asks for and fails without them.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
sys.path.insert(0, str(REPO))
os.environ.setdefault("USE_FLAX", "0")


def load_cell(bench, name):
    """-> (cell, config, mix, limits, per-layer metric names, end-to-end units)."""
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((REPO / cfg_entry["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    e2e = {m["name"]: m["unit"] for m in bench["end_to_end"]
           if name in m.get("workloads", [name])}
    per_layer = {m["name"]: m["unit"] for m in bench["per_layer"]
                 if name in m.get("workloads", [name])}
    return cell, config, mix, limits, per_layer, e2e


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cell, config, mix, limits, per_layer, e2e = load_cell(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    from portbench.harness import cell as harness

    readers = {name: (harness.load_reader(name), unit) for name, unit in per_layer.items()}
    result, _ = harness.run_cell(
        dict(cell, end_to_end=e2e), config, mix, limits, readers, args.seed, args.seconds,
        bool(args.trace), torch.device("cuda", 0), T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of the JAX stack or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
