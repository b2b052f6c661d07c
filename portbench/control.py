"""The lower-precision control of a cell: the plain reference put in the
program's place and computed one step below each precision that the
configuration states (the acoustic model in float32 with TF32 on, the
vocoder's products in float8 e4m3), held to the cell's check exactly as a
run's program is.  Its numbers are the upper readings that the cell's
limits are set from; the benchmark's own runs never run it.  A vocoder kind
may offer narrower controls (``CONTROLS`` in ``kinds/<kind>.py``; WaveGlow's
``wn`` rounds only the WN products).

    python3 portbench/control.py --workload <name> --seeds 1,2,3 [--requests N] [--scope all]

Prints one JSON line per seed with the numbers compared and each limit.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

import torch  # noqa: E402

from portbench import entries, run  # noqa: E402
from portbench.harness import cell  # noqa: E402


def control_run(config, mix, limits, seed, n_requests, device, scope="all"):
    """The control's numbers for ``seed`` (a Tally): the traffic that a run
    of the cell would send, the same sample, the control's audio in place
    of the program's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    s = cell.Setup(config, mix, seed, device, with_engine=False)
    return entries.load(mix["entry"]).control(s, scope, limits, n_requests)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--requests", type=int, default=40,
                    help="window calls the sample is drawn from")
    ap.add_argument("--scope", default="all", help="a control the vocoder kind offers")
    args = ap.parse_args(argv)
    bench_json = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    _cell, config, mix, limits, _pl, _e2e = run.load_cell(bench_json, args.workload)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    torch.set_grad_enabled(False)
    for seed in (int(x) for x in args.seeds.split(",")):
        t = time.perf_counter()
        tally = control_run(config, mix, limits, seed, args.requests, device, args.scope)
        numbers = tally.numbers()
        print(json.dumps({"workload": args.workload, "scope": args.scope, "seed": seed,
                          "control": numbers, "compared": tally.compared,
                          "ambiguous": tally.ambiguous,
                          "limits": {k: limits[k] for k in numbers},
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
