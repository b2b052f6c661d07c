"""Faults planted in the timed path, each by name: a run of a cell with one
planted has to come out ``correct: false`` at the cell's own limits.

    python3 portbench/faults.py --workload <name> --fault <fault> --seeds 1,2,3 [--seconds 4]

runs the cell with the fault planted (untraced, a short window) and prints
one JSON line per seed with the numbers compared and their limits.  The
benchmark's own runs never plant one; ``test_portbench_faults.py`` runs
each at tiny widths on the CPU.

Each fault patches the port where the work is done: the answer altered
where it is made, half of the batch left out, the flow decode returning its
input, and inside each vocoder's hand-written kernel (its Python entry
point, the same on the CPU and the card): a WN layer that returns its state
unchanged, a WN layer that writes its own skip without the sum it was
given, an MRF section whose output lands one sample late.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if __name__ == "__main__":
    sys.path.insert(0, str(HERE.parent))

FAULTS = {}  # name -> (vocoder kinds it applies to, or None for every kind; plant)


def fault(name, kinds=None):
    def register(plant):
        FAULTS[name] = (kinds, plant)
        return plant
    return register


@fault("answer_altered")
def _answer_altered(patch):
    from larynx_tpu_torch.runtime import engine

    inner = engine.to_int16

    def broken(audio, n_valid):
        out = inner(audio, n_valid).clone()
        out[0] = -out[0]
        return out

    patch(engine, "to_int16", broken)


@fault("half_batch_left_out")
def _half_batch_left_out(patch):
    from larynx_tpu_torch.runtime.engine import SynthesisEngine

    inner = SynthesisEngine.crop_rows

    def broken(self, audio_rows, y_lengths, n, strength):
        rows = inner(self, audio_rows, y_lengths, n, strength)
        return rows[: (n + 1) // 2] + [rows[0][:0]] * (n - (n + 1) // 2)

    patch(SynthesisEngine, "crop_rows", broken)


@fault("decode_returns_its_input")
def _decode_returns_its_input(patch):
    from larynx_tpu_torch.models.glow_tts import flows

    patch(flows, "decoder", lambda params, x, mask, cfg, reverse, g=None: (x, None))


@fault("wn_state_unchanged", kinds=("waveglow",))
def _wn_state_unchanged(patch):
    import torch
    from larynx_tpu_torch.models.waveglow import model

    def broken(h, cond, skip, layer, dilation, first=False, last=False):
        return h, (torch.zeros_like(h) if skip is None else skip)

    patch(model, "fused_wn_layer_state", broken)


@fault("wn_skip_not_accumulated", kinds=("waveglow",))
def _wn_skip_not_accumulated(patch):
    from larynx_tpu_torch.models.waveglow import model

    inner = model.fused_wn_layer_state

    def broken(h, cond, skip, layer, dilation, first=False, last=False):
        h_new, skip_new = inner(h, cond, skip, layer, dilation, first=first, last=last)
        return h_new, (skip_new if skip is None else skip_new - skip)

    patch(model, "fused_wn_layer_state", broken)


@fault("mrf_one_sample_late", kinds=("hifi_gan",))
def _mrf_late(patch):
    import torch
    from larynx_tpu_torch.models.hifi_gan import model

    inner = model.mrf_section

    def broken(x, stage):
        out = inner(x, stage)
        return torch.cat([out[:, :1], out[:, :-1]], dim=1)

    patch(model, "mrf_section", broken)


def applies(name, kind):
    kinds = FAULTS[name][0]
    return kinds is None or kind in kinds


@contextlib.contextmanager
def planted(name):
    """The port with fault ``name`` planted while the block runs."""
    undo = []

    def patch(owner, attr, value):
        undo.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    FAULTS[name][1](patch)
    try:
        yield
    finally:
        for owner, attr, value in reversed(undo):
            setattr(owner, attr, value)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True, choices=sorted(FAULTS))
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)

    import torch

    from portbench import run
    from portbench.harness import cell

    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    spec, config, mix, limits, _per_layer, e2e = run.load_cell(bench, args.workload)
    if not applies(args.fault, config["vocoder"]["kind"]):
        raise SystemExit(f"{args.fault} does not apply to {config['vocoder']['kind']}")
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    for seed in (int(x) for x in args.seeds.split(",")):
        t = time.perf_counter()
        with planted(args.fault):
            result, compared = cell.run_cell(dict(spec, end_to_end=e2e), config, mix, limits, {},
                                             seed, args.seconds, False, device, t)
        print(json.dumps({"workload": args.workload, "fault": args.fault, "seed": seed,
                          "correct": result["correct"], "compared": compared,
                          "checks": result["checks"],
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
