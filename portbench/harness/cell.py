"""One run of one cell: set-up, the window, the traced metrics, the check.

``run_cell`` is driven by data alone: the cell's configuration file (whose
model kinds name ``kinds/<kind>.py``), its traffic mix (whose ``entry``
names ``entries/<entry>.py``), its limits and the per-layer metric readers
it lists (``metrics/<name>.py``).
"""

import gc
import importlib.util
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

from portbench import entries, kinds
from portbench.harness import program, trace, traffic
from portbench.reference import rules
from portbench.reference.synth import Reference

ROOT = Path(__file__).resolve().parents[1]
TRACE_SECONDS = 2.0  # the traced run's window: its trace must be read well inside the run's limit
FORBIDDEN = ("jax", "jaxlib", "flax", "larynx_tpu")
CALIBRATION_SENTENCES = 128
WARM_SECONDS = 3.0  # a short window of the cell's own traffic closes the warm-up


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def load_reader(name):
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{abs(hash(name))}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules():
    """Top-level module names of the JAX stack or the JAX package that are
    loaded, compared whole (``larynx_tpu_torch`` is not ``larynx_tpu``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


class Setup:
    """Weights, engine and traffic of a run, from the seed."""

    def __init__(self, config, mix, seed, device, with_engine=True):
        self.config, self.mix, self.seed, self.device = config, mix, int(seed), device
        acfg, vcfg = config["acoustic"], config["vocoder"]
        self.acoustic, self.vocoder = kinds.load(acfg["kind"]), kinds.load(vcfg["kind"])
        prec = config["precision"]
        gen = torch.Generator(device=device)
        gen.manual_seed(self.seed % 2 ** 63)
        self.glow = self.acoustic.weights(acfg, gen, device, program.DTYPES[prec["acoustic"]])
        voc_dtype = program.DTYPES[prec["vocoder"]] if device.type == "cuda" else torch.float32
        self.voc = self.vocoder.weights(vcfg, gen, device, voc_dtype)
        cal = traffic.Traffic({"lengths": mix["lengths"]}, self.seed ^ 0x5A5A, acfg["num_symbols"])
        sents = cal.sentences()
        ids = [next(sents) for _ in range(CALIBRATION_SENTENCES)]
        t = max(len(x) for x in ids)
        arr = torch.zeros((len(ids), t), dtype=torch.int64)
        for i, x in enumerate(ids):
            arr[i, : len(x)] = torch.as_tensor(x)
        lengths = torch.as_tensor([len(x) for x in ids])
        self.acoustic.calibrate(self.glow, acfg, arr.to(device), lengths.to(device),
                                mix["length_scale"], mix["frames_per_id"])
        self.engine_seed = self.seed
        self.engine = (program.build_engine(config, self.glow, self.voc, self.engine_seed, device)
                       if with_engine else None)
        self.traffic = traffic.Traffic(mix, self.seed, acfg["num_symbols"])
        self.buckets = rules.Buckets(mix["buckets"], acfg["n_sqz"])

    def other_traffic(self):
        """Draws of the same mix that the window never sends (the warm-up's)."""
        return traffic.Traffic(self.mix, ~self.seed & (2 ** 63 - 1),
                               self.config["acoustic"]["num_symbols"])

    def check_rng(self):
        """The generator that draws the sample the check compares."""
        return np.random.default_rng([self.seed & (2 ** 63 - 1), 5])

    def reference(self, control=None):
        return Reference(self.glow, self.config["acoustic"], self.voc, self.config["vocoder"],
                         self.config["audio"], self.buckets, self.device, self.engine_seed,
                         control=control)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell, config, mix, limits, readers, seed, seconds, traced, device, t_start):
    """-> (result dict, the number of requests compared)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    entry = entries.load(mix["entry"])
    torch.set_grad_enabled(False)
    s = Setup(config, mix, seed, device)
    warm_state = entry.warm(s, float(mix.get("warm_seconds", WARM_SECONDS)))
    _sync(device)
    setup_s = time.perf_counter() - t_start

    ctx = types.SimpleNamespace(config=config, mix=mix)
    # what set-up made lives on: keep the collector from walking it in the window
    gc.collect()
    gc.freeze()
    if traced:
        with trace.Ranges() as ranges:
            with trace.profiled(ranges) as prof:
                out = entry.window(s, min(seconds, TRACE_SECONDS),
                                   mark=torch.profiler.record_function)
            ctx.trace, ctx.window_s = prof["trace"], prof["window_s"]
            ctx.mrf_calls, ctx.wn_calls = ranges.mrf_calls, ranges.wn_calls
    else:
        out = entry.window(s, seconds)
    _sync(device)
    gc.unfreeze()
    metrics, attempted, failed = entry.end_to_end(out, s)
    metrics["setup_s"] = setup_s
    vars(ctx).update(entry.context(out, s))
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    # the program's state goes before the reference runs
    s.engine = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    tally = entry.compare(s, out, warm_state, limits)
    log(f"compared {tally.compared} requests with the reference, {tally.ambiguous} left out "
        f"as ambiguous (a duration within float32's reach of an integer)")
    numbers = tally.numbers()
    numbers["failed"] = failed

    result = {"correct": None, "attempted": attempted, "failed": failed, "metrics": {},
              "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                         "kind": torch.cuda.get_device_name(device) if device.type == "cuda"
                         else "cpu",
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if traced:
        result["device"]["busy_s"] = ctx.trace.busy_s
        result["device"]["window_s"] = ctx.window_s
        for name, (read, unit) in readers.items():
            value = read(ctx)
            if value is not None:
                result["metrics"][name] = {"value": float(value), "unit": unit}
        result["breakdown"] = {"device_ops": ctx.trace.top_ops(10),
                               "idle_gaps": ctx.trace.idle_gaps(n=10)}
    else:
        for name, unit in cell["end_to_end"].items():
            result["metrics"][name] = {"value": metrics[name], "unit": unit}
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in ("length_mismatch",
                                                                      "audio_err", "failed")}
    result["correct"] = bool(tally.compared > 0 and all(c["value"] <= c["limit"]
                                                         for c in checks.values()))
    result["checks"] = checks
    return result, tally.compared
