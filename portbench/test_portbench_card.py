"""Tests on the card (marked ``card``; they skip without one): each cell run
for a few seconds through ``run.py`` gives a well-formed, correct result
line, each cell's lower-precision controls come out not correct on three
seeds, and each fault planted in the cell's vocoder kernel comes out not
correct.  Run them on the chip as ``python -m pytest portbench -m card``."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import faults

HERE = Path(__file__).resolve().parent
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
KIND = {w["name"]: json.loads((HERE.parent / c["file"]).read_text())["vocoder"]["kind"]
        for w in BENCH["workloads"] for c in BENCH["configs"] if c["name"] == w["config"]}
KERNEL_FAULTS = [(w, f) for w in CELLS for f in sorted(faults.FAULTS)
                 if faults.FAULTS[f][0] is not None and faults.applies(f, KIND[w])]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_and_is_correct(cuda_device, workload):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload, "--seed", "2718281828",
         "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, cwd=HERE.parent, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert list(result)[-1] == "checks"
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert "setup_s" in result["metrics"] and len(result["metrics"]) >= 2
    assert result["correct"], result["checks"]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(cuda_device, workload):
    from portbench import control, kinds, run

    _cell, config, mix, limits, _pl, _e2e = run.load_cell(BENCH, workload)
    for scope in kinds.load(KIND[workload]).CONTROLS:
        for seed in (1_000_000_001, 2_000_000_002, 3_000_000_003):
            numbers = control.control_run(config, mix, limits, seed, 40, cuda_device,
                                          scope).numbers()
            assert any(numbers[k] > limits[k] for k in numbers), (scope, seed, numbers)


@pytest.mark.card
@pytest.mark.parametrize("workload,fault", KERNEL_FAULTS)
def test_a_kernel_fault_is_not_correct(cuda_device, workload, fault):
    proc = subprocess.run(
        [sys.executable, "portbench/faults.py", "--workload", workload, "--fault", fault,
         "--seeds", "2718281829", "--seconds", "3"],
        capture_output=True, text=True, cwd=HERE.parent, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["compared"] > 0 and not result["correct"], result
