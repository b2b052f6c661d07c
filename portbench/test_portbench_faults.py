"""Whole runs of the harness on the CPU at tiny widths (the look for a card
skipped), with the timed path broken underneath (``faults.py``): each fault
that a cell can have comes out ``correct: false`` at that cell's own limits
(``limits/<cell>.json``), and the sound path comes out correct."""

import json
import time
from pathlib import Path

import pytest
import torch

from portbench import faults
from portbench.conftest import E2E, tiny_config, tiny_mix
from portbench.harness import cell

HERE = Path(__file__).resolve().parent
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
CELLS = {w["name"]: w for w in BENCH["workloads"]}
KIND = {c["name"]: json.loads((HERE.parent / c["file"]).read_text())["vocoder"]["kind"]
        for c in BENCH["configs"]}


def run(workload, seed=4_000_000_123):
    w = CELLS[workload]
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    result, compared = cell.run_cell(
        {"name": workload, "end_to_end": E2E}, tiny_config(KIND[w["config"]]),
        tiny_mix(w["traffic"]), limits, {}, seed, 0.6, False, torch.device("cpu"),
        time.perf_counter())
    assert compared > 0
    return result


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_sound_path_is_correct(workload):
    result = run(workload)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in sorted(CELLS) for f in sorted(faults.FAULTS)
    if faults.applies(f, KIND[CELLS[w]["config"]])])
def test_a_planted_fault_is_not_correct(workload, fault):
    with faults.planted(fault):
        result = run(workload)
    assert not result["correct"], result["checks"]


def test_every_fault_applies_to_some_cell():
    kinds = set(KIND.values())
    assert all(any(faults.applies(f, k) for k in kinds) for f in faults.FAULTS)


def test_a_fault_is_taken_out_again():
    from larynx_tpu_torch.models.waveglow import model

    before = model.fused_wn_layer_state
    with faults.planted("wn_state_unchanged"):
        assert model.fused_wn_layer_state is not before
    assert model.fused_wn_layer_state is before
