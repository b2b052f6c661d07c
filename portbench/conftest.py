"""Shared fixtures of the benchmark's tests: tiny configurations and mixes
for CPU runs of the harness, and the card marker.

Tests marked ``card`` run the benchmark on a CUDA device and skip without
one; whether there is one is decided inside the ``cuda_device`` fixture,
never while a module is imported.  On the chip they run as
``python -m pytest portbench -m card``.
"""

import copy
import json
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skipped without one)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the port on the card")
    return torch.device("cuda", 0)


def _config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def tiny_config(kind):
    """A configuration file's structure at widths a CPU test can hold."""
    cfg = _config("glowtts-harvard.hifigan-ul" if kind == "hifi_gan"
                  else "glowtts-harvard.waveglow-256")
    cfg["acoustic"].update(hidden_channels=16, filter_channels=32, filter_channels_dp=16,
                           n_layers_enc=2, n_blocks_dec=2, n_block_layers=2)
    if kind == "hifi_gan":
        cfg["vocoder"].update(upsample_initial_channel=32)
    else:
        cfg["vocoder"].update(wn_channels=64, wn_layers=4, flows=4, early_every=2)
    return cfg


def tiny_mix(name):
    """A traffic file with short sentences, a small deck and a short warm-up."""
    mix = copy.deepcopy(json.loads((HERE / "traffic" / f"{name}.json").read_text()))
    mix["lengths"] = {"law": "lognormal", "median": 12, "sigma": 0.4, "min": 5, "max": 30}
    mix["deck"] = 8
    mix["frames_per_id"] = 2.5
    mix["warm_seconds"] = 0.3
    return mix


E2E = {"rtf": "s/s", "setup_s": "s"}
