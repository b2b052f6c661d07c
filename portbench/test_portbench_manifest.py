"""BENCHMARK.json against the benchmark's contract, the import guard, and
the data-driven layout: a configuration, mix or metric added as a file is
found by its name with no edit to the harness."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run
from portbench.harness import cell as harness_cell

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def manifest():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_names_and_units():
    b = manifest()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]] \
        + [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    refs = [w["traffic"] for w in b["workloads"]] + [w["config"] for w in b["workloads"]]
    for name in names + refs:
        assert NAME.match(name), name
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for c in b["configs"]:
        assert (REPO / c["file"]).is_file() and c["file"].startswith("portbench/")
        assert json.loads((REPO / c["file"]).read_text())["reduced"] == c["reduced"]
    assert len(json.dumps(b).encode()) <= 64 * 1024


def test_every_cell_reports_what_its_metrics_move():
    b = manifest()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in b["end_to_end"]}
    for name in cells:
        assert name in e2e["setup_s"]
        assert sum(name in ws for metric, ws in e2e.items() if metric != "setup_s") >= 1
        assert any(name in m["workloads"] for m in b["per_layer"])
    for m in b["per_layer"]:
        assert m["workloads"], m["name"]
        for name in m["workloads"]:
            assert name in e2e[m["moves"]], (m["name"], name)
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
    for w in b["workloads"]:
        assert w["chips"] == 1
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert (HERE / "limits" / f"{w['name']}.json").is_file()
        assert len(w["why"]) <= 200


def _kinds():
    out = set()
    for c in manifest()["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        out |= {cfg["acoustic"]["kind"], cfg["vocoder"]["kind"]}
    return sorted(out)


def _entries():
    return sorted({json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())["entry"]
                   for w in manifest()["workloads"]})


def test_kinds_and_entries_are_found_by_name():
    from portbench import entries, kinds

    for kind in _kinds():
        module = kinds.load(kind)
        assert callable(module.weights) and callable(module.flops) and ":" in module.PORT_CONFIG
    for entry in _entries():
        module = entries.load(entry)
        for fn in ("warm", "window", "end_to_end", "context", "compare", "control"):
            assert callable(getattr(module, fn)), (entry, fn)
    for bad in ("tacotron2", "../harness/cell", ""):
        with pytest.raises(ValueError):
            kinds.load(bad)
        with pytest.raises(ValueError):
            entries.load(bad)


def test_nothing_loaded_is_jax_or_the_jax_package():
    """Every module the run loads, the port's engine with it, compared by
    top-level name whole: larynx_tpu_torch is not larynx_tpu."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import portbench.run, portbench.harness.cell, portbench.control, portbench.faults\n"
        "from portbench import kinds, entries\n"
        "for k in %r: kinds.load(k)\n"
        "for e in %r: entries.load(e)\n"
        "from portbench.harness import cell\n"
        "for name in %r: cell.load_reader(name)\n"
        "import larynx_tpu_torch.runtime.engine\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n"
    ) % (str(REPO), _kinds(), _entries(), [m["name"] for m in manifest()["per_layer"]])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=REPO).stdout.split()
    assert "larynx_tpu_torch" in out
    for name in harness_cell.FORBIDDEN:
        assert name not in out, name
    assert harness_cell.forbidden_modules() == sorted(set(harness_cell.FORBIDDEN) & {
        m.split(".")[0] for m in sys.modules})


def test_nothing_reads_the_jax_bench():
    for path in HERE.rglob("*.py"):
        text = path.read_text()
        for word in ("bench.py", "BENCH_", "bench_artifacts"):
            assert word not in text or path.name.startswith("test_"), (path, word)


def test_added_files_are_found_by_name(tmp_path):
    """A copy of the benchmark with a new configuration, mix, metric and cell
    added as files and entries: the loader finds each by name."""
    root = tmp_path / "repo"
    shutil.copytree(HERE, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    b = manifest()
    cfg = json.loads((HERE / "configs" / "glowtts-harvard.hifigan-ul.json").read_text())
    cfg["vocoder"]["upsample_initial_channel"] = 256
    (root / "portbench" / "configs" / "glowtts-harvard.hifigan-x.json").write_text(json.dumps(cfg))
    mix = json.loads((HERE / "traffic" / "batch8.json").read_text())
    mix["batch"] = 16
    (root / "portbench" / "traffic" / "batch16.json").write_text(json.dumps(mix))
    (root / "portbench" / "limits" / "x_batch16.json").write_text(json.dumps(
        {"sample": 4, "length_mismatch": 0, "audio_err": 0.1, "failed": 0}))
    (root / "portbench" / "metrics" / "rows.batch16.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    b["configs"].append({"name": "glowtts-harvard.hifigan-x", "source": "x",
                         "file": "portbench/configs/glowtts-harvard.hifigan-x.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "x_batch16", "config": "glowtts-harvard.hifigan-x",
                           "traffic": "batch16", "chips": 1, "why": "x"})
    b["end_to_end"].append({"name": "rows_per_s", "unit": "rows/s", "better": "higher",
                            "bound": 0.25, "source": "host_clock", "workloads": ["x_batch16"]})
    b["per_layer"].append({"name": "rows.batch16", "unit": "rows", "better": "higher",
                           "source": "program_counter", "layer": "engine vocode",
                           "moves": "rows_per_s", "workloads": ["x_batch16"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    old = run.REPO, run.HERE
    run.REPO, run.HERE = root, root / "portbench"
    try:
        _cell, config, mix2, limits, per_layer, e2e = run.load_cell(b, "x_batch16")
    finally:
        run.REPO, run.HERE = old
    assert config["vocoder"]["upsample_initial_channel"] == 256
    assert mix2["batch"] == 16 and limits["audio_err"] == 0.1
    assert set(e2e) == {"rows_per_s", "setup_s"} and set(per_layer) == {"rows.batch16"}
    old_root = harness_cell.ROOT
    harness_cell.ROOT = root / "portbench"
    try:
        assert harness_cell.load_reader("rows.batch16")(None) == 42.0
    finally:
        harness_cell.ROOT = old_root


def test_without_the_program_the_run_fails(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's files
    gives no result and a non-zero exit."""
    shutil.copytree(HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "ul_batch8",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout
