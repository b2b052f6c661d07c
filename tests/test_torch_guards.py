"""Guards of the port: no JAX anywhere in it, no silent CPU run, no kernel fallback."""

import ast
import dataclasses
import types
from pathlib import Path

import pytest
import torch

import larynx_tpu_torch
import larynx_tpu_torch.__main__ as cli
from larynx_tpu_torch.device import resolve_device
from larynx_tpu_torch.ops import mrf_block

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "larynx_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            for arg in node.args:
                if isinstance(arg, ast.Constant):
                    yield str(arg.value)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_larynx_tpu(path):
    for name in _imported_modules(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "larynx_tpu", "flax", "optax"), (
            f"{path.relative_to(REPO)} imports {name}"
        )


def test_no_cuda_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    # raises at the call, before any voice is looked up or any work is done
    with pytest.raises(RuntimeError, match="device='cpu'"):
        larynx_tpu_torch.text_to_speech("Hello.", custom_voices_dir="/nonexistent")
    assert resolve_device("cpu") == torch.device("cpu")


def _stream_waveglow(monkeypatch):
    """stream_text_to_speech on a sentence whose engine has a WaveGlow vocoder."""
    job = {"tts_model": None, "vocoder_model": None, "ids": None}
    monkeypatch.setattr(larynx_tpu_torch, "_build_jobs", lambda *args, **kwargs: [job])
    monkeypatch.setattr(larynx_tpu_torch, "_get_engine",
                        lambda *args: types.SimpleNamespace(vocoder_kind="waveglow"))
    list(larynx_tpu_torch.stream_text_to_speech("Hello.", device="cpu"))


@pytest.mark.parametrize("call", [
    lambda mp: larynx_tpu_torch.text_to_speech("Hello.", device="cpu", half=True),
    lambda mp: larynx_tpu_torch.text_to_speech("Hello.", device="cpu", interleaved_batching=True),
    lambda mp: larynx_tpu_torch.stream_text_to_speech("Hello.", device="cpu", half=True),
    lambda mp: larynx_tpu_torch.get_vocoder_model("griffin_lim"),
    _stream_waveglow,
], ids=["half", "interleaved", "stream-half", "griffin_lim", "stream-waveglow"])
def test_unported_options_raise(monkeypatch, call):
    with pytest.raises(NotImplementedError):
        call(monkeypatch)


@pytest.mark.parametrize("flag", ["--daemon", "--stop-daemon"])
def test_cli_daemon_exits_non_zero(flag, caplog):
    """The daemon needs the HTTP server, which is not ported."""
    with pytest.raises(SystemExit) as exit_info:
        cli.main([flag, "--device", "cpu", "Hello."])
    assert exit_info.value.code not in (0, None)
    assert "the HTTP server is not ported yet" in caplog.text


def _stage(c=8):
    gen = torch.Generator().manual_seed(0)
    conv = lambda k: {"w": torch.randn((c, c, k), generator=gen) * 0.1,  # noqa: E731
                      "b": torch.randn(c, generator=gen) * 0.1}
    return mrf_block.pack_mrf_stage(
        [{"convs1": [conv(k) for _ in range(3)], "convs2": [conv(k) for _ in range(3)]}
         for k in (3, 7, 11)]
    )


def test_mrf_wrapper_runs_plain_only_on_cpu(monkeypatch):
    stage = _stage()
    x = torch.randn((1, 50, 8), generator=torch.Generator().manual_seed(1))
    before = mrf_block.mrf_section.launches
    out = mrf_block.mrf_section(x, stage)
    ref = mrf_block.mrf_section_plain(x, stage.w_flat, stage.b_flat)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert mrf_block.mrf_section.launches == before  # the CPU path launches nothing

    # a tensor on another device never reaches the plain version
    def no_plain(*args, **kwargs):
        raise AssertionError("plain version taken for a non-CPU tensor")

    monkeypatch.setattr(mrf_block, "mrf_section_plain", no_plain)
    with pytest.raises(ValueError, match="cpu or cuda"):
        mrf_block.mrf_section(x.to("meta"), stage)


def test_mrf_wrapper_launches_or_raises_for_cuda(monkeypatch):
    """A CUDA tensor goes to the kernel: when the kernel cannot be had, the
    wrapper raises instead of falling back to the plain version."""

    class CudaLike:
        device = torch.device("cuda", 0)
        shape = (1, 50, 8)

    def no_plain(*args, **kwargs):
        raise AssertionError("plain version taken for a CUDA tensor")

    def no_library():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(mrf_block, "mrf_section_plain", no_plain)
    monkeypatch.setattr(mrf_block, "_check", lambda *args: None)
    monkeypatch.setattr(mrf_block, "_library", no_library)
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        mrf_block.mrf_section(CudaLike(), _stage())


def test_mrf_wrapper_rejects_what_the_kernel_does_not_take():
    stage = _stage()
    x = torch.zeros((1, 50, 8))
    mrf_block._check(x, stage)
    with pytest.raises(TypeError):
        mrf_block._check(x.double(), stage)
    with pytest.raises(NotImplementedError):
        mrf_block._check(torch.zeros((1, 50, 24)), stage)
    with pytest.raises(ValueError, match="wpack"):
        mrf_block._check(x, dataclasses.replace(stage, wpack=stage.wpack[:-1]))
    with pytest.raises(ValueError, match="without the kernel's weights"):
        mrf_block._check(x, dataclasses.replace(stage, wpack=None))
    # a unit whose raw tile would pass the TMA box limit (128 + 10 * 13 rows)
    wide = mrf_block.pack_mrf_stage(
        [{"convs": [{"w": torch.zeros((8, 8, 11)), "b": torch.zeros(8)}]}], (11,), ((13,),), 1)
    with pytest.raises(NotImplementedError, match="258 input rows"):
        mrf_block._check(x, wide)
    with pytest.raises(ValueError, match="contiguous"):
        mrf_block._check(torch.zeros((1, 8, 50)).transpose(1, 2), stage)
