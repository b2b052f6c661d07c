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
                        lambda *args, **kwargs: types.SimpleNamespace(vocoder_kind="waveglow"))
    list(larynx_tpu_torch.stream_text_to_speech("Hello.", device="cpu"))


@pytest.mark.parametrize("call", [
    lambda mp: larynx_tpu_torch.text_to_speech("Hello.", device="cpu", interleaved_batching=True),
    lambda mp: larynx_tpu_torch.get_vocoder_model("griffin_lim"),
    _stream_waveglow,
], ids=["interleaved", "griffin_lim", "stream-waveglow"])
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


def _stage(c=8, dtype=torch.float32):
    gen = torch.Generator().manual_seed(0)
    conv = lambda k: {"w": (torch.randn((c, c, k), generator=gen) * 0.1).to(dtype),  # noqa: E731
                      "b": (torch.randn(c, generator=gen) * 0.1).to(dtype)}
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mrf_wrapper_launches_or_raises_for_cuda(monkeypatch, dtype):
    """A CUDA tensor goes to the kernel, in either dtype: when the kernel
    cannot be had, the wrapper raises instead of falling back to the plain
    version, to float32 or to the CPU."""

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
    CudaLike.dtype = dtype
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        mrf_block.mrf_section(CudaLike(), _stage(dtype=dtype))


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


@pytest.mark.parametrize("x_dtype,stage_dtype", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16),
    (torch.float64, torch.float64), (torch.float16, torch.float16),
], ids=["bf16-x-f32-stage", "f32-x-bf16-stage", "f64", "f16"])
def test_mrf_wrapper_rejects_mixed_and_other_dtypes(x_dtype, stage_dtype):
    """x, wpack and b_flat all float32 or all bfloat16: any mix, or another
    dtype, raises before any launch."""
    stage = _stage(dtype=stage_dtype)
    with pytest.raises(TypeError, match="all float32 or all bfloat16"):
        mrf_block._check(torch.zeros((1, 50, 8), dtype=x_dtype), stage)
    # a stage with one tensor in the other dtype
    mixed = dataclasses.replace(_stage(), b_flat=_stage().b_flat.bfloat16())
    with pytest.raises(TypeError, match="b_flat"):
        mrf_block._check(torch.zeros((1, 50, 8)), mixed)


def test_mrf_wrapper_takes_bf16():
    """The bfloat16 stage (one weight plane, input channels zero-padded to a
    16-channel k-step at C=8) passes the kernel's checks."""
    stage = _stage(dtype=torch.bfloat16)
    assert stage.wpack.dtype == torch.bfloat16
    assert stage.wpack.numel() == 126 * 16 * 8  # 126 taps of 16 inputs x 8 outputs
    mrf_block._check(torch.zeros((1, 50, 8), dtype=torch.bfloat16), stage)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_wn_wrappers_launch_or_raise_for_cuda_in_either_dtype(monkeypatch, dtype):
    """A CUDA tensor of either dtype goes to the WN kernel: no plain
    fallback when the library cannot be had."""
    from larynx_tpu_torch.ops import wn_layer

    gen = torch.Generator().manual_seed(1)
    n = lambda *shape: (torch.randn(shape, generator=gen) * 0.05).to(dtype)  # noqa: E731
    layer = wn_layer.pack_wn_layer(n(512, 256, 3), n(512), n(512, 640), n(512), n(512, 256),
                                   n(512))
    assert layer.wpack.dtype == dtype

    class CudaLike:
        device = torch.device("cuda", 0)
        shape = (1, 40, 256)

    def no_plain(*args, **kwargs):
        raise AssertionError("plain version taken for a CUDA tensor")

    def no_library():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(wn_layer, "wn_layer_plain", no_plain)
    monkeypatch.setattr(wn_layer, "wn_layer_state_plain", no_plain)
    monkeypatch.setattr(wn_layer, "_check", lambda *args: None)
    monkeypatch.setattr(wn_layer, "_library", no_library)
    CudaLike.dtype = dtype
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        wn_layer.fused_wn_layer_state(CudaLike(), CudaLike(), None, layer, dilation=1, first=True)


@pytest.mark.parametrize("h_dtype,layer_dtype", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16), (torch.float64, torch.float64),
], ids=["bf16-h-f32-layer", "f32-h-bf16-layer", "f64"])
def test_wn_wrappers_reject_mixed_and_other_dtypes(h_dtype, layer_dtype):
    from larynx_tpu_torch.ops import wn_layer

    gen = torch.Generator().manual_seed(2)
    n = lambda *shape: (torch.randn(shape, generator=gen) * 0.05).to(layer_dtype)  # noqa: E731
    layer = wn_layer.pack_wn_layer(n(512, 256, 3), n(512), n(512, 640), n(512), n(512, 256),
                                   n(512))
    h = torch.zeros((1, 40, 256), dtype=h_dtype)
    cond = torch.zeros((1, 40, 640), dtype=h_dtype)
    with pytest.raises(TypeError):
        wn_layer._check(h, cond, None, layer, 512, 1)
