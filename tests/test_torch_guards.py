"""Guards of the port: no JAX anywhere in it, no silent CPU run, no kernel fallback."""

import ast
import dataclasses
import io
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import larynx_tpu_torch
import larynx_tpu_torch.__main__ as cli
from larynx_tpu_torch.device import resolve_device
from larynx_tpu_torch.io import wavfile
from larynx_tpu_torch.ops import mrf_block

from test_torch_pipeline import VOCODER, VOICE, voices_dir  # noqa: F401

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


def _interleaved_runs():
    """Interleaved batching is ported: the call returns its results'
    iterator, which fails only on the missing voice."""
    results = larynx_tpu_torch.text_to_speech(
        "Hello.", device="cpu", interleaved_batching=True, custom_voices_dir="/nonexistent",
        no_download=True)
    with pytest.raises(RuntimeError, match="Failed to load voice"):
        list(results)


T2_CONFIG = dict(
    num_symbols=12, symbols_embedding_dim=16, encoder_embedding_dim=16, encoder_n_convolutions=1,
    prenet_dim=8, attention_rnn_dim=16, decoder_rnn_dim=16, attention_dim=8,
    attention_location_n_filters=4, attention_location_kernel_size=5, postnet_embedding_dim=16,
    postnet_n_convolutions=2, mel_channels=10, max_decoder_steps=12,
)


def _stage_tacotron2(model_dir: Path) -> Path:
    """A small Tacotron2 voice dir (random weights, gate off, so every
    decode runs its max_decoder_steps)."""
    from larynx_tpu_torch.convert.native import save_params
    from larynx_tpu_torch.models.tacotron2 import Tacotron2Config
    from larynx_tpu_torch.weights import init_params

    model_dir.mkdir(parents=True, exist_ok=True)
    (model_dir / "config.json").write_text(json.dumps({"audio": {}, "model": T2_CONFIG}))
    tree = init_params(torch.Generator().manual_seed(0), Tacotron2Config(**T2_CONFIG))
    tree["decoder"]["gate"]["b"][:] = -50.0
    save_params(model_dir / "generator.npz", tree)
    return model_dir


def _tacotron2_runs():
    """Tacotron2 is ported: a voice dir loads and decodes on the CPU."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        model = larynx_tpu_torch.load_tts_model("tacotron2", _stage_tacotron2(Path(tmp)))
    mels = model.phonemes_to_mels(np.array([1, 2, 3, 4]), device="cpu")
    assert mels.shape == (1, 10, 12) and np.isfinite(mels).all()


# required arguments of the training CLIs, on paths that do not exist; an
# unported option raises before any of them is read
TRAIN_ARGV = ["--metadata", "/nonexistent/metadata.csv", "--wav-dir", "/nonexistent",
              "--output-dir", "/nonexistent/voice", "--phonemes", "/nonexistent/phonemes.txt",
              "--device", "cpu"]
VOCODER_ARGV = ["--wav-dir", "/nonexistent", "--out-dir", "/nonexistent/vocoder",
                "--device", "cpu"]


def _train_family_tacotron2_starts():
    """Tacotron2 training is ported: it fails on the missing data, not as
    unported.  The training mesh is ported: ``--model-parallel 2`` run alone
    (a world of 1) exits naming the world size; under a world of 2 it runs
    (``tests/test_torch_distributed_training.py``)."""
    from larynx_tpu_torch import train

    with pytest.raises((SystemExit, FileNotFoundError)):
        train.main(TRAIN_ARGV + ["--family", "tacotron2"])
    with pytest.raises(SystemExit, match="world size 1"):
        train.main(TRAIN_ARGV + ["--model-parallel", "2"])


def _train_vocoder_family_waveglow_starts():
    """WaveGlow training is ported: it fails on the missing wavs."""
    from larynx_tpu_torch import train_vocoder

    with pytest.raises((SystemExit, FileNotFoundError)):
        train_vocoder.main(VOCODER_ARGV + ["--family", "waveglow"])


@pytest.mark.parametrize("call", [_interleaved_runs, _tacotron2_runs,
                                  _train_family_tacotron2_starts,
                                  _train_vocoder_family_waveglow_starts],
                         ids=["interleaved", "tacotron2", "train --family tacotron2",
                              "train_vocoder --family waveglow"])
def test_unported_options_raise(call):
    """What is not ported raises NotImplementedError; what is, runs."""
    call()


def test_serving_mesh_never_repeats_a_device(monkeypatch):
    """``serving_mesh()`` builds a mesh of distinct cards or none: on one
    card, and on the CPU, it is None, so ``text_to_speech`` stays on the
    single-device path there; a repeated-device mesh is only ever the
    caller's own."""
    from larynx_tpu_torch.parallel.mesh import serving_mesh

    assert serving_mesh() is None  # the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for count in range(0, 10):
        monkeypatch.setattr(torch.cuda, "device_count", lambda c=count: c)
        mesh = serving_mesh()
        if count < 2:
            assert mesh is None
        else:
            assert len(set(mesh.positions)) == len(mesh.positions) >= 2
            assert all(d.type == "cuda" and d.index < count for d in mesh.positions)


# the training path: the four trainers and their CLIs
TRAINING_MODULES = ["larynx_tpu_torch.train", "larynx_tpu_torch.train_vocoder",
                    "larynx_tpu_torch.parallel.train", "larynx_tpu_torch.models.glow_tts.training",
                    "larynx_tpu_torch.models.tacotron2.training",
                    "larynx_tpu_torch.models.glow_tts.data",
                    "larynx_tpu_torch.models.hifi_gan.training",
                    "larynx_tpu_torch.models.hifi_gan.discriminators"]


@pytest.mark.parametrize("module", TRAINING_MODULES)
def test_training_loads_neither_jax_nor_larynx_tpu(module, imports_added):
    _loads_neither_jax_nor_larynx_tpu(module, imports_added)


@pytest.mark.parametrize("cli_name", ["train", "train_vocoder"])
def test_training_clis_without_gpu_or_device_raise(monkeypatch, cli_name):
    """With no GPU and no ``--device cpu`` both CLIs raise before reading
    their data."""
    import importlib

    module = importlib.import_module(f"larynx_tpu_torch.{cli_name}")
    argv = [a for a in (TRAIN_ARGV if cli_name == "train" else VOCODER_ARGV)
            if a not in ("--device", "cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            module.main(argv + extra)


def test_hifi_gan_vocoder_on_cuda_runs_the_mrf_kernel_not_the_training_path(
        voices_dir, monkeypatch):  # noqa: F811
    """The loader's params for a CUDA device (built on the CPU here) carry a
    packed MRF stage for every stage of C <= 128, so its generator calls
    ``mrf_section`` (the kernel's wrapper, one launch per unit on CUDA) and
    never the unfused resblocks that the GAN trainer's unpacked params run."""
    from larynx_tpu_torch import hifi_gan
    from larynx_tpu_torch.models.hifi_gan import model as hifi_model

    vocoder = larynx_tpu_torch.load_vocoder_model(larynx_tpu_torch.VocoderType.HIFI_GAN,
                                                  voices_dir / VOCODER)
    monkeypatch.setattr(hifi_gan, "tree_to", lambda tree, device: tree)
    packed = vocoder._packed.get(torch.device("cuda"), torch.float32)
    channels = [up["w"].shape[1] for up in packed["ups"]]
    assert [stage is not None for stage in packed["mrf"]] == [c <= 128 for c in channels]

    calls = []
    real = hifi_model.mrf_section
    monkeypatch.setattr(hifi_model, "mrf_section",
                        lambda x, stage: calls.append(x.shape[-1]) or real(x, stage))

    def unfused(*args, **kwargs):
        raise AssertionError("the vocoder reached the unfused training path")

    monkeypatch.setattr(hifi_model, "_resblock1", unfused)
    monkeypatch.setattr(hifi_model, "_resblock2", unfused)
    audio = hifi_model.generator(packed, vocoder.model_config, torch.zeros((1, 8, 80)))
    assert audio.shape == (1, 8 * vocoder.model_config.total_upsample)
    assert calls == channels


SLICE_MODULES = ["larynx_tpu_torch.server", "larynx_tpu_torch.server.app",
                 "larynx_tpu_torch.server.__main__", "larynx_tpu_torch.dsp.ipa_synth",
                 "larynx_tpu_torch.griffin_lim", "larynx_tpu_torch.models.griffin_lim"]


# the batch path (_run_jobs, pooling, the predicted bucket, the lengths'
# copy) and multi-speaker GlowTTS
BATCH_PATH_MODULES = ["larynx_tpu_torch", "larynx_tpu_torch.runtime.engine",
                      "larynx_tpu_torch.runtime.scheduler", "larynx_tpu_torch.device",
                      "larynx_tpu_torch.weights", "larynx_tpu_torch.glow_tts",
                      "larynx_tpu_torch.models.glow_tts.model",
                      "larynx_tpu_torch.models.glow_tts.flows"]


# One fresh interpreter imports the modules in turn and reports, for each,
# the jax/jaxlib/larynx_tpu modules that its import added to sys.modules (any
# present at startup count as added by the first), and the import's error.
_IMPORTS_ADDED = r"""
import importlib, json, sys
sys.path[:0] = json.loads(sys.argv[1])
seen, report = set(), {}
for module in json.loads(sys.argv[2]):
    try:
        importlib.import_module(module)
        error = None
    except BaseException as exc:
        error = repr(exc)
    now = {m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "larynx_tpu")}
    report[module] = {"added": sorted(now - seen), "error": error}
    seen |= now
print(json.dumps(report))
"""


def _imports_added(modules, path=()):
    """``{module: {"added": [...], "error": ...}}`` from one fresh interpreter
    that imports ``modules`` in order, with ``path`` put first on sys.path."""
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORTS_ADDED, json.dumps([str(p) for p in path]),
         json.dumps(list(modules))],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _loads_neither_jax_nor_larynx_tpu(module, report):
    """Imported in a fresh interpreter, the module brings in no module of
    jax or of larynx_tpu, directly or through what it imports: where one
    did, the first module whose import pulled it in is the one that fails."""
    assert report[module] == {"added": [], "error": None}, (module, report[module])


# Tacotron2 and checkpoint import
TACOTRON2_IMPORT_MODULES = ["larynx_tpu_torch.tacotron2", "larynx_tpu_torch.models.tacotron2",
                            "larynx_tpu_torch.convert.torch_import",
                            "larynx_tpu_torch.convert.onnx_import"]


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_server_and_griffin_lim_load_neither_jax_nor_larynx_tpu(module, imports_added):
    _loads_neither_jax_nor_larynx_tpu(module, imports_added)


@pytest.mark.parametrize("module", BATCH_PATH_MODULES)
def test_batch_path_and_multispeaker_load_neither_jax_nor_larynx_tpu(module, imports_added):
    _loads_neither_jax_nor_larynx_tpu(module, imports_added)


@pytest.mark.parametrize("module", TACOTRON2_IMPORT_MODULES)
def test_tacotron2_and_import_load_neither_jax_nor_larynx_tpu(module, imports_added):
    _loads_neither_jax_nor_larynx_tpu(module, imports_added)


# the multi-device layer: the serving mesh, the time and grid shards, the
# sharded synthesis step
MESH_MODULES = ["larynx_tpu_torch.parallel.mesh", "larynx_tpu_torch.parallel.time_shard",
                "larynx_tpu_torch.parallel.serve"]


@pytest.mark.parametrize("module", MESH_MODULES)
def test_mesh_modules_load_neither_jax_nor_larynx_tpu(module, imports_added):
    _loads_neither_jax_nor_larynx_tpu(module, imports_added)


@pytest.fixture(scope="module")
def imports_added():
    """The import report of every guarded module, from one interpreter."""
    return _imports_added(TRAINING_MODULES + SLICE_MODULES + BATCH_PATH_MODULES
                          + TACOTRON2_IMPORT_MODULES + MESH_MODULES)


def test_the_shared_import_guard_names_the_module_that_pulls_in_jax(tmp_path):
    """The one interpreter fails where a fresh interpreter per module did: a
    module that imports jax through a second module is named, the modules
    before it pass, and the second module, imported after it, adds nothing."""
    (tmp_path / "guard_outer.py").write_text("import guard_inner  # noqa: F401\n")
    (tmp_path / "guard_inner.py").write_text("import jax  # noqa: F401\n")
    report = _imports_added(["larynx_tpu_torch.device", "guard_outer", "guard_inner"],
                            path=[tmp_path])
    _loads_neither_jax_nor_larynx_tpu("larynx_tpu_torch.device", report)
    assert "jax" in report["guard_outer"]["added"] and report["guard_outer"]["error"] is None
    with pytest.raises(AssertionError, match="guard_outer"):
        _loads_neither_jax_nor_larynx_tpu("guard_outer", report)
    assert report["guard_inner"] == {"added": [], "error": None}


def test_tacotron2_phonemes_to_mels_without_gpu_or_device_raises(monkeypatch, tmp_path):
    model = larynx_tpu_torch.load_tts_model("tacotron2", _stage_tacotron2(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.phonemes_to_mels(np.array([1, 2, 3]))


def test_create_app_without_gpu_or_device_raises(monkeypatch):
    from larynx_tpu_torch.server.app import ServerSettings, create_app

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_app(ServerSettings(voices_dir="/nonexistent"))


def test_server_main_without_gpu_fails_and_leaves_no_pidfile(monkeypatch, tmp_path):
    from larynx_tpu_torch.server import __main__ as server_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pidfile = tmp_path / "server.pid"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        server_main.main(["--voices-dir", str(tmp_path), "--pidfile", str(pidfile),
                          "--port", "0"])
    assert not pidfile.exists()


def _model_calls(voices):
    from larynx_tpu_torch.griffin_lim import GriffinLimVocoder

    mel = np.zeros((1, 80, 8), dtype=np.float32)
    return {
        "phonemes_to_mels": lambda: larynx_tpu_torch.get_tts_model(
            VOICE, custom_voices_dir=voices, no_download=True).phonemes_to_mels(
            np.array([1, 2, 3])),
        "hifi_gan": lambda: larynx_tpu_torch.load_vocoder_model(
            larynx_tpu_torch.VocoderType.HIFI_GAN, voices / VOCODER).mels_to_audio(mel),
        "hifi_gan denoiser": lambda: larynx_tpu_torch.load_vocoder_model(
            larynx_tpu_torch.VocoderType.HIFI_GAN, voices / VOCODER).maybe_init_denoiser(),
        "griffin_lim": lambda: GriffinLimVocoder().mels_to_audio(mel),
    }


@pytest.mark.parametrize("name", ["phonemes_to_mels", "hifi_gan", "hifi_gan denoiser",
                                  "griffin_lim"])
def test_model_surfaces_without_gpu_or_device_raise(voices_dir, monkeypatch, name):  # noqa: F811
    """The per-model surfaces take the device as the entry points do: with
    no GPU and no device they raise before any work."""
    call = _model_calls(voices_dir)[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def test_waveglow_mels_to_audio_without_gpu_or_device_raises(monkeypatch, tmp_path):
    from larynx_tpu_torch.convert.native import save_params
    from larynx_tpu_torch.models.waveglow.config import WaveGlowConfig
    from larynx_tpu_torch.waveglow import WaveGlowVocoder
    from larynx_tpu_torch.weights import init_params

    cfg = WaveGlowConfig(mel_channels=8, flows=2, groups=8, early_every=2, early_size=2,
                         wn_channels=32, wn_layers=2, upsample_kernel=128, upsample_stride=64)
    (tmp_path / "config.json").write_text(json.dumps(dataclasses.asdict(cfg)))
    save_params(tmp_path / "generator.npz", init_params(torch.Generator().manual_seed(0), cfg))
    vocoder = WaveGlowVocoder(tmp_path)
    mel = np.zeros((1, 8, 4), dtype=np.float32)
    assert vocoder.mels_to_audio(mel, device="cpu").shape == (4 * 64,)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: vocoder.mels_to_audio(mel), vocoder.maybe_init_denoiser):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


@pytest.fixture
def daemon_voices(voices_dir, tmp_path, monkeypatch):  # noqa: F811
    """The voices dir with its vocoder as "low", and a runtime dir of the
    test's own (the daemon's pidfile and log)."""
    low = voices_dir / "hifi_gan" / "vctk_small"
    if not low.exists():
        low.symlink_to(voices_dir / VOCODER)
    monkeypatch.setenv("XDG_RUNTIME_DIR", str(tmp_path))
    return voices_dir


def test_cli_daemon_round_trip_on_cpu(daemon_voices, capsysbinary, caplog):
    """--daemon --device cpu starts the port's server in the background,
    synthesises through it (the library's audio within 2 LSB), reuses it
    for a second call, and --stop-daemon stops it and removes its pidfile."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    argv = ["Hello from the daemon.", "--daemon", "--daemon-port", str(port), "--device", "cpu",
            "--voices-dir", str(daemon_voices), "--voice", VOICE, "--quality", "low",
            "--noise-scale", "0", "--denoiser-strength", "0.005"]
    pidfile = Path(os.environ["XDG_RUNTIME_DIR"]) / "larynx" / cli.DAEMON_PIDFILE
    try:
        cli.main(argv)
        first = capsysbinary.readouterr().out
        pid = int(pidfile.read_text())
        cli.main(argv)  # reuses the running daemon
        second = capsysbinary.readouterr().out
        assert int(pidfile.read_text()) == pid
    finally:
        with pytest.raises(SystemExit) as exit_info:
            cli.main(["--stop-daemon"])
    assert exit_info.value.code == 0
    assert not pidfile.exists()
    # the daemon is this process's child here: reap it (a CLI process that
    # spawned it would have exited)
    deadline, reaped = time.monotonic() + 10, 0
    while not reaped and time.monotonic() < deadline:
        try:
            reaped = os.waitpid(pid, os.WNOHANG)[0]
        except ChildProcessError:  # already reaped by the subprocess module
            reaped = pid
        time.sleep(0.1)
    assert reaped == pid and not cli._pid_alive(pid)

    rate, audio = wavfile.read(io.BytesIO(first))
    assert rate == 22050 and first == second
    want = next(iter(larynx_tpu_torch.text_to_speech(
        "Hello from the daemon.", voice_or_lang=VOICE, vocoder_or_quality="low",
        custom_voices_dir=daemon_voices, no_download=True, device="cpu",
        tts_settings={"noise_scale": 0.0}, denoiser_strength=0.005))).audio
    assert audio.shape == want.shape and np.abs(audio.astype(np.int32)).max() > 1000
    assert np.abs(audio.astype(np.int32) - want.astype(np.int32)).max() <= 2


def test_cli_daemon_that_cannot_start_fails_fast(daemon_voices, tmp_path):
    """A daemon whose server exits (no GPU behind --device cuda) makes the
    CLI exit non-zero at once instead of waiting for it."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    start = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "larynx_tpu_torch", "Hello.", "--daemon", "--daemon-port",
         str(port), "--device", "cuda", "--voices-dir", str(daemon_voices)],
        capture_output=True, cwd=Path(__file__).resolve().parent.parent, env=env, timeout=240)
    assert proc.returncode != 0 and proc.stdout == b""
    assert b"exited with code" in proc.stderr
    assert time.monotonic() - start < 200
    assert not (tmp_path / "larynx" / cli.DAEMON_PIDFILE).exists()


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

    def no_library(*args):  # the float32 or the bfloat16 kernel's library
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

    def no_library(*args):  # the float32 or the bfloat16 kernel's library
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
