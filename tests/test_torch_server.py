"""The port's HTTP server (``larynx_tpu_torch.server``) on CPU, route by
route as ``tests/test_server.py`` drives the JAX package's, and against
the JAX server on the same params.

The voices dir is ``tests/test_torch_pipeline.py``'s (a small GlowTTS voice
and HiFi-GAN), with the HiFi-GAN also as ``hifi_gan/vctk_small`` (the
``low`` preset), a small ``waveglow/wn_256`` (sigma 0, coupling end convs
perturbed as ``tests/test_torch_waveglow.py`` does) and, for Griffin-Lim, a copy of
the voice at ``spec_gain`` 20 (see ``tests/test_torch_fallback.py``).  Both
apps run in one event loop, the port's with ``device="cpu"``.

Tolerance: the WAVs of ``/api/tts``, ``/process`` and ``/api/stream`` at
``noiseScale=0`` from the two servers agree within 2 LSB per sample at the
same length (``tests/test_torch_pipeline.py`` says why).
"""

import asyncio
import concurrent.futures
import io
import json
import shutil

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

import larynx_tpu
from larynx_tpu.convert.native import save_params
from larynx_tpu.models.waveglow import WaveGlowConfig
from larynx_tpu.server.app import ServerSettings as JServerSettings
from larynx_tpu.server.app import create_app as j_create_app

import larynx_tpu_torch
from larynx_tpu_torch.io import wavfile
from larynx_tpu_torch.server.app import EXECUTOR_KEY, SCHEDULER_KEY, ServerSettings, create_app

from test_torch_pipeline import VOCODER, VOICE, voices_dir  # noqa: F401
from test_torch_waveglow import _perturbed_params

LSB = 2
GL_VOICE = "en-us_torch_server_gl-glow_tts"
WAVEGLOW = {
    "mel_channels": 80, "sampling_rate": 22050, "flows": 4, "groups": 8, "early_every": 2,
    "early_size": 2, "wn_kernel_size": 3, "wn_channels": 32, "wn_layers": 2,
    "upsample_kernel": 512, "upsample_stride": 256, "sigma": 0.0,
}


def _clear_caches():
    for module in (larynx_tpu, larynx_tpu_torch):
        module._TTS_MODEL_CACHE.clear()
        module._VOCODER_MODEL_CACHE.clear()
        module._ENGINE_CACHE.clear()


@pytest.fixture(scope="module")
def voices(voices_dir):  # noqa: F811
    (voices_dir / "hifi_gan" / "vctk_small").symlink_to(voices_dir / VOCODER)
    wg_dir = voices_dir / "waveglow" / "wn_256"
    wg_dir.mkdir(parents=True)
    (wg_dir / "config.json").write_text(json.dumps(WAVEGLOW), encoding="utf-8")
    cfg = WaveGlowConfig(**{k: v for k, v in WAVEGLOW.items() if k != "sampling_rate"})
    save_params(wg_dir / "generator.npz", _perturbed_params(cfg, 0))
    lang, rest = VOICE.split("_", 1)
    gl_dir = voices_dir / lang / GL_VOICE.split("_", 1)[1]
    gl_dir.mkdir()
    config = json.loads((voices_dir / lang / rest / "config.json").read_text(encoding="utf-8"))
    config["audio"]["spec_gain"] = 20.0
    (gl_dir / "config.json").write_text(json.dumps(config), encoding="utf-8")
    for name in ("phonemes.txt", "generator.npz"):
        (gl_dir / name).symlink_to(voices_dir / lang / rest / name)
    return voices_dir


@pytest.fixture(scope="module")
def clients(voices):
    """(port client, JAX client, loop): both apps at quality low."""
    _clear_caches()
    loop = asyncio.new_event_loop()

    async def setup():
        port = TestClient(TestServer(create_app(ServerSettings(
            voices_dir=str(voices), quality="low", device="cpu"))))
        jax_client = TestClient(TestServer(j_create_app(JServerSettings(
            voices_dir=str(voices), quality="low"))))
        await port.start_server()
        await jax_client.start_server()
        return port, jax_client

    port, jax_client = loop.run_until_complete(setup())
    yield port, jax_client, loop
    loop.run_until_complete(port.close())
    loop.run_until_complete(jax_client.close())
    loop.close()
    _clear_caches()


def _fetch(loop, client, method, path, **kwargs):
    async def go():
        resp = await getattr(client, method)(path, **kwargs)
        return resp.status, resp.content_type, await resp.read()

    return loop.run_until_complete(go())


def _wav(body):
    rate, audio = wavfile.read(io.BytesIO(body))
    assert rate == 22050
    return audio


def _lsb(a, b) -> int:
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def test_api_voices(clients):
    port, _, loop = clients
    status, _, body = _fetch(loop, port, "get", "/api/voices")
    voices = json.loads(body)
    assert status == 200
    assert voices["en-us/torch_port_parity-glow_tts"]["downloaded"] is True
    assert "en-us/ljspeech-glow_tts" in voices  # registry voices not downloaded


def test_api_vocoders(clients):
    port, jax_client, loop = clients
    ids = {v["id"] for v in json.loads(_fetch(loop, port, "get", "/api/vocoders")[2])}
    assert {"hifi_gan/vctk_small", "waveglow/wn_256"} <= ids
    assert ids == {v["id"] for v in json.loads(_fetch(loop, jax_client, "get", "/api/vocoders")[2])}


@pytest.mark.parametrize("method", ["get", "post"])
def test_api_tts_matches_jax_server(clients, method):
    """GET with text in the query, POST with it in the body, noise 0."""
    port, jax_client, loop = clients
    params = {"voice": "en-us/torch_port_parity-glow_tts", "vocoder": "low", "noiseScale": "0"}
    text = "Hello from the server. It answers in two sentences."
    if method == "get":
        kwargs = {"params": dict(params, text=text)}
    else:
        kwargs = {"params": params, "data": text.encode()}
    status, content_type, body = _fetch(loop, port, method, "/api/tts", **kwargs)
    assert status == 200 and content_type == "audio/wav"
    _, _, ref = _fetch(loop, jax_client, method, "/api/tts", **kwargs)
    audio = _wav(body)
    assert audio.size > 1000 and np.abs(audio.astype(np.int32)).max() > 1000
    assert _lsb(audio, _wav(ref)) <= LSB


def test_api_tts_missing_text_is_500_text(clients):
    port, _, loop = clients
    status, _, body = _fetch(loop, port, "get", "/api/tts",
                             params={"voice": "en-us/torch_port_parity-glow_tts"})
    assert status == 500 and "text" in body.decode().lower()


def test_marytts_process_matches_jax_server(clients):
    """MaryTTS GET with VOICE=<voice>;<quality>, and the same text through
    /api/tts: the server defaults (denoiser 0.005) on both routes."""
    port, jax_client, loop = clients
    params = {"INPUT_TEXT": "Mary says hi.", "VOICE": "en-us_torch_port_parity-glow_tts;low"}
    status, _, body = _fetch(loop, port, "get", "/process", params=params)
    assert status == 200 and body[:4] == b"RIFF"
    _, _, ref = _fetch(loop, jax_client, "get", "/process", params=params)
    # /process uses the server's noise scale: the port's CPU generator and
    # jax.random draw other noise, so parity holds for the lengths only
    assert _wav(body).shape == _wav(ref).shape


def test_marytts_process_at_noise_zero_matches_jax_and_api_tts(voices):
    """A server whose default noise scale is 0: /process equals the JAX
    server's /process within 2 LSB, and the port's own /api/tts for the
    same text and settings."""
    _clear_caches()
    loop = asyncio.new_event_loop()

    async def run():
        port = TestClient(TestServer(create_app(ServerSettings(
            voices_dir=str(voices), quality="low", noise_scale=0.0, device="cpu"))))
        jax_client = TestClient(TestServer(j_create_app(JServerSettings(
            voices_dir=str(voices), quality="low", noise_scale=0.0))))
        await port.start_server()
        await jax_client.start_server()
        try:
            params = {"INPUT_TEXT": "Mary says hi.",
                      "VOICE": "en-us_torch_port_parity-glow_tts;low"}
            out = [await (await c.get("/process", params=params)).read()
                   for c in (port, jax_client)]
            tts = await (await port.get("/api/tts", params={
                "voice": "en-us_torch_port_parity-glow_tts", "text": "Mary says hi.",
                "vocoder": "low"})).read()
            return out + [tts]
        finally:
            await port.close()
            await jax_client.close()

    try:
        body, ref, tts = loop.run_until_complete(run())
    finally:
        loop.close()
        _clear_caches()
    assert _lsb(_wav(body), _wav(ref)) <= LSB
    assert _lsb(_wav(body), _wav(tts)) == 0


def test_marytts_process_post_text_only(clients, voices):
    """POST of INPUT_TEXT alone defaults the locale (en-us: its registry
    voice) and the quality (high), staged here as copies."""
    default_dir = voices / "en-us" / "mary_ann-glow_tts"
    if not default_dir.is_dir():
        shutil.copytree(voices / "en-us" / "torch_port_parity-glow_tts", default_dir)
    high_dir = voices / "hifi_gan" / "universal_large"
    if not high_dir.is_dir():
        shutil.copytree(voices / VOCODER, high_dir)
    port, _, loop = clients
    status, _, body = _fetch(loop, port, "post", "/process", data={"INPUT_TEXT": "Mary posts hi."})
    assert status == 200 and body[:4] == b"RIFF"


def test_api_tts_unsynthesizable_text_returns_empty_wav(clients):
    port, _, loop = clients
    status, _, body = _fetch(loop, port, "get", "/api/tts", params={
        "voice": "en-us_torch_port_parity-glow_tts", "text": "@&%", "vocoder": "low"})
    assert status == 200 and body[:4] == b"RIFF" and len(body) <= 128


def test_marytts_voices_and_version(clients):
    port, _, loop = clients
    assert "torch_port_parity;low en-us" in _fetch(loop, port, "get", "/voices")[2].decode()
    assert _fetch(loop, port, "get", "/version")[2].decode() == larynx_tpu_torch.__version__


def test_api_phonemes(clients):
    port, _, loop = clients
    phonemes = json.loads(_fetch(loop, port, "get", "/api/phonemes",
                                 params={"language": "en-us"})[2])
    assert "aɪ" in phonemes and phonemes["ɛ"]["example"] == "bed"
    url = phonemes["aɪ"].get("url", "")
    assert url.startswith("wav/")
    body = _fetch(loop, port, "get", "/" + url)[2]
    assert body[:4] == b"RIFF" and len(body) > 4000


def test_api_phonemes_builtin_inventory(clients):
    port, _, loop = clients
    phonemes = json.loads(_fetch(loop, port, "get", "/api/phonemes", params={"language": "sw"})[2])
    assert "ᵐɓ" in phonemes and "url" in phonemes["ᵐɓ"]


def test_index_and_openapi(clients):
    port, _, loop = clients
    html = _fetch(loop, port, "get", "/")[2].decode()
    assert "/api/tts" in html
    assert "openapi" in _fetch(loop, port, "get", "/openapi/swagger.yaml")[2].decode()
    spec = json.loads(_fetch(loop, port, "get", "/openapi/swagger.json")[2])
    assert "/api/tts" in spec["paths"]
    html = _fetch(loop, port, "get", "/openapi")[2].decode()
    assert "swagger.json" in html and "renderOp" in html


@pytest.mark.parametrize("vocoder,voice", [
    ("waveglow", "en-us_torch_port_parity-glow_tts"),
    ("griffin_lim", GL_VOICE),
], ids=["waveglow", "griffin_lim"])
def test_api_tts_other_vocoders(clients, vocoder, voice):
    port, _, loop = clients
    status, _, body = _fetch(loop, port, "get", "/api/tts", params={
        "voice": voice, "text": "Another vocoder through the server.", "vocoder": vocoder})
    assert status == 200
    audio = _wav(body)
    assert audio.size > 2000 and np.abs(audio.astype(np.int32)).max() > 1000


def _stream(loop, client, **params):
    status, _, body = _fetch(loop, client, "get", "/api/stream", params=dict({
        "voice": "en-us_torch_port_parity-glow_tts", "text": "Streaming synthesis check.",
        "vocoder": "low", "chunkFrames": "16", "noiseScale": "0"}, **params))
    assert status == 200
    assert body[:4] == b"RIFF" and body[8:12] == b"WAVE" and body[4:8] == b"\xff\xff\xff\xff"
    return np.frombuffer(body[44:], dtype=np.int16)


def test_api_stream_matches_jax_server(clients):
    port, jax_client, loop = clients
    audio = _stream(loop, port)
    assert audio.size > 8000 // 2 and np.abs(audio.astype(np.int32)).max() > 1000
    assert _lsb(audio, _stream(loop, jax_client)) <= LSB


def test_api_stream_waveglow_is_one_chunk_per_sentence(clients, voices):
    """vocoder=waveglow streams through the fallback, one chunk per
    sentence: the body is the library stream's chunks (0 LSB: one model,
    sigma 0) and the JAX server's within 2 LSB."""
    port, jax_client, loop = clients
    text = "Waveglow streams. One chunk per sentence."
    audio = _stream(loop, port, text=text, vocoder="waveglow")
    chunks = list(larynx_tpu_torch.stream_text_to_speech(
        text, voice_or_lang="en-us_torch_port_parity-glow_tts", vocoder_or_quality="waveglow",
        custom_voices_dir=voices, tts_settings={"noise_scale": 0.0, "length_scale": 1.0},
        denoiser_strength=0.005, device="cpu"))
    assert len(chunks) == 2
    np.testing.assert_array_equal(audio, np.concatenate(chunks))
    assert _lsb(audio, _stream(loop, jax_client, text=text, vocoder="waveglow")) <= LSB


def test_api_stream_client_disconnect_frees_executor(clients):
    """A client that hangs up mid-stream leaves no executor thread blocked
    on the full chunk queue (``tests/test_server.py``'s test)."""
    port, _, loop = clients

    async def abort_stream():
        resp = await port.get("/api/stream", params={
            "voice": "en-us_torch_port_parity-glow_tts",
            "text": "A much longer sentence for the streaming disconnect test, spoken slowly. "
                    * 4,
            "vocoder": "low", "chunkFrames": "2", "lengthScale": "2.0"})
        await resp.content.read(64)  # first bytes only, then hang up
        resp.close()

    loop.run_until_complete(abort_stream())
    executor = port.server.app[EXECUTOR_KEY]

    async def all_workers_free():
        await asyncio.sleep(0.7)  # the producer's put gives up within ~0.5 s
        futs = [executor.submit(lambda: 42) for _ in range(executor._max_workers)]
        done, _ = concurrent.futures.wait(futs, timeout=5.0)
        assert len(done) == executor._max_workers, "executor thread leaked by aborted stream"

    loop.run_until_complete(all_workers_free())
    status, _, body = _fetch(loop, port, "get", "/api/tts", params={
        "voice": "en-us_torch_port_parity-glow_tts", "text": "Still alive.", "vocoder": "low"})
    assert status == 200 and body[:4] == b"RIFF"


def test_api_tts_ssml_say_as_and_lexicon(clients):
    port, _, loop = clients
    markup = (
        "<speak>"
        '<lexicon id="x"><lexeme><grapheme>larynx</grapheme>'
        "<phoneme>l ˈɛ ɹ ɪ ŋ k s</phoneme></lexeme></lexicon>"
        'Dr. Smith used <lookup ref="x">larynx</lookup> on '
        '<say-as interpret-as="date" format="moy">4/1/2021</say-as>.'
        "</speak>"
    )
    status, _, body = _fetch(loop, port, "post", "/api/tts", params={
        "voice": "en-us_torch_port_parity-glow_tts", "vocoder": "low", "ssml": "true"},
        data=markup.encode("utf-8"))
    assert status == 200 and _wav(body).size > 1000


def test_concurrent_requests_share_scheduler_batches(clients):
    """Eight /api/tts requests at once: the shared BatchScheduler runs their
    sentences in fewer than eight batches, and /api/stats says so."""
    port, _, loop = clients
    scheduler = port.server.app[SCHEDULER_KEY]
    batches, jobs = scheduler.batches_run, scheduler.jobs_run

    async def burst():
        async def one(i):
            resp = await port.get("/api/tts", params={
                "voice": "en-us_torch_port_parity-glow_tts", "vocoder": "low",
                "text": f"Request number {i} arrives.", "noiseScale": "0"})
            return resp.status, await resp.read()

        return await asyncio.gather(*(one(i) for i in range(8)))

    results = loop.run_until_complete(burst())
    assert all(status == 200 and body[:4] == b"RIFF" for status, body in results)
    stats = json.loads(_fetch(loop, port, "get", "/api/stats")[2])
    assert stats["sentences_run"] - jobs == 8
    assert stats["batches_run"] - batches < 8
    assert stats["version"] == larynx_tpu_torch.__version__
    assert stats["sentences_per_batch"] == round(stats["sentences_run"] / stats["batches_run"], 3)
    kinds = {e["vocoder_kind"] for e in stats["engines"].values()}
    assert "hifi_gan" in kinds and {e["device"] for e in stats["engines"].values()} == {"cpu"}
