"""HTTP server of the port: REST API + web UI + MaryTTS compatibility layer.

Counterpart of ``larynx_tpu/server/app.py`` on ``larynx_tpu_torch``, with
every route of that app: ``/api/tts`` (GET/POST), ``/api/stream``,
``/api/voices``, ``/api/vocoders``, ``/api/phonemes``, ``/api/download``,
MaryTTS ``/process`` / ``/voices`` / ``/version``, ``/api/stats``, the ``/``
web UI with static assets, ``/openapi`` docs, and a text-format 500 error
handler.  Built on aiohttp.  ``ServerSettings.device`` is the device every
request synthesises on (None: CUDA, and ``create_app`` raises without a
GPU).  All synthesis, and so all CUDA work, runs in the executor's worker
threads or the shared ``BatchScheduler``'s thread, never on the event
loop's thread.

``/api/stats`` reports the scheduler's counters, the version and one entry
per cached engine: its predicted mel bucket's state (``frames_per_token``,
``bucket_mispredicts``) as the JAX route has it, and its vocoder kind,
device and vocoder dtype; and ``trace``, the port's trace registry
(``runtime/trace.py``): its counters, and while tracing is on
(``LARYNX_TPU_TRACE=1``) each span name's count and total, self, p50, p95
and max ms.  Every request is traced as ``server.request`` (its route and
status).
"""

import asyncio
import logging
import os
import time
import typing
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from urllib.parse import parse_qs

import numpy as np
from aiohttp import web

import larynx_tpu_torch
from larynx_tpu_torch import text_to_speech
from larynx_tpu_torch.device import resolve_device
from larynx_tpu_torch.runtime import trace

if typing.TYPE_CHECKING:
    from larynx_tpu_torch.runtime.scheduler import BatchScheduler

# typed aiohttp app-state keys (aiohttp recommends AppKey over str keys)
SCHEDULER_KEY: "web.AppKey[BatchScheduler]" = web.AppKey("scheduler")
EXECUTOR_KEY: "web.AppKey[ThreadPoolExecutor]" = web.AppKey("executor")
from larynx_tpu_torch.constants import VocoderQuality
from larynx_tpu_torch.dsp import ipa_synth
from larynx_tpu_torch.io.wavfile import wav_bytes as wavfile_bytes
from larynx_tpu_torch.text import ipa
from larynx_tpu_torch.text.ids import load_phoneme_ids
from larynx_tpu_torch.text.langs import resolve_lang
from larynx_tpu_torch.voices import (
    DEFAULT_VOICE_URL_FORMAT,
    VOCODER_QUALITY,
    VOICE_GENDERS,
    download_voice,
    get_voice_download_name,
    get_voices_dirs,
    list_voices,
    resolve_voice_name,
    valid_voice_dir,
)

_LOGGER = logging.getLogger("larynx_tpu_torch.server")
_DIR = Path(__file__).parent

VOCODER_DIR_NAMES = {"hifi_gan", "waveglow"}

# language -> sample file name (for not-yet-downloaded voice previews,
# larynx/server.py:54-64)
_SAMPLE_SENTENCES = {
    "de-de": "haben_sie_ein_vegetarisches",
    "en-us": "it_took_me_quite_a_long_time_to_develop_a_voice",
    "es-es": "siga_recto",
    "fr-fr": "pourriez-vous_parler",
    "it-it": "parli_un_altra",
    "nl": "kunt_u_wat_langzamer_praten_alstublieft",
    "ru-ru": "Моё_судно_на",
    "sv-se": "den_här_damen",
    "sw": "gari_langu_linaloangama_limejaa_na_mikunga",
}


@dataclass
class ServerSettings:
    voices_dir: typing.Optional[str] = None
    quality: str = "high"
    denoiser_strength: float = 0.005
    noise_scale: float = 0.667
    length_scale: float = 1.0
    url_format: str = DEFAULT_VOICE_URL_FORMAT
    half: bool = False
    max_batch: int = 8
    # several worker threads let concurrent requests overlap so the shared
    # BatchScheduler can coalesce their sentences into one device batch
    workers: int = 8
    # voices to load + warm at startup (first requests skip model loading,
    # weight packing and the first kernel builds)
    preload_voices: typing.Tuple[str, ...] = ()
    # the torch device every request runs on; None is CUDA, as the CLI's
    # --device: create_app raises when no GPU is present
    device: typing.Optional[str] = None
    extra: typing.Dict[str, typing.Any] = field(default_factory=dict)


def convert_bool(bool_str: str) -> bool:
    return bool_str.strip().lower() in {"true", "yes", "on", "1", "enable"}


def create_app(settings: typing.Optional[ServerSettings] = None) -> web.Application:
    settings = settings or ServerSettings()
    device = resolve_device(settings.device)
    voices_dirs = get_voices_dirs(settings.voices_dir)
    executor = ThreadPoolExecutor(max_workers=settings.workers)

    # phoneme example audio: package dir when writable, else a user cache
    phoneme_wav_dir = _DIR / "wav"
    try:
        phoneme_wav_dir.mkdir(exist_ok=True)
        (phoneme_wav_dir / ".writable").touch()
        (phoneme_wav_dir / ".writable").unlink()
    except OSError:
        phoneme_wav_dir = (
            Path(os.environ.get("XDG_CACHE_HOME", Path.home() / ".cache"))
            / "larynx_tpu_torch"
            / "phoneme_wav"
        )
        phoneme_wav_dir.mkdir(parents=True, exist_ok=True)

    from larynx_tpu_torch.runtime.scheduler import BatchScheduler

    scheduler = BatchScheduler(max_batch=settings.max_batch)

    def _preload():
        for voice in settings.preload_voices:
            try:
                tts = larynx_tpu_torch.get_tts_model(
                    voice, custom_voices_dir=settings.voices_dir, half=settings.half
                )
                voc = larynx_tpu_torch.get_vocoder_model(
                    settings.quality,
                    custom_voices_dir=settings.voices_dir,
                    half=settings.half,
                    denoiser_strength=settings.denoiser_strength,
                )
                engine = larynx_tpu_torch._get_engine(tts, voc, device, half=settings.half)
                if engine is not None:
                    _LOGGER.info("Warming %s...", voice)
                    engine.warmup(text_lengths=(16, 64, 128), batch_sizes=(1, 8))
                    _LOGGER.info("Warmed %s", voice)
            except Exception:
                _LOGGER.exception("preload failed for %s", voice)

    if settings.preload_voices:
        executor.submit(_preload)

    # ------------------------------------------------------------------

    async def text_to_wav(
        text: str,
        voice: str,
        vocoder: str,
        denoiser_strength: typing.Optional[float] = None,
        noise_scale: typing.Optional[float] = None,
        length_scale: typing.Optional[float] = None,
        ssml: bool = False,
    ) -> bytes:
        voice = voice.replace("/", "_")

        tts_settings = None
        if noise_scale is not None or length_scale is not None:
            tts_settings = {}
            if noise_scale is not None:
                tts_settings["noise_scale"] = noise_scale
            if length_scale is not None:
                tts_settings["length_scale"] = length_scale
        vocoder_settings = None
        if denoiser_strength is not None:
            vocoder_settings = {"denoiser_strength": denoiser_strength}

        _LOGGER.info(
            "Synthesizing with %s, %s (%s char(s))...", voice, vocoder, len(text)
        )
        start_time = time.time()

        def run():
            return list(
                text_to_speech(
                    text=text,
                    voice_or_lang=voice,
                    vocoder_or_quality=vocoder,
                    tts_settings=tts_settings,
                    vocoder_settings=vocoder_settings,
                    denoiser_strength=denoiser_strength or 0.0,
                    half=settings.half,
                    ssml=ssml,
                    custom_voices_dir=settings.voices_dir,
                    url_format=settings.url_format,
                    max_batch=settings.max_batch,
                    scheduler=scheduler,
                    device=device,
                )
            )

        loop = asyncio.get_running_loop()
        results = await loop.run_in_executor(executor, run)

        audios = [r.audio for r in results]
        sample_rate = results[0].sample_rate if results else 22050
        # no synthesizable words (whitespace, unmapped symbols) -> empty WAV
        audio = (
            np.concatenate(audios) if audios else np.zeros((0,), np.int16)
        )
        wav_bytes = wavfile_bytes(sample_rate, audio)
        _LOGGER.info(
            "Synthesized %s byte(s) in %s second(s)",
            len(wav_bytes),
            time.time() - start_time,
        )
        return wav_bytes

    def get_voices_dict() -> typing.Dict[str, typing.Dict[str, typing.Any]]:
        """Downloaded + known-but-not-downloaded voices
        (larynx/server.py:228-286)."""
        voices: typing.Dict[str, typing.Dict[str, typing.Any]] = {}
        for voices_dir in voices_dirs:
            if not voices_dir.is_dir():
                continue
            for lang_dir in voices_dir.iterdir():
                if not lang_dir.is_dir() or lang_dir.name in VOCODER_DIR_NAMES:
                    continue
                for voice_model_dir in lang_dir.iterdir():
                    if not valid_voice_dir(voice_model_dir):
                        continue
                    full_name = voice_model_dir.name
                    if "-" not in full_name:
                        continue
                    name, tts_system = full_name.split("-", maxsplit=1)
                    voice_id = f"{lang_dir.name}/{full_name}"
                    voices[voice_id] = {
                        "id": voice_id,
                        "name": name,
                        "language": lang_dir.name,
                        "tts_system": tts_system,
                        "downloaded": True,
                    }

        for canonical, lang, _gender in list_voices():
            full_name = canonical.split("_", maxsplit=1)[1]
            name, tts_system = full_name.split("-", maxsplit=1)
            voice_id = f"{lang}/{full_name}"
            if voice_id in voices:
                continue
            sample = _SAMPLE_SENTENCES.get(lang)
            sample_url = (
                f"https://raw.githubusercontent.com/rhasspy/larynx/master/"
                f"local/{lang}/{full_name}/samples/{sample}.wav"
                if sample
                else ""
            )
            voices[voice_id] = {
                "id": voice_id,
                "name": name,
                "language": lang,
                "tts_system": tts_system,
                "downloaded": False,
                "sample_url": sample_url,
            }
        return voices

    # ------------------------------------------------------------------
    # API endpoints

    async def app_voices(request: web.Request) -> web.Response:
        return web.json_response(get_voices_dict())

    async def app_vocoders(request: web.Request) -> web.Response:
        vocoders = []
        seen = set()
        for voices_dir in voices_dirs:
            if not voices_dir.is_dir():
                continue
            for vocoder_dir in voices_dir.iterdir():
                if not vocoder_dir.is_dir() or vocoder_dir.name not in VOCODER_DIR_NAMES:
                    continue
                for model_dir in vocoder_dir.iterdir():
                    if not valid_voice_dir(model_dir):
                        continue
                    vocoder_id = f"{vocoder_dir.name}/{model_dir.name}"
                    if vocoder_id in seen:
                        continue
                    seen.add(vocoder_id)
                    vocoders.append(
                        {
                            "id": vocoder_id,
                            "name": model_dir.name,
                            "vocoder_system": vocoder_dir.name,
                        }
                    )
        return web.json_response(vocoders)

    async def app_say(request: web.Request) -> web.Response:
        voice = request.query.get("voice", "")
        assert voice, "No voice provided"

        noise_scale = float(request.query.get("noiseScale", settings.noise_scale))
        length_scale = float(request.query.get("lengthScale", settings.length_scale))
        ssml = convert_bool(request.query.get("ssml", ""))

        if request.method == "POST":
            text = (await request.read()).decode()
        else:
            text = request.query.get("text", "")
        assert text, "No text provided"

        vocoder = request.query.get("vocoder", settings.quality)
        denoiser_strength = float(
            request.query.get("denoiserStrength", settings.denoiser_strength)
        )

        wav_bytes = await text_to_wav(
            text,
            voice,
            vocoder=vocoder,
            denoiser_strength=denoiser_strength,
            noise_scale=noise_scale,
            length_scale=length_scale,
            ssml=ssml,
        )
        return web.Response(body=wav_bytes, content_type="audio/wav")

    def _streaming_wav_header(sample_rate: int) -> bytes:
        """RIFF header with unknown-length sizes (0xFFFFFFFF) — the
        standard container for live PCM streams; players read to EOF."""
        import struct

        return (
            b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sample_rate,
                                    sample_rate * 2, 2, 16)
            + b"data" + struct.pack("<I", 0xFFFFFFFF)
        )

    async def api_stream(request: web.Request) -> web.StreamResponse:
        """Chunked streaming synthesis: audio flows after the first
        vocoder chunk instead of after the whole utterance.  No reference
        equivalent (the CLI's --raw-stream streams per sentence)."""
        voice = request.query.get("voice", "")
        assert voice, "No voice provided"
        if request.method == "POST":
            text = (await request.read()).decode()
        else:
            text = request.query.get("text", "")
        assert text, "No text provided"

        noise_scale = float(request.query.get("noiseScale", settings.noise_scale))
        length_scale = float(request.query.get("lengthScale", settings.length_scale))
        ssml = convert_bool(request.query.get("ssml", ""))
        vocoder = request.query.get("vocoder", settings.quality)
        denoiser_strength = float(
            request.query.get("denoiserStrength", settings.denoiser_strength)
        )
        chunk_frames = int(request.query.get("chunkFrames", 64))

        # model load (file I/O, param conversion, maybe a voice download)
        # must not block the event loop — defer to the executor like
        # text_to_wav does
        tts_model = await asyncio.get_running_loop().run_in_executor(
            executor,
            lambda: larynx_tpu_torch.get_tts_model(
                voice, custom_voices_dir=settings.voices_dir,
                url_format=settings.url_format, half=settings.half,
            ),
        )
        assert tts_model is not None, f"Unknown voice: {voice}"
        sample_rate = tts_model.audio_settings.sample_rate

        resp = web.StreamResponse()
        resp.content_type = "audio/wav"
        await resp.prepare(request)
        await resp.write(_streaming_wav_header(sample_rate))

        loop = asyncio.get_running_loop()
        queue: "asyncio.Queue[typing.Optional[bytes]]" = asyncio.Queue(maxsize=4)
        # The producer thread's liveness must NEVER depend on the consumer
        # coroutine: when the client disconnects mid-stream, aiohttp
        # cancels this handler, and a put().result() against the full
        # queue would then block the shared executor thread forever.
        import threading
        from concurrent.futures import TimeoutError as FutureTimeout

        gone = threading.Event()

        def put_or_gone(item: typing.Optional[bytes]) -> bool:
            """Bounded put that gives up once the consumer is gone."""
            if gone.is_set():
                return False
            fut = asyncio.run_coroutine_threadsafe(queue.put(item), loop)
            while True:
                try:
                    fut.result(0.5)
                    return True
                except FutureTimeout:
                    if gone.is_set():
                        fut.cancel()
                        return False

        def produce():
            try:
                for chunk in larynx_tpu_torch.stream_text_to_speech(
                    text,
                    voice_or_lang=voice,
                    vocoder_or_quality=vocoder,
                    ssml=ssml,
                    tts_settings={
                        "noise_scale": noise_scale,
                        "length_scale": length_scale,
                    },
                    denoiser_strength=denoiser_strength,
                    half=settings.half,
                    custom_voices_dir=settings.voices_dir,
                    url_format=settings.url_format,
                    chunk_frames=chunk_frames,
                    device=device,
                ):
                    if not put_or_gone(chunk.tobytes()):
                        break
            finally:
                put_or_gone(None)

        producer = loop.run_in_executor(executor, produce)
        try:
            while True:
                data = await queue.get()
                if data is None:
                    break
                await resp.write(data)
            await producer
            await resp.write_eof()
        finally:
            gone.set()
        return resp

    async def api_phonemes(request: web.Request) -> web.Response:
        """Phoneme inventory for a language with example words and
        synthesized example audio (reference: larynx/server.py:386-438
        served gruut_ipa inventories + recorded WAVs; here the examples
        are formant-synthesized from the articulatory features)."""
        language = resolve_lang(request.query.get("language", "en-us"))
        symbols: typing.List[str] = []
        for voices_dir in voices_dirs:
            lang_dir = voices_dir / language
            if not lang_dir.is_dir():
                continue
            for voice_dir in lang_dir.iterdir():
                table_path = voice_dir / "phonemes.txt"
                if not table_path.is_file():
                    continue
                with open(table_path, encoding="utf-8") as f:
                    table = load_phoneme_ids(f)
                symbols = [
                    s
                    for s in table
                    if s not in {"_", "#", "|", "‖", "ˈ", "ˌ", "²", "'"}
                ]
                break
            if symbols:
                break
        if not symbols:
            # no voice installed for the language: built-in inventory
            symbols = list(ipa.INVENTORIES.get(language, ()))

        loop = asyncio.get_running_loop()
        wav_names = await loop.run_in_executor(
            executor, ipa_synth.write_examples, symbols, phoneme_wav_dir
        )
        phonemes: typing.Dict[str, typing.Dict[str, typing.Any]] = {}
        for symbol in symbols:
            parsed = ipa.parse_phoneme(symbol)
            entry: typing.Dict[str, typing.Any] = {
                "example": parsed.example if parsed else "",
                "description": parsed.description if parsed else "",
            }
            if symbol in wav_names:
                entry["url"] = f"wav/{wav_names[symbol]}"
            phonemes[symbol] = entry
        return web.json_response(phonemes)

    async def api_download(request: web.Request) -> web.Response:
        voice_id = request.query.get("id", "")
        voice_name = voice_id.split("/", maxsplit=1)[1] if "/" in voice_id else voice_id
        download_name = get_voice_download_name(resolve_voice_name(voice_name))
        assert download_name, f"No download known for {voice_name}"
        url = settings.url_format.format(voice=download_name)
        loop = asyncio.get_running_loop()
        tts_model_dir = await loop.run_in_executor(
            executor, download_voice, voice_name, voices_dirs[0], url
        )
        return web.json_response(
            {"id": voice_id, "url": url, "dir": str(tts_model_dir)}
        )

    # ------------------------------------------------------------------
    # MaryTTS compatibility (larynx/server.py:462-557)

    async def api_process(request: web.Request) -> web.Response:
        if request.method == "POST":
            data = parse_qs((await request.read()).decode())
            text = data.get("INPUT_TEXT", [""])[0]
            if "VOICE" in data:
                voice = data.get("VOICE", [""])[0]
            else:
                # same default as the GET path: clients commonly POST only
                # INPUT_TEXT
                voice = data.get("LOCALE", ["en-us"])[0]
        else:
            text = request.query.get("INPUT_TEXT", "")
            voice = request.query.get(
                "VOICE", request.query.get("LOCALE", "en-us")
            )

        vocoder: typing.Optional[str] = None
        if ";" in voice:
            voice, vocoder = voice.split(";", maxsplit=1)
        if vocoder is not None:
            vocoder = VOCODER_QUALITY.get(vocoder.strip(), vocoder.strip())
        else:
            vocoder = VocoderQuality.HIGH.value

        ssml = text.strip().startswith("<")
        wav_bytes = await text_to_wav(
            text,
            voice,
            vocoder=vocoder,
            denoiser_strength=settings.denoiser_strength,
            noise_scale=settings.noise_scale,
            length_scale=settings.length_scale,
            ssml=ssml,
        )
        return web.Response(body=wav_bytes, content_type="audio/wav")

    async def api_marytts_voices(request: web.Request) -> web.Response:
        lines = []
        seen = set()
        for voices_dir in voices_dirs:
            if not voices_dir.is_dir():
                continue
            for lang_dir in voices_dir.iterdir():
                if not lang_dir.is_dir() or lang_dir.name in VOCODER_DIR_NAMES:
                    continue
                for voice_model_dir in lang_dir.iterdir():
                    if not valid_voice_dir(voice_model_dir):
                        continue
                    name_tts = voice_model_dir.name
                    if "-" not in name_tts or name_tts in seen:
                        continue
                    seen.add(name_tts)
                    full_voice_name = f"{lang_dir.name}_{name_tts}"
                    name, tts_system = name_tts.split("-", maxsplit=1)
                    gender_path = voice_model_dir / "GENDER"
                    if gender_path.is_file():
                        gender = gender_path.read_text().strip()
                    else:
                        resolve_voice_name("")  # ensure tables built
                        gender = VOICE_GENDERS.get(full_voice_name, "NA")
                    for quality in VOCODER_QUALITY:
                        lines.append(
                            f"{name};{quality} {lang_dir.name} {gender} {tts_system}"
                        )
        return web.Response(text="\n".join(sorted(lines)))

    async def api_version(request: web.Request) -> web.Response:
        return web.Response(text=larynx_tpu_torch.__version__)

    async def api_stats(request: web.Request) -> web.Response:
        """Operational counters (no reference equivalent): batching
        effectiveness of the cross-request scheduler, and the cached
        engines' predicted decode-bucket health (a mispredict costs one
        discarded decode)."""
        engines = {}
        for key, engine in list(larynx_tpu_torch._ENGINE_CACHE.items()):
            if engine is not None:
                engines[str(key)] = {
                    "frames_per_token": round(engine._frames_per_token, 3),
                    "bucket_mispredicts": engine._bucket_mispredicts,
                    "vocoder_kind": engine.vocoder_kind,
                    "device": str(engine.device),
                    "vocoder_dtype": str(engine.voc_dtype).replace("torch.", ""),
                }
        return web.json_response(
            {
                "batches_run": scheduler.batches_run,
                "sentences_run": scheduler.jobs_run,
                "sentences_per_batch": round(
                    scheduler.jobs_run / max(1, scheduler.batches_run), 3
                ),
                "engines": engines,
                "version": larynx_tpu_torch.__version__,
                "trace": trace.stats(),
            }
        )

    # ------------------------------------------------------------------
    # Web UI / static / docs

    async def app_index(request: web.Request) -> web.Response:
        return web.Response(
            text=(_DIR / "templates" / "index.html").read_text(encoding="utf-8"),
            content_type="text/html",
        )

    async def openapi_yaml(request: web.Request) -> web.Response:
        return web.Response(
            text=(_DIR / "swagger.yaml").read_text(encoding="utf-8"),
            content_type="text/yaml",
        )

    async def openapi_json(request: web.Request) -> web.Response:
        import json

        import yaml

        spec = yaml.safe_load((_DIR / "swagger.yaml").read_text(encoding="utf-8"))
        return web.Response(
            text=json.dumps(spec), content_type="application/json"
        )

    async def openapi_ui(request: web.Request) -> web.Response:
        """Self-contained interactive API explorer (reference served
        swagger-ui at /openapi, larynx/server.py:594-596; no swagger-ui
        assets exist offline, so this is an in-tree equivalent)."""
        return web.Response(
            text=(_DIR / "templates" / "openapi.html").read_text(
                encoding="utf-8"
            ),
            content_type="text/html",
        )

    # ------------------------------------------------------------------

    @web.middleware
    async def trace_middleware(request, handler):
        start = time.perf_counter_ns()
        status = 500
        try:
            response = await handler(request)
            status = response.status
            return response
        except web.HTTPException as err:
            status = err.status
            raise
        finally:
            resource = request.match_info.route.resource
            trace.record("server.request", start, route=request.method + " " + (
                resource.canonical if resource is not None else request.path), status=status)

    @web.middleware
    async def error_middleware(request, handler):
        try:
            return await handler(request)
        except web.HTTPException:
            raise
        except Exception as err:  # noqa: BLE001 (parity: blanket 500 handler)
            _LOGGER.exception("handle_error")
            return web.Response(
                status=500, text=f"{err.__class__.__name__}: {err}"
            )

    @web.middleware
    async def cors_middleware(request, handler):
        response = await handler(request)
        response.headers["Access-Control-Allow-Origin"] = "*"
        return response

    app = web.Application(middlewares=[trace_middleware, error_middleware, cors_middleware])
    app[SCHEDULER_KEY] = scheduler
    app[EXECUTOR_KEY] = executor
    app.router.add_get("/api/tts", app_say)
    app.router.add_post("/api/tts", app_say)
    app.router.add_get("/api/stream", api_stream)
    app.router.add_post("/api/stream", api_stream)
    app.router.add_get("/api/voices", app_voices)
    app.router.add_get("/api/vocoders", app_vocoders)
    app.router.add_get("/api/phonemes", api_phonemes)
    app.router.add_get("/api/download", api_download)
    app.router.add_get("/process", api_process)
    app.router.add_post("/process", api_process)
    app.router.add_get("/voices", api_marytts_voices)
    app.router.add_get("/version", api_version)
    app.router.add_get("/api/stats", api_stats)
    app.router.add_get("/", app_index)
    app.router.add_get("/openapi", openapi_ui)
    app.router.add_get("/openapi/", openapi_ui)
    app.router.add_get("/openapi/swagger.yaml", openapi_yaml)
    app.router.add_get("/openapi/swagger.json", openapi_json)

    css_dir = _DIR / "css"
    img_dir = _DIR / "img"
    for route, path in (("/css", css_dir), ("/img", img_dir)):
        path.mkdir(exist_ok=True)
        app.router.add_static(route, path)
    app.router.add_static("/wav", phoneme_wav_dir)

    async def close(_app: web.Application) -> None:
        scheduler.shutdown()  # its worker thread ends after the queued batches
        executor.shutdown(wait=False)

    app.on_cleanup.append(close)
    return app
