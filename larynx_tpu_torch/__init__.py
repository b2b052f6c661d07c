"""larynx_tpu_torch: the Larynx TTS pipeline in PyTorch and CUDA.

Port of ``larynx_tpu`` (JAX) to one NVIDIA GPU: text -> phoneme ids ->
GlowTTS mels -> HiFi-GAN, WaveGlow or Griffin-Lim audio, batched through
one ``SynthesisEngine`` per (voice, vocoder).  The public surface mirrors ``larynx_tpu``'s
``text_to_speech()``, ``get_tts_model()``, ``get_vocoder_model()``,
``load_tts_model()`` and ``load_vocoder_model()``, plus a ``device``
argument: entry points run on ``cuda`` unless the caller names another
device, and raise when no GPU is present and none is named.

Ported so far: GlowTTS voices (multi-speaker ones through the engine's
``speaker_ids``) and Tacotron2 voices (through the unfused fallback, as in
``larynx_tpu``), HiFi-GAN and WaveGlow vocoders and Griffin-Lim, from voice
dirs with a native ``.npz``, an NVIDIA/reference ``.pth`` or (GlowTTS,
HiFi-GAN) an ``.onnx`` checkpoint; ``text_to_speech``'s pipelined batch
path as ``larynx_tpu`` runs it (consecutive or interleaved same-voice
batching, every unit's encode launched first, decodes on a predicted mel
bucket, one unit launched ahead of the one collected, units that share a
vocoder vocoded as one pooled batch); the cross-request ``BatchScheduler`` (``scheduler=``), chunked streaming
(``stream_text_to_speech``: HiFi-GAN in chunks, other vocoders one chunk per
sentence through the models' own ``phonemes_to_mels`` / ``mels_to_audio``,
the unfused fallback), the CLI (``python -m larynx_tpu_torch``) and the HTTP
server (``python -m larynx_tpu_torch.server``).  Precision as in
``larynx_tpu``: the vocoder runs in bfloat16 on a CUDA device and in
float32 on the CPU (``LARYNX_TPU_VOCODER_PRECISION={bf16,f32}`` overrides;
Griffin-Lim stays float32), and ``half=True`` runs GlowTTS in bfloat16 too
(Tacotron2 stays float32, as in ``larynx_tpu``).  ``text_to_speech`` passes no
speaker id, as ``larynx_tpu``'s does, so on a multi-speaker voice it raises
the engine's ``ValueError``.
"""

import logging
import os
import threading
import time
import typing
from pathlib import Path

import numpy as np

from larynx_tpu_torch.audio import AudioSettings
from larynx_tpu_torch.constants import (
    InferenceBackend,
    TextToSpeechResult,
    TextToSpeechType,
    VocoderQuality,
    VocoderType,
)
from larynx_tpu_torch.device import resolve_device
from larynx_tpu_torch.text.frontend import sentences as frontend_sentences
from larynx_tpu_torch.text.ids import load_phoneme_ids, phonemes_to_ids
from larynx_tpu_torch.text.langs import resolve_lang
from larynx_tpu_torch.voices import (
    DEFAULT_VOICE_URL_FORMAT,
    VOCODER_ALIASES,
    VOCODER_QUALITY,
    download_voice,
    get_voice_download_name,
    get_voices_dirs,
    resolve_voice_name,
    split_voice_name,
    valid_voice_dir,
)

_LOGGER = logging.getLogger("larynx_tpu_torch")

__version__ = "1.0.0"

_DEFAULT_AUDIO_SETTINGS = AudioSettings()


def text_to_speech(
    text: str,
    voice_or_lang: str = "en-us",
    vocoder_or_quality: typing.Union[str, VocoderQuality] = VocoderQuality.HIGH,
    ssml: bool = False,
    backend: typing.Optional[InferenceBackend] = None,
    tts_settings: typing.Optional[typing.Dict[str, typing.Any]] = None,
    vocoder_settings: typing.Optional[typing.Dict[str, typing.Any]] = None,
    denoiser_strength: float = 0.0,
    use_cuda: bool = False,  # accepted for API parity; ``device`` decides
    half: bool = False,
    executor=None,  # accepted for API parity; unused
    custom_voices_dir: typing.Optional[typing.Union[str, Path]] = None,
    url_format: str = DEFAULT_VOICE_URL_FORMAT,
    max_batch: int = 8,
    seed: typing.Optional[int] = None,
    scheduler: typing.Optional[typing.Any] = None,
    interleaved_batching: typing.Optional[bool] = None,
    no_download: bool = False,
    audio_settings_overrides: typing.Optional[typing.Dict[str, typing.Any]] = None,
    device=None,
) -> typing.Iterator[TextToSpeechResult]:
    """Synthesize text into per-sentence audio results, in document order.

    Same arguments as ``larynx_tpu.text_to_speech`` plus ``device``.
    Consecutive sentences of one voice are batched through one engine;
    ``interleaved_batching`` also batches a multi-voice document's scattered
    sentences of one voice (audio still comes in document order, but the
    first result waits for every earlier sentence's batch); None reads
    ``LARYNX_TPU_INTERLEAVED_BATCHING`` (off).  ``half`` runs GlowTTS and
    the vocoder in bfloat16.
    """
    device = resolve_device(device)
    if interleaved_batching is None:
        interleaved_batching = os.environ.get(
            "LARYNX_TPU_INTERLEAVED_BATCHING", ""
        ).lower() in ("1", "true", "yes")

    def results():
        jobs = _build_jobs(
            text, voice_or_lang, vocoder_or_quality, ssml=ssml, backend=backend,
            half=half, denoiser_strength=denoiser_strength,
            custom_voices_dir=custom_voices_dir, url_format=url_format,
            no_download=no_download, audio_settings_overrides=audio_settings_overrides,
        )
        yield from _run_jobs(
            jobs,
            tts_settings=tts_settings,
            vocoder_settings=vocoder_settings,
            denoiser_strength=denoiser_strength,
            max_batch=max_batch,
            seed=seed,
            device=device,
            scheduler=scheduler,
            half=half,
            interleaved=interleaved_batching,
        )

    return results()


def stream_text_to_speech(
    text: str,
    voice_or_lang: str = "en-us",
    vocoder_or_quality: typing.Union[str, VocoderQuality] = VocoderQuality.HIGH,
    ssml: bool = False,
    backend: typing.Optional[InferenceBackend] = None,
    tts_settings: typing.Optional[typing.Dict[str, typing.Any]] = None,
    denoiser_strength: float = 0.0,
    half: bool = False,
    custom_voices_dir: typing.Optional[typing.Union[str, Path]] = None,
    url_format: str = DEFAULT_VOICE_URL_FORMAT,
    seed: typing.Optional[int] = None,
    chunk_frames: int = 64,
    no_download: bool = False,
    device=None,
) -> typing.Iterator[np.ndarray]:
    """Low-latency streaming synthesis: yields int16 audio chunks.

    Same arguments as ``larynx_tpu.stream_text_to_speech`` plus
    ``no_download`` and ``device``.  Audio arrives in ``chunk_frames``-mel
    chunks as the vocoder produces them, at fixed gain (no per-utterance
    peak normalisation); SSML pauses become silence chunks and sentence i
    takes ``seed + i``.  ``half`` runs GlowTTS and the vocoder in bfloat16.
    Another vocoder than HiFi-GAN (WaveGlow, Griffin-Lim) yields one chunk
    per sentence through the unfused fallback, as the JAX stream does.
    """
    device = resolve_device(device)
    noise_scale = 0.667
    length_scale = 1.0
    if tts_settings:
        noise_scale = float(tts_settings.get("noise_scale", noise_scale))
        length_scale = float(tts_settings.get("length_scale", length_scale))

    def chunks():
        jobs = _build_jobs(
            text, voice_or_lang, vocoder_or_quality, ssml=ssml, backend=backend,
            half=half, denoiser_strength=denoiser_strength,
            custom_voices_dir=custom_voices_dir, url_format=url_format, no_download=no_download,
        )
        for index, job in enumerate(jobs):
            engine = _get_engine(job["tts_model"], job["vocoder_model"], device, half=half)
            before, after = _pause_samples(job)
            if before:
                yield np.zeros(before, dtype=np.int16)
            if engine is not None and engine.vocoder_kind == "hifi_gan":
                yield from engine.synthesize_stream(
                    job["ids"],
                    noise_scale=noise_scale,
                    length_scale=length_scale,
                    seed=None if seed is None else seed + index,
                    denoiser_strength=denoiser_strength,
                    chunk_frames=chunk_frames,
                )
            else:  # WaveGlow, Griffin-Lim, custom models: one chunk per sentence
                yield _sentence_task_fallback(
                    job, tts_settings, {"denoiser_strength": denoiser_strength}, device
                )
            if after:
                yield np.zeros(after, dtype=np.int16)

    return chunks()


def _build_jobs(
    text,
    voice_or_lang,
    vocoder_or_quality,
    ssml=False,
    backend=None,
    half=False,
    denoiser_strength=0.0,
    custom_voices_dir=None,
    url_format=DEFAULT_VOICE_URL_FORMAT,
    no_download=False,
    audio_settings_overrides=None,
):
    """Frontend + model resolution -> per-sentence job dicts; ``half`` and
    ``denoiser_strength`` are the loaded models' defaults, as in
    ``larynx_tpu``."""
    resolved_name = resolve_voice_name(voice_or_lang)
    try:
        voice_lang, _voice_name, _voice_type = split_voice_name(resolved_name)
    except ValueError:
        voice_lang = voice_or_lang
    voice_lang = resolve_lang(voice_lang)

    jobs: typing.List[typing.Dict[str, typing.Any]] = []
    for sentence in frontend_sentences(text, lang=voice_lang, ssml=ssml, explicit_lang=False):
        tts_model_names = []
        if sentence.voice:
            tts_model_names.append(sentence.voice)
        if sentence.lang:
            if resolve_lang(sentence.lang) == voice_lang:
                tts_model_names.append(resolved_name)
            else:
                tts_model_names.append(sentence.lang)
        tts_model_names.append(resolved_name)
        tts_model_names.append(voice_or_lang)

        tts_model = None
        for tts_voice_name in filter(None, tts_model_names):
            tts_model = get_tts_model(
                tts_voice_name,
                backend=backend,
                half=half,
                custom_voices_dir=custom_voices_dir,
                url_format=url_format,
                no_download=no_download,
                audio_settings_overrides=audio_settings_overrides,
            )
            if tts_model is not None:
                break
        if tts_model is None:
            raise RuntimeError(f"Failed to load voice {voice_or_lang!r}")

        vocoder_model = get_vocoder_model(
            vocoder_or_quality,
            backend=backend,
            half=half,
            denoiser_strength=denoiser_strength,
            custom_voices_dir=custom_voices_dir,
            url_format=url_format,
            no_download=no_download,
        )
        if vocoder_model is None:
            raise RuntimeError(f"Failed to load vocoder {vocoder_or_quality!r}")

        audio_settings = tts_model.audio_settings or _DEFAULT_AUDIO_SETTINGS
        sent_phonemes = [w.phonemes for w in sentence if w.phonemes]
        sent_phoneme_ids = phonemes_to_ids(sent_phonemes, tts_model.phoneme_to_id)

        pause_before_ms = sentence.pause_before_ms
        pause_after_ms = sentence.pause_after_ms
        if sentence.words:
            pause_before_ms += sentence.words[0].pause_before_ms
            pause_after_ms += sentence.words[-1].pause_after_ms

        marks_before = list(sentence.marks_before)
        marks_after = list(sentence.marks_after)
        for word_idx, word in enumerate(sentence):
            if word.marks_before:
                if word_idx == 0:
                    marks_before.extend(word.marks_before)
                else:
                    marks_after.extend(word.marks_before)
            if word.marks_after:
                marks_after.extend(word.marks_after)

        jobs.append(
            {
                "ids": np.asarray(sent_phoneme_ids, dtype=np.int64),
                "tts_model": tts_model,
                "vocoder_model": vocoder_model,
                "audio_settings": audio_settings,
                "pause_before_ms": pause_before_ms,
                "pause_after_ms": pause_after_ms,
                "result": TextToSpeechResult(
                    text=sentence.text_with_ws,
                    audio=None,
                    sample_rate=audio_settings.sample_rate,
                    marks_before=marks_before,
                    marks_after=marks_after,
                ),
            }
        )
    return jobs


def _pause_samples(job) -> typing.Tuple[int, int]:
    """Samples of silence for the sentence's SSML pauses (before, after)."""
    rate = job["audio_settings"].sample_rate
    return (max(0, (job["pause_before_ms"] * rate) // 1000),
            max(0, (job["pause_after_ms"] * rate) // 1000))


def _pad_pauses(job, audio):
    """The sentence's audio with its SSML pauses as silence around it."""
    before, after = _pause_samples(job)
    if before > 0 or after > 0:
        audio = np.pad(audio, pad_width=(before, after), constant_values=0)
    return audio


def _plan_units(jobs, max_batch, device, half=False, interleaved=False):
    """[(engine or None, job indices)] in the order ``_run_jobs`` launches
    them: jobs grouped by (voice, vocoder), consecutive runs only or, with
    ``interleaved``, every job of a pair in its first job's group; each
    group split into batches of one text bucket and at most ``max_batch``
    sentences."""
    from larynx_tpu_torch.runtime.buckets import BucketPolicy

    groups: typing.List[typing.List[int]] = []
    group_of: typing.Dict[typing.Tuple[int, int], int] = {}
    for i, job in enumerate(jobs):
        key = (id(job["tts_model"]), id(job["vocoder_model"]))
        if interleaved and key in group_of:
            groups[group_of[key]].append(i)
        elif not interleaved and groups and group_of.get(key) == len(groups) - 1:
            groups[-1].append(i)
        else:
            group_of[key] = len(groups)
            groups.append([i])

    units = []
    for group in groups:
        engine = _get_engine(jobs[group[0]]["tts_model"], jobs[group[0]]["vocoder_model"], device,
                             half=half)
        lengths = [len(jobs[i]["ids"]) for i in group]
        policy = engine.policy if engine is not None else BucketPolicy()
        for batch in policy.group_by_text_bucket(lengths, max_batch):
            units.append((engine, [group[k] for k in batch]))
    return units


def _run_jobs(jobs, tts_settings, vocoder_settings, denoiser_strength, max_batch, seed, device,
              scheduler=None, half=False, interleaved=False):
    """Batch same-(voice, vocoder) jobs; yield in document order
    (``larynx_tpu/__init__.py::_run_jobs``, step for step).

    With a ``scheduler`` every sentence is submitted to it instead, so
    sentences of concurrent requests share its batches.  Otherwise the
    units run pipelined: every unit's encode is launched first; a unit's
    decode goes out on a predicted mel bucket; units whose engines share a
    vocoder (a multi-voice document) vocode as one pooled batch while its
    audio stays under the ramp threshold; unit j + 1 is launched before
    unit j is collected, deeper while the audio in flight is small.  A
    sentence whose models have no engine goes through the unfused
    fallback."""
    from larynx_tpu_torch.runtime.engine import RAMP_MIN_BYTES, _pool_rows, vocode_pool_enabled

    noise_scale = 0.667
    length_scale = 1.0
    if tts_settings:
        noise_scale = float(tts_settings.get("noise_scale", noise_scale))
        length_scale = float(tts_settings.get("length_scale", length_scale))
    if vocoder_settings:
        denoiser_strength = float(vocoder_settings.get("denoiser_strength", denoiser_strength))

    if scheduler is not None:
        futures = []
        for job in jobs:
            engine = _get_engine(job["tts_model"], job["vocoder_model"], device, half=half)
            futures.append(None if engine is None else scheduler.submit(
                engine,
                job["ids"],
                noise_scale=noise_scale,
                length_scale=length_scale,
                denoiser_strength=denoiser_strength,
                seed=seed,
            ))
        for job, future in zip(jobs, futures):
            if future is None:
                audio = _sentence_task_fallback(job, tts_settings, vocoder_settings, device)
            else:
                audio = future.result()
            job["result"].audio = _pad_pauses(job, audio)
            yield job["result"]
        return

    units = _plan_units(jobs, max_batch, device, half=half, interleaved=interleaved)

    # every unit's encode first; each starts its lengths' copy to the host
    encodes: typing.List[typing.Any] = []
    for engine, indices in units:
        if engine is None:
            encodes.append(None)
            continue
        t0 = time.perf_counter()
        enc_out, g = engine.encode_launch([jobs[i]["ids"] for i in indices],
                                          length_scale=length_scale)
        encodes.append((enc_out, g, t0))

    # pools: units that can share one vocode launch (unseeded, same
    # vocoder model and precision); the others are pools of one
    pool_ids = [0] * len(units)
    pools: typing.List[typing.List[int]] = []
    pool_key_of: typing.Dict[typing.Tuple[int, bool], int] = {}
    for j, (engine, indices) in enumerate(units):
        key = None
        if (
            vocode_pool_enabled()
            and seed is None
            and engine is not None
            and engine.vocoder_kind in ("hifi_gan", "waveglow")
        ):
            key = (id(jobs[indices[0]]["vocoder_model"]), engine.vocoder_half)
        if key is not None and key in pool_key_of:
            p = pool_key_of[key]
            pools[p].append(j)
        else:
            p = len(pools)
            if key is not None:
                pool_key_of[key] = p
            pools.append([j])
        pool_ids[j] = p

    pool_tails: typing.List[typing.Optional[dict]] = [None] * len(pools)

    def launch_pool(p: int) -> None:
        members = [j for j in pools[p] if encodes[j] is not None]
        if pool_tails[p] is not None or not members:
            return
        decs = []
        for j in members:
            engine, indices = units[j]
            enc_out, g, _t0 = encodes[j]
            decs.append(engine.decode_launch_predicted(
                enc_out, g, len(indices),
                max_id_len=max(len(jobs[i]["ids"]) for i in indices),
                noise_scale=noise_scale, length_scale=length_scale,
                seed=seed, batch_index=j,
            ))
        n_valids = tuple(len(units[j][1]) for j in members)
        bytes_of = {
            j: int(np.sum(d[2][:nv])) * units[j][0].upsample * 2
            for j, d, nv in zip(members, decs, n_valids)
        }
        tail: dict = {"bytes_of": bytes_of}
        # pooling pays while launches, not the audio, are the wall; past the
        # ramp threshold per-unit launches let each unit's copy overlap the
        # next unit's work
        if (
            len(members) > 1
            and sum(bytes_of.values()) < RAMP_MIN_BYTES
            and len({d[0].shape[2] for d in decs}) == 1
        ):
            eng0 = units[members[0]][0]
            m_pool = max(d[0].shape[1] for d in decs)
            mel_p, mask_p = _pool_rows([d[0] for d in decs], [d[1] for d in decs], n_valids,
                                       m_pool)
            y_pool = np.concatenate([d[2][:nv] for d, nv in zip(decs, n_valids)])
            parts = eng0.vocode_launch(mel_p, mask_p, int(sum(n_valids)), denoiser_strength,
                                       y_lengths=y_pool, seed=seed, batch_index=members[0])
            offs = np.concatenate([[0], np.cumsum(n_valids)])
            tail.update(
                mode="pooled", parts=parts, y_pool=y_pool, eng0=eng0,
                total_rows=int(sum(n_valids)),
                span={j: (int(offs[i]), int(n_valids[i])) for i, j in enumerate(members)},
            )
        else:
            per = {}
            for j, (mel, z_mask, y_lengths) in zip(members, decs):
                engine, indices = units[j]
                per[j] = (
                    engine.vocode_launch(mel, z_mask, len(indices), denoiser_strength,
                                         y_lengths=y_lengths, seed=seed, batch_index=j),
                    y_lengths,
                    mel.shape[0],
                )
            tail.update(mode="per_unit", per=per)
        pool_tails[p] = tail

    def tail_bytes(j: int) -> int:
        """int16 audio bytes of a launched unit (its lengths are on the host
        once launch_pool returns)."""
        tail = pool_tails[pool_ids[j]]
        if tail is None:
            return 0
        return tail["bytes_of"].get(j, 0)

    # lookahead: always one unit ahead of the one collected, deeper while
    # the audio in flight stays under the ramp threshold
    launched = 0
    inflight_bytes = 0

    def launch_ahead(j_current: int) -> None:
        nonlocal launched, inflight_bytes
        while launched < len(units):
            deep = launched > j_current + 1
            if deep and inflight_bytes >= RAMP_MIN_BYTES:
                break
            launch_pool(pool_ids[launched])
            inflight_bytes += tail_bytes(launched)
            launched += 1

    # results in document order: a drain pointer yields each job once it
    # and every job before it are done
    done = [False] * len(jobs)
    next_to_yield = 0
    if units:
        launch_ahead(-1)
    for j, (engine, indices) in enumerate(units):
        launch_ahead(j)
        n = len(indices)
        if encodes[j] is None:
            start = time.perf_counter()
            audios = [_sentence_task_fallback(jobs[i], tts_settings, vocoder_settings, device)
                      for i in indices]
            elapsed = time.perf_counter() - start
        else:
            tail = pool_tails[pool_ids[j]]
            if tail["mode"] == "pooled":
                if "rows_np" not in tail:
                    tail["rows_np"] = tail["eng0"].vocode_collect(tail["parts"],
                                                                  tail["total_rows"])
                off, nv = tail["span"][j]
                audios = engine.crop_rows(tail["rows_np"][off : off + nv],
                                          tail["y_pool"][off : off + nv], nv, denoiser_strength)
            else:
                parts, y_lengths, b_rows = tail["per"][j]
                audios = engine.crop_rows(engine.vocode_collect(parts, b_rows), y_lengths, n,
                                          denoiser_strength)
            inflight_bytes -= tail_bytes(j)
            elapsed = time.perf_counter() - encodes[j][2]

        for i, audio in zip(indices, audios):
            job = jobs[i]
            settings = job["audio_settings"]
            _LOGGER.debug(
                "Real-time factor: %0.4f (infer=%0.3f sec, audio=%0.2f sec)",
                elapsed / max(audio.shape[-1] / settings.sample_rate, 1e-9) / n,
                elapsed / n,
                audio.shape[-1] / settings.sample_rate,
            )
            job["result"].audio = _pad_pauses(job, audio)
            done[i] = True

        while next_to_yield < len(jobs) and done[next_to_yield]:
            yield jobs[next_to_yield]["result"]
            next_to_yield += 1


def _sentence_task_fallback(job, tts_settings, vocoder_settings, device) -> np.ndarray:
    """Unfused path through the models' own surfaces
    (``larynx_tpu/__init__.py::_sentence_task_fallback``): ``phonemes_to_mels``,
    the host-side mel chain (denormalize, db_to_amp, dynamic range
    compression), ``mels_to_audio``, int16.  Only ``device`` is added."""
    from larynx_tpu_torch.audio import audio_float_to_int16

    settings = job["audio_settings"]
    mels = job["tts_model"].phonemes_to_mels(job["ids"], settings=tts_settings, device=device)
    if settings.signal_norm:
        mels = settings.denormalize(mels)
    if settings.convert_db_to_amp:
        mels = settings.db_to_amp(mels)
    if settings.do_dynamic_range_compression:
        mels = settings.dynamic_range_compression(mels)
    audio = job["vocoder_model"].mels_to_audio(mels, settings=vocoder_settings, device=device)
    if audio.dtype != np.int16:
        audio = audio_float_to_int16(audio)
    return audio


# -----------------------------------------------------------------------------
# Engine and model caches

_ENGINE_CACHE: typing.Dict[typing.Tuple[int, int, str, bool, bool], typing.Any] = {}
# concurrent requests (threads sharing a scheduler) load each model and
# build each engine once
_CACHE_LOCK = threading.RLock()


def _get_engine(tts_model, vocoder_model, device, half: bool = False):
    """One engine per (voice params, vocoder params, device, precision): the
    precision is ``half`` and the vocoder's dtype, ``half`` or the default
    on the device, read at the call.  None, where the JAX package has no
    engine either (another acoustic model or vocoder class): the caller
    then takes the unfused fallback."""
    from larynx_tpu_torch.glow_tts import GlowTextToSpeech
    from larynx_tpu_torch.griffin_lim import GriffinLimVocoder
    from larynx_tpu_torch.hifi_gan import HiFiGanVocoder
    from larynx_tpu_torch.runtime.engine import SynthesisEngine, default_vocoder_half
    from larynx_tpu_torch.waveglow import WaveGlowVocoder

    vocoder_half = half or default_vocoder_half(device)
    with _CACHE_LOCK:
        key = (id(tts_model), id(vocoder_model), str(device), half, vocoder_half)
        if key in _ENGINE_CACHE:
            return _ENGINE_CACHE[key]
        extra = None
        if isinstance(vocoder_model, HiFiGanVocoder):
            extra = {"vocoder_kind": "hifi_gan", "vocoder_params": vocoder_model.params,
                     "vocoder_cfg": vocoder_model.model_config}
        elif isinstance(vocoder_model, WaveGlowVocoder):
            extra = {"vocoder_kind": "waveglow", "vocoder_params": vocoder_model.params,
                     "vocoder_cfg": vocoder_model.model_config,
                     "waveglow_sigma": vocoder_model.sigma}
        elif isinstance(vocoder_model, GriffinLimVocoder):
            extra = {"vocoder_kind": "griffin_lim"}
        engine = None
        if isinstance(tts_model, GlowTextToSpeech) and extra is not None:
            engine = SynthesisEngine(
                tts_model.params,
                tts_model.model_config,
                tts_model.audio_settings or _DEFAULT_AUDIO_SETTINGS,
                device=device,
                half=half,
                vocoder_half=vocoder_half,
                **extra,
            )
        _ENGINE_CACHE[key] = engine
        return engine


_TTS_MODEL_CACHE: typing.Dict[str, typing.Any] = {}


def get_tts_model(
    name: str = "",
    lang: str = "en-us",
    backend: typing.Optional[InferenceBackend] = None,
    half: bool = False,
    url_format: str = DEFAULT_VOICE_URL_FORMAT,
    custom_voices_dir: typing.Optional[typing.Union[str, Path]] = None,
    no_download: bool = False,
    audio_settings_overrides: typing.Optional[typing.Dict[str, typing.Any]] = None,
):
    """Find (or download), load and cache a voice; None if not found.
    ``half`` is the loaded model's default for its own ``phonemes_to_mels``
    (the cache keeps the first load's, as ``larynx_tpu`` does)."""
    with _CACHE_LOCK:
        resolved_name = resolve_voice_name(name or resolve_lang(lang))
        if not audio_settings_overrides:  # overridden models are not cached
            maybe_model = _TTS_MODEL_CACHE.get(resolved_name)
            if maybe_model is not None:
                return maybe_model

        try:
            voice_lang, voice_name, voice_model_type = split_voice_name(resolved_name)
        except ValueError:
            return None
        voice_dir_name = f"{voice_name}-{voice_model_type}"

        model_dir: typing.Optional[Path] = None
        voices_dirs = get_voices_dirs(custom_voices_dir)
        for voices_dir in voices_dirs:
            maybe_dir = voices_dir / voice_lang / voice_dir_name
            if valid_voice_dir(maybe_dir):
                model_dir = maybe_dir
                break
        if model_dir is None:
            for voices_dir in voices_dirs:
                if not voices_dir.is_dir():
                    continue
                for maybe_dir in voices_dir.rglob(voice_dir_name):
                    if valid_voice_dir(maybe_dir):
                        model_dir = maybe_dir
                        break
                if model_dir is not None:
                    break
        if model_dir is None and not no_download:
            url = url_format.format(voice=get_voice_download_name(resolved_name))
            try:
                model_dir = download_voice(resolved_name, voices_dirs[0], url)
            except Exception:
                _LOGGER.exception("download failed for %s", resolved_name)
                return None
        if model_dir is None:
            return None

        import json

        with open(model_dir / "phonemes.txt", "r", encoding="utf-8") as f:
            phoneme_to_id = load_phoneme_ids(f)
        with open(model_dir / "config.json", "r", encoding="utf-8") as f:
            audio_config = dict(json.load(f)["audio"])
        if audio_settings_overrides:
            audio_config.update(audio_settings_overrides)

        model = load_tts_model(voice_model_type, model_dir, backend=backend, half=half)
        model.phoneme_to_id = phoneme_to_id
        model.audio_settings = AudioSettings(**audio_config)
        if not audio_settings_overrides:
            _TTS_MODEL_CACHE[resolved_name] = model
        return model


def load_tts_model(
    model_type: typing.Union[str, TextToSpeechType],
    model_path: typing.Union[str, Path],
    backend: typing.Optional[InferenceBackend] = None,
    half: bool = False,
):
    """Load an acoustic model from a voice dir."""
    if model_type == TextToSpeechType.GLOW_TTS:
        from larynx_tpu_torch.glow_tts import GlowTextToSpeech

        return GlowTextToSpeech(model_path, backend=backend, half=half)
    if model_type == TextToSpeechType.TACOTRON2:
        from larynx_tpu_torch.tacotron2 import Tacotron2TextToSpeech

        return Tacotron2TextToSpeech(model_path, backend=backend, half=half)
    raise ValueError(f"Unknown text to speech model type: {model_type}")


_VOCODER_MODEL_CACHE: typing.Dict[str, typing.Any] = {}


def get_vocoder_model(
    name_or_quality: typing.Union[str, VocoderQuality] = VocoderQuality.HIGH,
    backend: typing.Optional[InferenceBackend] = None,
    use_cuda: bool = False,  # accepted for API parity; ``device`` decides
    half: bool = False,
    denoiser_strength: float = 0.0,
    url_format: str = DEFAULT_VOICE_URL_FORMAT,
    custom_voices_dir: typing.Optional[typing.Union[str, Path]] = None,
    no_download: bool = False,
):
    """Find (or download), load and cache a vocoder; None if not found.
    ``half`` and ``denoiser_strength`` are the loaded model's defaults for
    its own ``mels_to_audio`` (the cache keeps the first load's, as
    ``larynx_tpu`` does); ``"griffin_lim"`` needs no files."""
    with _CACHE_LOCK:
        quality_key = (
            name_or_quality.value
            if isinstance(name_or_quality, VocoderQuality)
            else name_or_quality
        )
        maybe_model = _VOCODER_MODEL_CACHE.get(quality_key)
        if maybe_model is not None:
            return maybe_model
        if quality_key == VocoderType.GRIFFIN_LIM.value:
            model = load_vocoder_model(VocoderType.GRIFFIN_LIM, "")
            _VOCODER_MODEL_CACHE[quality_key] = model
            return model

        resolved = VOCODER_QUALITY.get(quality_key)
        if resolved is None:
            alias = VOCODER_ALIASES.get(quality_key, quality_key)
            resolved = alias if "/" in alias else alias.replace("-", "/", 1)
        if "/" not in resolved:
            raise ValueError(
                f"Unknown vocoder {name_or_quality!r} (expected high/medium/low or "
                "<model_type>/<model_name>)"
            )
        model_type, model_name = resolved.split("/", maxsplit=1)
        if model_type not in (VocoderType.HIFI_GAN.value, VocoderType.WAVEGLOW.value):
            raise NotImplementedError(f"vocoder type {model_type!r} is not ported yet")

        model_dir: typing.Optional[Path] = None
        voices_dirs = get_voices_dirs(custom_voices_dir)
        for voices_dir in voices_dirs:
            maybe_dir = voices_dir / model_type / model_name
            if valid_voice_dir(maybe_dir):
                model_dir = maybe_dir
                break
        if model_dir is None and not no_download:
            url = url_format.format(voice=f"{model_type}_{model_name}")
            try:
                model_dir = download_voice(model_name, voices_dirs[0], url)
            except Exception:
                _LOGGER.exception("download failed for vocoder %s", model_name)
                return None
        if model_dir is None:
            return None

        model = load_vocoder_model(VocoderType(model_type), model_dir, backend=backend, half=half,
                                   denoiser_strength=denoiser_strength)
        _VOCODER_MODEL_CACHE[quality_key] = model
        return model


def load_vocoder_model(
    model_type: typing.Union[str, VocoderType],
    model_path: typing.Union[str, Path],
    backend: typing.Optional[InferenceBackend] = None,
    half: bool = False,
    denoiser_strength: float = 0.0,
):
    """Load a vocoder from its dir (Griffin-Lim has none: any path; it runs
    in float32 and has no denoiser)."""
    if model_type == VocoderType.GRIFFIN_LIM:
        from larynx_tpu_torch.griffin_lim import GriffinLimVocoder

        return GriffinLimVocoder()
    if model_type == VocoderType.HIFI_GAN:
        from larynx_tpu_torch.hifi_gan import HiFiGanVocoder

        return HiFiGanVocoder(model_path, backend=backend, half=half,
                              denoiser_strength=denoiser_strength)
    if model_type == VocoderType.WAVEGLOW:
        from larynx_tpu_torch.waveglow import WaveGlowVocoder

        return WaveGlowVocoder(model_path, backend=backend, half=half,
                               denoiser_strength=denoiser_strength)
    raise ValueError(f"Unknown vocoder model type: {model_type}")
