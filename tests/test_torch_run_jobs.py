"""The port's pipelined batch path against the JAX package, on CPU.

``text_to_speech``'s ``_run_jobs`` (consecutive and interleaved grouping,
every encode first, decodes on the predicted mel bucket, lookahead, vocode
pooling across voices, the drain pointer), the engine's predicted bucket and
its gated encode + decode, ``_pool_rows`` and ``/api/stats``.  Two small
GlowTTS voices (hidden 64, 2 flow blocks, different random weights) share a
vctk_small-style HiFi-GAN (ResBlock2, 32 initial channels); the same numpy
params feed both packages, at noise 0 where the two are compared, so both
see the same latent.

Tolerances:
  * ``text_to_speech`` against ``larynx_tpu`` with the same flags: 2 LSB
    per sample, the same texts, order and lengths
    (``tests/test_torch_pipeline.py``'s bound: float32 rounding moves a
    sample across an integer boundary at most once, and the peak with it).
  * pooled against per-unit (``LARYNX_TPU_VOCODE_POOL=0``), and a wider
    predicted bucket against the exact one at noise 0: 1 LSB, the JAX
    package's bound (``tests/test_pipeline.py``,
    ``tests/test_engine_ragged.py``): only the padded width a row is
    computed at changes.
  * the same shapes on the same path (an exact prediction, a mispredict's
    fallback, a seeded request, the gated encode + decode): bit for bit.
  * ``_pool_rows`` and the estimator's state against the JAX package's:
    exact.
"""

import asyncio
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import larynx_tpu
from larynx_tpu.audio import AudioSettings as JAudioSettings
from larynx_tpu.convert.native import save_params
from larynx_tpu.models.glow_tts import config_from_voice_json as j_config
from larynx_tpu.models.glow_tts import init_params as j_glow_init
from larynx_tpu.models.hifi_gan import hifi_gan_config_from_json as j_hifi_config
from larynx_tpu.models.hifi_gan import init_params as j_hifi_init
from larynx_tpu.runtime.engine import SynthesisEngine as JEngine
from larynx_tpu.runtime.engine import _pool_rows as j_pool_rows

import larynx_tpu_torch
from larynx_tpu_torch.audio import AudioSettings
from larynx_tpu_torch.models.glow_tts import config_from_voice_json as t_config
from larynx_tpu_torch.models.hifi_gan import hifi_gan_config_from_json as t_hifi_config
from larynx_tpu_torch.runtime import engine as tengine
from larynx_tpu_torch.runtime.engine import SynthesisEngine
from larynx_tpu_torch.weights import params_from_jax

from test_torch_pipeline import AUDIO, PHONEME_TABLE, VOICE_CONFIG

LSB = 2
POOL_LSB = 1
VOICE_A = "en-us_torch_jobs_a-glow_tts"
VOICE_B = "en-us_torch_jobs_b-glow_tts"
VOCODER = "hifi_gan/torch_jobs_small"
VOCODER_CONFIG = {
    "audio": {"num_mels": 80, "sampling_rate": 22050},
    "model": {
        "resblock": "2", "upsample_rates": [8, 8, 2, 2], "upsample_kernel_sizes": [16, 16, 4, 4],
        "upsample_initial_channel": 32, "resblock_kernel_sizes": [3, 5],
        "resblock_dilation_sizes": [[1, 2], [2, 6]],
    },
}
# two voices, four sentences in the order A A B A
MARKUP = (
    "<speak>"
    f'<voice name="{VOICE_A}"><s>One thing here.</s>'
    "<s>And something much longer follows it immediately.</s></voice>"
    f'<voice name="{VOICE_B}"><s>Second thing now.</s></voice>'
    f'<voice name="{VOICE_A}"><s>Third thing too.</s></voice>'
    "</speak>"
)


def _clear_caches():
    for module in (larynx_tpu, larynx_tpu_torch):
        module._TTS_MODEL_CACHE.clear()
        module._VOCODER_MODEL_CACHE.clear()
        module._ENGINE_CACHE.clear()


def _glow_params(seed):
    params = jax.tree.map(np.asarray, j_glow_init(jax.random.PRNGKey(seed),
                                                  j_config(VOICE_CONFIG)))
    rng = np.random.default_rng(seed)
    cp = params["decoder"]["coupling"]  # give the zero-init coupling output signal
    cp["end_w"] = (rng.standard_normal(cp["end_w"].shape) * 0.05).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def voices_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_jobs_voices")
    for seed, voice in enumerate((VOICE_A, VOICE_B)):
        lang, rest = voice.split("_", 1)
        voice_dir = root / lang / rest
        voice_dir.mkdir(parents=True)
        (voice_dir / "config.json").write_text(json.dumps(VOICE_CONFIG), encoding="utf-8")
        (voice_dir / "phonemes.txt").write_text(
            "".join(f"{i} {p}\n" for i, p in enumerate(PHONEME_TABLE)), encoding="utf-8")
        save_params(voice_dir / "generator.npz", _glow_params(seed))
    voc_dir = root / VOCODER
    voc_dir.mkdir(parents=True)
    (voc_dir / "config.json").write_text(json.dumps(VOCODER_CONFIG), encoding="utf-8")
    save_params(voc_dir / "generator.npz",
                j_hifi_init(jax.random.PRNGKey(2), j_hifi_config(VOCODER_CONFIG)))
    _clear_caches()
    yield root
    _clear_caches()


def _tts(module, voices_dir, text=MARKUP, **kwargs):
    extra = {"device": "cpu"} if module is larynx_tpu_torch else {}
    return list(module.text_to_speech(
        text, voice_or_lang=VOICE_A, vocoder_or_quality=VOCODER, ssml=True,
        custom_voices_dir=voices_dir, no_download=True, tts_settings={"noise_scale": 0.0},
        **kwargs, **extra))


def _lsb(a, b) -> int:
    assert a.dtype == b.dtype == np.int16 and a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


# -----------------------------------------------------------------------------
# text_to_speech


@pytest.mark.parametrize("interleaved", [False, True], ids=["consecutive", "interleaved"])
def test_text_to_speech_matches_jax(voices_dir, interleaved):
    """A two-voice SSML document through both packages' _run_jobs with the
    same flag: the same sentences in document order, the same lengths, each
    within 2 LSB."""
    _clear_caches()
    ref = _tts(larynx_tpu, voices_dir, interleaved_batching=interleaved)
    out = _tts(larynx_tpu_torch, voices_dir, interleaved_batching=interleaved)
    assert len(out) == len(ref) == 4
    assert [r.text for r in out] == [r.text for r in ref]
    for r, o in zip(ref, out):
        assert np.abs(r.audio.astype(np.int32)).max() > 1000
        assert _lsb(o.audio, r.audio) <= LSB


def test_interleaved_batching_reads_the_env(voices_dir, monkeypatch):
    """interleaved_batching=None reads LARYNX_TPU_INTERLEAVED_BATCHING."""
    _clear_caches()
    seen = []
    real = larynx_tpu_torch._plan_units

    def spy(jobs, max_batch, device, half=False, interleaved=False):
        seen.append(interleaved)
        return real(jobs, max_batch, device, half=half, interleaved=interleaved)

    monkeypatch.setattr(larynx_tpu_torch, "_plan_units", spy)
    monkeypatch.setenv("LARYNX_TPU_INTERLEAVED_BATCHING", "1")
    on = _tts(larynx_tpu_torch, voices_dir)
    monkeypatch.setenv("LARYNX_TPU_INTERLEAVED_BATCHING", "0")
    off = _tts(larynx_tpu_torch, voices_dir)
    assert seen == [True, False]
    assert [r.text for r in on] == [r.text for r in off]


def test_vocode_pooling_multivoice(voices_dir, monkeypatch):
    """Units that share a vocoder vocode as ONE pooled launch of all four
    rows; each sentence within 1 LSB of the per-unit path."""
    _clear_caches()
    calls = []
    real_launch = SynthesisEngine.vocode_launch

    def counting_launch(self, *args, **kw):
        calls.append(args[2] if len(args) > 2 else kw.get("n_valid"))
        return real_launch(self, *args, **kw)

    monkeypatch.setattr(SynthesisEngine, "vocode_launch", counting_launch)
    monkeypatch.setenv("LARYNX_TPU_VOCODE_POOL", "0")
    base = _tts(larynx_tpu_torch, voices_dir)
    per_unit_calls = list(calls)
    calls.clear()
    monkeypatch.setenv("LARYNX_TPU_VOCODE_POOL", "1")
    pooled = _tts(larynx_tpu_torch, voices_dir)

    assert len(per_unit_calls) >= 3
    assert calls == [4]  # every sentence's row in the single pooled launch
    assert [r.text for r in base] == [r.text for r in pooled]
    for a, b in zip(base, pooled):
        assert np.abs(b.audio.astype(np.int32)).max() > 1000
        assert _lsb(a.audio, b.audio) <= POOL_LSB


def test_pool_rows_matches_jax():
    rng = np.random.default_rng(0)
    shapes = ((4, 64), (2, 128), (1, 96))
    mels = [rng.standard_normal((b, m, 80)).astype(np.float32) for b, m in shapes]
    masks = [(rng.uniform(size=(b, m)) > 0.3).astype(np.float32) for b, m in shapes]
    n_valids, m_pool = (3, 2, 1), 128
    ref_mel, ref_mask = j_pool_rows(tuple(jnp.asarray(m) for m in mels),
                                    tuple(jnp.asarray(m) for m in masks), n_valids, m_pool)
    mel, mask = tengine._pool_rows([torch.from_numpy(m) for m in mels],
                                   [torch.from_numpy(m) for m in masks], n_valids, m_pool)
    assert mel.shape == (6, 128, 80) and mask.shape == (6, 128)
    np.testing.assert_array_equal(mel.numpy(), np.asarray(ref_mel))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))


def test_results_yield_in_document_order(voices_dir, monkeypatch):
    """Interleaved, voice A's units come first: sentence 3 is done before
    voice B's sentence 2 is collected, but yields after it."""
    _clear_caches()
    monkeypatch.setenv("LARYNX_TPU_VOCODE_POOL", "0")
    jobs = larynx_tpu_torch._build_jobs(MARKUP, VOICE_A, VOCODER, ssml=True,
                                        custom_voices_dir=voices_dir, no_download=True)
    units = larynx_tpu_torch._plan_units(jobs, 8, torch.device("cpu"), interleaved=True)
    unit_of = {i: k for k, (_engine, indices) in enumerate(units) for i in indices}
    assert unit_of[3] < unit_of[2] == len(units) - 1
    collects = []
    real_collect = SynthesisEngine.vocode_collect

    def counting_collect(parts, b):
        collects.append(b)
        return real_collect(parts, b)

    monkeypatch.setattr(SynthesisEngine, "vocode_collect", staticmethod(counting_collect))
    results = larynx_tpu_torch.text_to_speech(
        MARKUP, voice_or_lang=VOICE_A, vocoder_or_quality=VOCODER, ssml=True,
        custom_voices_dir=voices_dir, no_download=True, tts_settings={"noise_scale": 0.0},
        interleaved_batching=True, device="cpu")
    seen = []
    for result in results:
        seen.append((result.text.strip(), len(collects)))
    assert [text for text, _ in seen] == [
        "One thing here.", "And something much longer follows it immediately.",
        "Second thing now.", "Third thing too."]
    # each sentence yields once its unit and every earlier sentence's are in
    assert [n for _, n in seen] == [max(unit_of[k] for k in range(i + 1)) + 1 for i in range(4)]
    assert seen[3][1] == seen[2][1] == len(units)


def test_launch_order(voices_dir, monkeypatch):
    """Three units of one voice (max_batch 1) per unit: every encode before
    any decode, and unit j + 1's vocode launched before unit j's collect."""
    _clear_caches()
    monkeypatch.setenv("LARYNX_TPU_VOCODE_POOL", "0")
    events = []
    unit_of_parts = {}
    real = {name: getattr(SynthesisEngine, name)
            for name in ("encode_launch", "decode_launch_predicted", "vocode_launch")}
    real_collect = SynthesisEngine.vocode_collect

    def encode(self, *args, **kw):
        events.append(("encode", None))
        return real["encode_launch"](self, *args, **kw)

    def decode(self, *args, **kw):
        events.append(("decode", kw["batch_index"]))
        return real["decode_launch_predicted"](self, *args, **kw)

    def vocode(self, *args, **kw):
        parts = real["vocode_launch"](self, *args, **kw)
        unit_of_parts[id(parts)] = kw["batch_index"]
        events.append(("vocode", kw["batch_index"]))
        return parts

    def collect(parts, b):
        events.append(("collect", unit_of_parts[id(parts)]))
        return real_collect(parts, b)

    monkeypatch.setattr(SynthesisEngine, "encode_launch", encode)
    monkeypatch.setattr(SynthesisEngine, "decode_launch_predicted", decode)
    monkeypatch.setattr(SynthesisEngine, "vocode_launch", vocode)
    monkeypatch.setattr(SynthesisEngine, "vocode_collect", staticmethod(collect))
    out = list(larynx_tpu_torch.text_to_speech(
        "One thing here. Second thing now. Third thing too.", voice_or_lang=VOICE_A,
        vocoder_or_quality=VOCODER, custom_voices_dir=voices_dir, no_download=True,
        tts_settings={"noise_scale": 0.0}, max_batch=1, device="cpu"))
    assert len(out) == 3
    kinds = [k for k, _ in events]
    assert kinds.count("encode") == 3 and kinds.count("collect") == 3
    assert max(i for i, k in enumerate(kinds) if k == "encode") < kinds.index("decode")
    at = {event: i for i, event in enumerate(events)}
    for j in range(2):
        assert at[("vocode", j + 1)] < at[("collect", j)], events
    assert [u for k, u in events if k == "collect"] == [0, 1, 2]


# -----------------------------------------------------------------------------
# The engine's predicted bucket (tests/test_engine_ragged.py:144-276, :357-455)


@pytest.fixture(scope="module")
def models():
    return _glow_params(0), jax.tree.map(
        np.asarray, j_hifi_init(jax.random.PRNGKey(2), j_hifi_config(VOCODER_CONFIG)))


@pytest.fixture
def engine(models):
    glow_np, voc_np = models
    return SynthesisEngine(
        params_from_jax(glow_np, "glow_tts"), t_config(VOICE_CONFIG), AudioSettings(**AUDIO),
        vocoder_params=params_from_jax(voc_np, "hifi_gan"),
        vocoder_cfg=t_hifi_config(VOCODER_CONFIG), seed=7, device="cpu")


def _ids(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 46, size=t).astype(np.int64) for t in lengths]


def _exact(engine, ids, length_scale=1.0, **kw):
    enc, g = engine.encode_launch(ids, length_scale)
    y = enc.lengths.numpy()
    parts, rows = engine.synthesize_launch(enc, y, g, len(ids), batch_index=0, **kw)
    return engine.crop_rows(engine.vocode_collect(parts, rows), y, len(ids), 0.0), y


def _predicted(engine, ids, length_scale=1.0, **kw):
    enc, g = engine.encode_launch(ids, length_scale)
    parts, rows, y = engine.synthesize_launch_predicted(
        enc, g, len(ids), max_id_len=max(len(s) for s in ids), length_scale=length_scale,
        batch_index=0, **kw)
    return engine.crop_rows(engine.vocode_collect(parts, rows), y, len(ids), 0.0), y, rows


def test_predicted_bucket_matches_synced_path(engine):
    """A prediction that lands on the exact bucket decodes the same shapes
    with the same noise: bit for bit at the default noise scale.  A wider
    one changes only the padded width at noise 0: 1 LSB."""
    ids = _ids(5, (12, 16))
    ref, y = _exact(engine, ids)
    exact = engine.policy.mel_bucket(int(y[:2].max()))
    engine._frames_per_token = exact / (16 * tengine.BUCKET_MARGIN) * 0.999
    got, y2, _ = _predicted(engine, ids)
    assert engine._bucket_mispredicts == 0
    np.testing.assert_array_equal(y2, y)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)

    quiet, _ = _exact(engine, ids, noise_scale=0.0)
    engine._frames_per_token = 4 * exact / 16  # a bucket several times wider
    wide, _, _ = _predicted(engine, ids, noise_scale=0.0)
    assert engine._bucket_mispredicts == 0
    for a, b in zip(quiet, wide):
        assert _lsb(a, b) <= POOL_LSB


def test_predicted_bucket_mispredict_falls_back(engine):
    """A learned ratio too small: the decode runs again at the exact bucket,
    counted, with the exact path's audio."""
    ids = _ids(6, (12, 16))
    ref, y = _exact(engine, ids, length_scale=12.0)
    engine._frames_per_token = 1e-3
    got, y2, _ = _predicted(engine, ids, length_scale=12.0)
    assert engine._bucket_mispredicts == 1
    np.testing.assert_array_equal(y2, y)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)


def test_predicted_bucket_skipped_for_seeded_requests(engine):
    """An explicit seed (or per-row seeds) takes the exact bucket: the noise
    of a wider bucket would be another draw."""
    ids = _ids(7, (12,))
    engine._frames_per_token = 50.0  # would predict a huge bucket
    got, _, rows = _predicted(engine, ids, seed=11)
    ref, _ = _exact(engine, ids, seed=11)
    np.testing.assert_array_equal(got[0], ref[0])
    got_rows, _, _ = _predicted(engine, ids, row_seeds=[11])
    ref_rows, _ = _exact(engine, ids, row_seeds=[11])
    np.testing.assert_array_equal(got_rows[0], ref_rows[0])
    assert engine._bucket_mispredicts == 0


def test_predicted_bucket_length_scale_normalized(engine):
    """The estimator counts frames per token at length scale 1: a length
    scale 3 request neither mispredicts nor triples the ratio."""
    ids = _ids(8, (12, 16))
    _, y1, _ = _predicted(engine, ids)
    ratio = engine._frames_per_token
    assert ratio > 0.0
    _, y3, _ = _predicted(engine, ids, length_scale=3.0)
    assert engine._bucket_mispredicts == 0
    assert np.all(y3 >= y1)
    assert engine._frames_per_token == pytest.approx(ratio, rel=0.15)
    _, y_again, _ = _predicted(engine, ids)
    assert engine._bucket_mispredicts == 0
    np.testing.assert_array_equal(y_again, y1)


def test_fused_encode_decode_matches_two_step(engine, monkeypatch):
    """LARYNX_TPU_FUSED_ENCODE=1: encode and the predicted decode back to
    back give the two-step predicted path's audio bit for bit."""
    monkeypatch.setenv("LARYNX_TPU_FUSED_ENCODE", "1")
    ids = _ids(7, (12, 16))
    engine.synthesize_batch(ids, batch_index=0)  # warms the estimator
    assert engine._frames_per_token > 0.0
    ref, y_ref, _ = _predicted(engine, ids)
    fused = engine.encode_decode_launch_predicted(ids, 1.0, batch_index=0)
    assert fused is not None
    mel, z_mask, y_got, _g = fused
    parts = engine.vocode_launch(mel, z_mask, 2, 0.0, y_lengths=y_got, batch_index=0)
    got = engine.crop_rows(engine.vocode_collect(parts, mel.shape[0]), y_got, 2, 0.0)
    np.testing.assert_array_equal(y_got, y_ref)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)


def test_fused_encode_decode_mispredict_falls_back(engine, monkeypatch):
    monkeypatch.setenv("LARYNX_TPU_FUSED_ENCODE", "1")
    ids = _ids(8, (12, 16))
    ref, y = _exact(engine, ids, length_scale=12.0)
    engine._frames_per_token = 1e-3
    fused = engine.encode_decode_launch_predicted(ids, 12.0, batch_index=0)
    assert fused is not None and engine._bucket_mispredicts == 1
    mel, z_mask, y_got, _g = fused
    parts = engine.vocode_launch(mel, z_mask, 2, 0.0, y_lengths=y_got, batch_index=0)
    got = engine.crop_rows(engine.vocode_collect(parts, mel.shape[0]), y_got, 2, 0.0)
    np.testing.assert_array_equal(y_got, y)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)


def test_fused_encode_decode_gates(engine, monkeypatch):
    """Off by default; declines on a cold estimator even when on; a seeded
    synthesize_batch never reaches it."""
    ids = _ids(9, (12,))
    engine._frames_per_token = 10.0
    monkeypatch.delenv("LARYNX_TPU_FUSED_ENCODE", raising=False)
    assert not tengine.fused_encode_enabled()
    assert engine.encode_decode_launch_predicted(ids) is None
    monkeypatch.setenv("LARYNX_TPU_FUSED_ENCODE", "1")
    engine._frames_per_token = 0.0
    assert engine.encode_decode_launch_predicted(ids) is None

    engine._frames_per_token = 10.0
    reached = []
    real = SynthesisEngine.encode_decode_launch_predicted
    monkeypatch.setattr(SynthesisEngine, "encode_decode_launch_predicted",
                        lambda self, *a, **k: reached.append(1) or real(self, *a, **k))
    engine.synthesize_batch(ids, seed=3)
    assert reached == []
    engine.synthesize_batch(ids)
    assert reached == [1]


def test_estimator_matches_jax(models):
    """_observe_frames_per_token and _predict_mel_bucket step for step with
    the JAX engine's on one sequence of observations (new maxima jump, the
    rest decay by 0.99; length scale divides out)."""
    glow_np, voc_np = models
    ref = JEngine(glow_np, j_config(VOICE_CONFIG), JAudioSettings(**AUDIO),
                  vocoder_kind="hifi_gan", vocoder_params=voc_np,
                  vocoder_cfg=j_hifi_config(VOCODER_CONFIG))
    port = SynthesisEngine(
        params_from_jax(glow_np, "glow_tts"), t_config(VOICE_CONFIG), AudioSettings(**AUDIO),
        vocoder_kind="none", device="cpu")
    rng = np.random.default_rng(1)
    for _ in range(200):
        actual, n_ids = int(rng.integers(8, 3000)), int(rng.integers(0, 200))
        ls = float(rng.choice([0.5, 1.0, 1.7, 6.0]))
        for engine in (ref, port):
            engine._observe_frames_per_token(actual, n_ids, engine._length_scale_max([ls, 1.0]))
        assert port._frames_per_token == ref._frames_per_token
        assert port._predict_mel_bucket(n_ids, ls) == ref._predict_mel_bucket(n_ids, ls)
    assert port._length_scale_max(0.0) == ref._length_scale_max(0.0)


# -----------------------------------------------------------------------------
# /api/stats


def test_api_stats_reports_the_estimator(voices_dir):
    """Each cached engine's entry carries frames_per_token (3 places) and
    bucket_mispredicts, as the JAX route's does."""
    from aiohttp.test_utils import TestClient, TestServer

    from larynx_tpu_torch.server.app import ServerSettings, create_app

    _clear_caches()
    _tts(larynx_tpu_torch, voices_dir)  # the library path warms the estimators
    loop = asyncio.new_event_loop()

    async def stats():
        client = TestClient(TestServer(create_app(ServerSettings(
            voices_dir=str(voices_dir), quality="low", device="cpu"))))
        await client.start_server()
        try:
            resp = await client.get("/api/stats")
            return resp.status, await resp.json()
        finally:
            await client.close()

    try:
        status, body = loop.run_until_complete(stats())
    finally:
        loop.close()
    assert status == 200
    engines = [e for e in larynx_tpu_torch._ENGINE_CACHE.values() if e is not None]
    assert len(engines) == len(body["engines"]) == 2
    for key, engine in larynx_tpu_torch._ENGINE_CACHE.items():
        entry = body["engines"][str(key)]
        assert engine._frames_per_token > 0.0
        assert entry["frames_per_token"] == round(engine._frames_per_token, 3)
        assert entry["bucket_mispredicts"] == engine._bucket_mispredicts
    _clear_caches()
