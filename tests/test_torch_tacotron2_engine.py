"""Tacotron2 on the engine's batch path (``runtime/tacotron2_engine.py``), on
the CPU at a tiny size: the engine against the plain float64 reference
(``portbench/reference/tacotron2.py``, NVIDIA's forward pass) on seeded
random weights, the engine's rules (per-row prenet masks and step caps, the
stop lengths, padding rows, the blocked early exit), the fallback's B=1
``phonemes_to_mels``, the entry points and the counters.

Tolerances:
  * mel: 1e-4 absolute on values of O(1).  The engine runs float32 and the
    reference float64; over the 40 autoregressive steps each frame feeds the
    next through the prenet, and the difference stays under 1e-5 (the port
    against the JAX package over 40 steps: 2.4e-7, ``test_torch_tacotron2``).
    The reference itself in bfloat16 misses by more than 1e-3
    (``test_a_bfloat16_decode_fails_the_mel_tolerance``).
  * the same row in two batches of the engine: 1e-5, the encoder's bound
    (another batch changes only the summation extents of its products).
  * int16 audio: 2 LSB per sample at the same length, the vocoder's
    tolerance (``test_torch_pipeline``): both sides peak-normalise float32
    audio and truncate it, so a rounding difference of the float audio may
    move a sample by one step, the peak's by another.
  * stop lengths and counters: equal.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import larynx_tpu_torch
from larynx_tpu_torch.audio import AudioSettings
from larynx_tpu_torch.convert.native import save_params
from larynx_tpu_torch.models.tacotron2 import Tacotron2Config
from larynx_tpu_torch.models.tacotron2 import model as tm
from larynx_tpu_torch.models.waveglow.config import WaveGlowConfig
from larynx_tpu_torch.runtime import trace
from larynx_tpu_torch.runtime.engine import SynthesisEngine
from larynx_tpu_torch.runtime.scheduler import BatchScheduler
from larynx_tpu_torch.runtime.tacotron2_engine import Tacotron2Engine
from larynx_tpu_torch.weights import init_params, params_from_jax
from portbench.reference import ar_rules
from portbench.reference import tacotron2 as reference

from test_torch_pipeline import PHONEME_TABLE

MEL_TOL = 1e-4
BATCH_TOL = 1e-5
LSB = 2

CFG = Tacotron2Config(
    num_symbols=len(PHONEME_TABLE), symbols_embedding_dim=32, encoder_embedding_dim=32,
    encoder_n_convolutions=2, prenet_dim=16, attention_rnn_dim=48, decoder_rnn_dim=48,
    attention_dim=24, attention_location_n_filters=8, attention_location_kernel_size=15,
    postnet_embedding_dim=32, postnet_n_convolutions=3, max_decoder_steps=40,
)
REF_CFG = dataclasses.asdict(CFG)
WG_CFG = WaveGlowConfig(flows=4, early_every=2, wn_channels=16, wn_layers=2, upsample_kernel=512,
                        upsample_stride=256)
AUDIO = {"signal_norm": False, "convert_db_to_amp": False, "do_dynamic_range_compression": False}
SEED = 1234
HELD_OFF = -50.0  # the gate's bias that no random row crosses
# a live gate: the init's gate logits drift by ~1e-2 over 40 steps; scaled by
# 200 with a bias of -2.5 rows cross 0 after a frame or a dozen, or never
LIVE = (-2.5, 200.0)


def _native(gate_bias, gate_scale=1.0, seed=0):
    tree = init_params(torch.Generator().manual_seed(seed), CFG)
    tree["decoder"]["gate"]["w"] *= gate_scale
    tree["decoder"]["gate"]["b"][:] = gate_bias
    return tree


def _waveglow_native():
    """The port's WaveGlow init with its couplings' end 1x1s perturbed (the
    init's zeros make every coupling the identity: silence at sigma 0)."""
    tree = init_params(torch.Generator().manual_seed(9), WG_CFG)
    rng = np.random.default_rng(9)
    for flow in tree["flows"]:
        flow["wn"]["end_w"] = (rng.standard_normal(flow["wn"]["end_w"].shape) * 0.1).astype(
            np.float32)
    return tree


def _reference_params(params, dtype=torch.float64):
    """The port's tree in ``dtype`` with NVIDIA's two LSTM biases (the fused
    one and zero)."""
    tree = {k: _reference_params(v, dtype) if isinstance(v, dict) else
            [_reference_params(x, dtype) for x in v] if isinstance(v, list) else v.to(dtype)
            for k, v in params.items()}
    if "w_ih" in tree:
        tree["b_ih"], tree["b_hh"] = tree["b"], torch.zeros_like(tree["b"])
    return tree


def _engine(gate=(HELD_OFF, 1.0), **kwargs):
    return SynthesisEngine(
        params_from_jax(_native(*gate), "tacotron2"), CFG, AudioSettings(**AUDIO),
        vocoder_kind="waveglow", vocoder_params=params_from_jax(_waveglow_native(), "waveglow"),
        vocoder_cfg=WG_CFG, waveglow_sigma=0.0, device="cpu", seed=SEED, **kwargs)


@pytest.fixture(scope="module")
def held():
    return _engine()


@pytest.fixture(scope="module")
def live():
    return _engine(LIVE)


def _ids(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, CFG.num_symbols, size=n).astype(np.int64) for n in lengths]


def _reference_row(engine, ids, entropy, cap):
    """(mel [cap, C], length) of one row alone at its masks' entropy."""
    params = _reference_params(engine.glow_params)
    state = np.random.SeedSequence(entropy).generate_state(1)
    gen = torch.Generator().manual_seed(int(state[0]))
    keep = torch.rand((cap, 2, CFG.prenet_dim), generator=gen) < 1.0 - CFG.p_prenet_dropout
    with torch.no_grad():
        mel, length = reference.infer(params, REF_CFG, torch.as_tensor(ids), keep, cap)
    return mel.float(), length


def _decode(engine, ids, **kwargs):
    """(mel [B, M, C], lengths [B_bucket]) of the engine's encode launch."""
    out, _g = engine.encode_launch(ids, **kwargs)
    return out.mel, out.lengths.numpy()


def _counters():
    return dict(trace.counters())


def _delta(before):
    after = _counters()
    return {k: after.get(k, 0) - before.get(k, 0) for k in set(after) | set(before)}


# ----------------------------------------------------------------------
# the engine against the reference


def test_a_tacotron2_config_builds_the_tacotron2_engine(held):
    assert type(held) is Tacotron2Engine and held.autoregressive
    half = _engine(half=True)
    assert half.dtype == torch.float32 and half.voc_dtype == torch.bfloat16
    assert held.policy.n_sqz == 1 and held._glow_graphs is None
    with pytest.raises(ValueError, match="one device"):
        _engine(mesh=object())


def test_rows_match_the_reference_with_their_caps_and_a_padding_row(held):
    ids = _ids((9, 14, 6))
    caps = [30, 21, 12]
    mel, lengths = _decode(held, ids, max_decoder_steps=caps)
    assert list(lengths) == caps + [0]  # batch bucket 4: the padding row stopped at 0
    assert mel.shape == (4, held.policy.mel_bucket(30), CFG.mel_channels)
    for r, (x, cap) in enumerate(zip(ids, caps)):
        want, length = _reference_row(held, x, [SEED, 0], cap)
        assert length == cap
        torch.testing.assert_close(mel[r, :cap], want, rtol=0, atol=MEL_TOL)


def test_caps_default_to_the_fallbacks_budget_and_clamp(held):
    ids = _ids((3, 20))
    assert list(held.step_caps(ids)) == [40, 40]  # max_decoder_steps 40 < 10 x 16
    assert list(held.step_caps(ids, 7)) == [7, 7]
    assert list(held.step_caps(ids, [500, 0])) == [160, 1]  # 10 x the 16 bucket; at least 1
    assert list(held.step_caps(ids, [500, 400])) == [160, 320]  # 20 ids: the 32 bucket


def test_a_live_gate_stops_each_row_where_the_reference_does(live):
    ids = _ids((9, 14, 6, 11), seed=5)
    mel, lengths = _decode(live, ids)
    want = [_reference_row(live, x, [SEED, 0], 40) for x in ids]
    assert list(lengths) == [length for _mel, length in want]
    assert min(lengths) < 40 and len(set(lengths)) > 1  # the gate, not the cap, ends rows
    for r, (w, length) in enumerate(want):
        torch.testing.assert_close(mel[r, :length], w[:length], rtol=0, atol=MEL_TOL)


def test_the_early_exit_equals_the_full_budget_decode(live):
    ids = _ids((9, 14, 6, 11), seed=11)  # every row stops by its gate, by frame 18
    before = _counters()
    mel, lengths = _decode(live, ids)
    steps = _delta(before)["engine.ar_steps"]
    assert max(lengths) + tm.postnet_halo(CFG) <= steps < 40
    assert steps % tm.STOP_CHECK_STEPS == 0
    padded = np.zeros((4, 16), dtype=np.int64)
    for r, x in enumerate(ids):
        padded[r, : len(x)] = x
    keep = tm.row_keep_masks(CFG, 40, live.mask_entropies(4, 4))
    params = live.glow_params
    with torch.no_grad():  # one block of the whole budget: no stop read before its end
        memory, mask = tm.encode(params, CFG, torch.as_tensor(padded),
                                 torch.as_tensor([len(x) for x in ids]))
        mels, full_lengths, full_steps, _ = tm.decode_blocked(
            params, CFG, memory, mask, np.full((4,), 40), keep, block=40)
        full = mels + tm.postnet(params, CFG, mels)
    assert full_steps == 40 and list(full_lengths) == list(lengths)
    for r, length in enumerate(lengths):
        torch.testing.assert_close(mel[r, :length], full[r, :length], rtol=0, atol=BATCH_TOL)


@pytest.mark.parametrize("block", [4, 7])
def test_the_decode_ahead_equals_the_decode_in_turn(live, block):
    """A block launched before the last one's stops are read (``ahead``, the
    CUDA default) gives the frames, lengths, steps and blocks read of the
    decode that reads each block's stops before the next launch; the rows
    stop by their gates, so the decode ahead launches a block past the end
    and drops it."""
    ids = _ids((9, 14, 6, 11), seed=11)
    padded = np.zeros((4, 16), dtype=np.int64)
    for r, x in enumerate(ids):
        padded[r, : len(x)] = x
    caps = np.array([40, 40, 25, 30])
    params, out = live.glow_params, {}
    with torch.no_grad():
        memory, mask = tm.encode(params, CFG, torch.as_tensor(padded),
                                 torch.as_tensor([len(x) for x in ids]))
        for ahead in (False, True):
            keep = tm.RowKeepMasks(CFG, live.mask_entropies(4, 4))
            out[ahead] = tm.decode_blocked(params, CFG, memory, mask, caps, keep, block=block,
                                           ahead=ahead)
    (mel, lengths, steps, blocks), (mel_ahead, lengths_ahead, steps_ahead, blocks_ahead) = \
        out[False], out[True]
    assert steps < 25 and steps % block == 0 and blocks == steps // block
    assert (steps_ahead, blocks_ahead, list(lengths_ahead)) == (steps, blocks, list(lengths))
    assert torch.equal(mel_ahead, mel)


def test_a_row_is_unchanged_by_its_batchmates_and_the_budget(live):
    ids = _ids((9, 14, 6, 11), seed=5)
    alone, (n_alone,) = _decode(live, ids[:1], seed=[77])
    with_longer, lengths = _decode(live, ids, seed=[77, 3, 4, 5], max_decoder_steps=[40, 40, 8, 30])
    others, lengths_2 = _decode(live, [ids[0], ids[2]], seed=[77, 9])
    assert lengths[0] == lengths_2[0] == n_alone
    for mel in (with_longer, others):
        torch.testing.assert_close(mel[0, :n_alone], alone[0, :n_alone], rtol=0, atol=BATCH_TOL)


def test_a_rows_audio_is_unchanged_by_shorter_batchmates(held):
    ids = _ids((9, 14, 6), seed=2)
    (alone,) = held.synthesize_batch(ids[1:2], seed=[31], max_decoder_steps=30)
    batch = held.synthesize_batch(ids, seed=[5, 31, 6], max_decoder_steps=[20, 30, 10])
    assert [len(a) for a in batch] == [20 * 256, 30 * 256, 10 * 256]
    assert batch[1].shape == alone.shape and np.abs(alone.astype(np.int32)).max() > 1000
    assert np.abs(batch[1].astype(np.int32) - alone.astype(np.int32)).max() <= LSB


def test_keep_masks_are_per_row_and_prefix_stable():
    cfg = CFG
    long, short = tm.row_keep_masks(cfg, 30, [[5, 0], None, [7, 0]]), \
        tm.row_keep_masks(cfg, 12, [[5, 0], [6, 0], [7, 0]])
    assert long.shape == (30, 2, 3, cfg.prenet_dim) and not long[:, :, 1].any()
    assert torch.equal(long[:12, :, 0], short[:, :, 0]) and torch.equal(long[:12, :, 2], short[:, :, 2])
    for r in range(3):
        rule = ar_rules.keep_masks(REF_CFG, 5 + r, 12)
        assert torch.equal(short[:, :, r], rule)
    # the fallback's B=1 masks are the draw of SeedSequence([seed]) they were
    state = np.random.SeedSequence([SEED]).generate_state(1)
    u = torch.rand((12, 2, 1, cfg.prenet_dim), generator=torch.Generator().manual_seed(int(state[0])))
    assert torch.equal(tm.draw_keep_masks(cfg, 12, 1, SEED), u < 0.5)


def test_mask_entropies_follow_the_engines_rule(held):
    """A row's masks follow its own seed, else the call's, never its place
    in the batch."""
    assert held.mask_entropies(2, 4) == [[SEED, 0], [SEED, 0], None, None]
    assert held.mask_entropies(2, 2, seed=9) == [[9, 0], [9, 0]]
    assert held.mask_entropies(3, 4, seed=[None, 9, None]) == [[SEED, 0], [9, 0], [SEED, 0],
                                                                None]


def test_a_bfloat16_decode_fails_the_mel_tolerance(held):
    (x,) = _ids((9,))
    want, _ = _reference_row(held, x, [SEED, 0], 30)
    low = _reference_params(held.glow_params, torch.bfloat16)
    keep = ar_rules.keep_masks(REF_CFG, SEED, 30)
    with torch.no_grad():
        got, _ = reference.infer(low, REF_CFG, torch.as_tensor(x), keep, 30)
    assert float((got.float() - want).abs().max()) > 10 * MEL_TOL


# ----------------------------------------------------------------------
# the counters and spans


def test_counters_on_a_known_batch(held):
    trace.reset()
    trace.enable(True)
    try:
        before = _counters()
        held.synthesize_batch(_ids((9, 14, 6)), max_decoder_steps=[30, 20, 25])
        delta = _delta(before)
        spans = trace.snapshot()["buffer"]
    finally:
        trace.enable(False)
        trace.reset()
    # budget 30: one block (32 steps a block), every row at its cap by 30
    assert delta["engine.ar_steps"] == 30 and delta["engine.ar_stop_checks"] == 1
    assert delta["engine.ar_frames"] == 4 * 30
    # one vocoder group of the three rows at the 64-frame bucket of the longest
    assert delta["engine.valid_frames"] == 75 and delta["engine.vocode_frames"] == 3 * 64
    (decode,) = [s for s in spans if s["name"] == "engine.decode"]
    assert decode["attrs"] == {"family": "tacotron2", "rows": 4, "text_bucket": 16, "steps": 30,
                               "blocks": 1}
    checks = [s for s in spans if s["name"] == "engine.ar_stop_check"]
    assert len(checks) == 1 and all(s["parent"] == decode["seq"] for s in checks)
    (batch,) = [s for s in spans if s["name"] == "engine.batch"]
    assert {s["name"] for s in spans if s["parent"] == batch["seq"]} >= {
        "engine.pad", "engine.encode", "engine.decode", "engine.lengths_wait", "engine.vocode",
        "engine.collect", "engine.crop"}


# ----------------------------------------------------------------------
# the fallback and the entry points

VOICE = "en-us_t2_engine-tacotron2"
VOCODER = "waveglow/t2_engine"
TEXT = "Hello world. A second sentence."


def _clear_caches():
    larynx_tpu_torch._TTS_MODEL_CACHE.clear()
    larynx_tpu_torch._VOCODER_MODEL_CACHE.clear()
    larynx_tpu_torch._ENGINE_CACHE.clear()


@pytest.fixture(scope="module")
def voices(tmp_path_factory):
    """A Tacotron2 voice (prenet dropout on, gate held off) and a WaveGlow
    vocoder at sigma 0, from the port's own init."""
    root = tmp_path_factory.mktemp("t2_engine_voices")
    lang, rest = VOICE.split("_", 1)
    voice_dir = root / lang / rest
    voice_dir.mkdir(parents=True)
    (voice_dir / "config.json").write_text(json.dumps(
        {"audio": dict(AUDIO, mel_channels=CFG.mel_channels), "model": REF_CFG}))
    (voice_dir / "phonemes.txt").write_text(
        "".join(f"{i} {p}\n" for i, p in enumerate(PHONEME_TABLE)), encoding="utf-8")
    save_params(voice_dir / "generator.npz", _native(HELD_OFF))
    voc_dir = root / VOCODER
    voc_dir.mkdir(parents=True)
    (voc_dir / "config.json").write_text(json.dumps(
        dict(dataclasses.asdict(WG_CFG), sigma=0.0)))
    save_params(voc_dir / "generator.npz", _waveglow_native())
    _clear_caches()
    yield root
    _clear_caches()


def _job(voices):
    (job,) = larynx_tpu_torch._build_jobs("Hello world.", VOICE, VOCODER, custom_voices_dir=voices,
                                          no_download=True)
    return job


@pytest.mark.parametrize("strength", [0.0, 0.005], ids=["no-denoiser", "denoiser"])
def test_a_seeded_row_is_the_fallbacks_b1_run(voices, strength):
    """With the denoiser on, the engine cuts each row to its frames before
    the STFT, as the fallback's vocoder does."""
    job = _job(voices)
    engine = larynx_tpu_torch._get_engine(job["tts_model"], job["vocoder_model"], "cpu")
    assert type(engine) is Tacotron2Engine
    want = job["tts_model"].phonemes_to_mels(job["ids"], settings={"seed": 321}, device="cpu")
    mel, (length,) = _decode(engine, [job["ids"]], seed=[321])
    got = mel[:1, :length].transpose(1, 2).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=BATCH_TOL)
    (audio,) = engine.synthesize_batch([job["ids"]], seed=[321], denoiser_strength=strength)
    fallback = larynx_tpu_torch._sentence_task_fallback(
        job, {"seed": 321}, {"denoiser_strength": strength}, "cpu")
    assert audio.shape == fallback.shape and np.abs(fallback.astype(np.int32)).max() > 1000
    assert np.abs(audio.astype(np.int32) - fallback.astype(np.int32)).max() <= LSB


def _no_fallback(monkeypatch):
    def fail(*args, **kwargs):
        raise AssertionError("a Tacotron2 sentence took the fallback")

    monkeypatch.setattr(larynx_tpu_torch, "_sentence_task_fallback", fail)


@pytest.mark.parametrize("scheduled", [False, True], ids=["text_to_speech", "scheduler"])
def test_entry_points_run_the_engine(voices, monkeypatch, scheduled):
    """``text_to_speech`` (``_run_jobs``'s staged calls) and the scheduler
    take the engine: its spans, no fallback, and the same audio as a call
    without the scheduler (a row's masks follow the call's seed, not its
    place in a group)."""
    kwargs = dict(voice_or_lang=VOICE, vocoder_or_quality=VOCODER, custom_voices_dir=voices,
                  no_download=True, device="cpu")
    want = [r.audio for r in larynx_tpu_torch.text_to_speech(TEXT, **kwargs)]
    _no_fallback(monkeypatch)
    scheduler = BatchScheduler(max_batch=8, max_wait_ms=50.0) if scheduled else None
    trace.reset()
    trace.enable(True)
    try:
        got = [r.audio for r in larynx_tpu_torch.text_to_speech(TEXT, scheduler=scheduler,
                                                                **kwargs)]
        spans = trace.snapshot()["buffer"]
    finally:
        trace.enable(False)
        trace.reset()
        if scheduler is not None:
            scheduler.shutdown()
    assert len(got) == 2 and all(len(a) == 40 * 256 for a in got)  # the gate never fires
    for g, w in zip(got, want):
        assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= LSB
    names = {s["name"] for s in spans}
    assert {"engine.encode", "engine.decode", "engine.ar_stop_check", "engine.vocode"} <= names
    decodes = [s for s in spans if s["name"] == "engine.decode"]
    assert all(s["attrs"]["family"] == "tacotron2" for s in decodes)
    assert sum(s["attrs"]["rows"] for s in decodes) >= 2
    assert ("scheduler.group" in names) == scheduled


def test_the_stream_keeps_the_fallback(voices):
    """One peak-normalised chunk per sentence, as the JAX package streams
    this voice: the fallback's audio at its default seed, which is the
    engine's for a row of a call without seeds."""
    (chunk,) = larynx_tpu_torch.stream_text_to_speech(
        "Hello world.", voice_or_lang=VOICE, vocoder_or_quality=VOCODER, custom_voices_dir=voices,
        no_download=True, device="cpu")
    (audio,) = [r.audio for r in larynx_tpu_torch.text_to_speech(
        "Hello world.", voice_or_lang=VOICE, vocoder_or_quality=VOCODER, custom_voices_dir=voices,
        no_download=True, device="cpu")]
    assert chunk.shape == audio.shape == (40 * 256,)
    assert np.abs(chunk.astype(np.int32) - audio.astype(np.int32)).max() <= LSB


@pytest.mark.parametrize("scheduled", [False, True], ids=["text_to_speech", "scheduler"])
def test_max_decoder_steps_reaches_the_engine(voices, scheduled):
    """``tts_settings["max_decoder_steps"]`` caps each sentence, as it caps
    the fallback's ``phonemes_to_mels``, with the scheduler or without."""
    scheduler = BatchScheduler(max_batch=8, max_wait_ms=50.0) if scheduled else None
    try:
        got = [r.audio for r in larynx_tpu_torch.text_to_speech(
            TEXT, voice_or_lang=VOICE, vocoder_or_quality=VOCODER, custom_voices_dir=voices,
            no_download=True, device="cpu", tts_settings={"max_decoder_steps": 24},
            scheduler=scheduler)]
    finally:
        if scheduler is not None:
            scheduler.shutdown()
    assert [len(a) for a in got] == [24 * 256, 24 * 256]
