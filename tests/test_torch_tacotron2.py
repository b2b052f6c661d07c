"""The port's Tacotron2 (``larynx_tpu_torch.models.tacotron2``,
``larynx_tpu_torch.tacotron2``) against ``larynx_tpu``'s, on CPU.

The same numpy params (the JAX ``init_params`` at the small geometry of
``tests/test_tacotron2.py``) and ids go through both packages: the LSTM
cell, the masked BiLSTM, ``encode``, ``postnet``, the whole ``infer`` with
the prenet dropout off and on (the JAX side draws its masks from
``fold_in`` keys; the port is given the same masks through
``keep_masks``), the stop lengths, and a voice dir through
``text_to_speech``, the stream, the scheduler, the CLI and ``/api/tts``.

Tolerances:
  * cell, BiLSTM, encoder, postnet: 1e-5 absolute on O(1) values.  Both
    sides sum the same float32 products in other orders (~1e-7 relative per
    product); 1e-5 leaves two orders of magnitude and catches any gate
    order, mask or padding fault, which is O(0.1).
  * ``infer`` over 40 autoregressive steps: 1e-4 absolute.  Each step feeds
    the last mel frame back through the prenet, so the per-step rounding of
    ~1e-7 can grow; measured: 2.4e-7 on mels of O(0.4), dropout on or off.
  * a padded row against the same row alone: 1e-5, the encoder bound (the
    padding changes only the summation extents of masked products).
  * stop lengths: equal.
  * int16 audio: 2 LSB per sample at the same length (see
    ``tests/test_torch_pipeline.py``: both sides peak-normalise float32
    audio and truncate it).
"""

import asyncio
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

import larynx_tpu
import larynx_tpu.__main__ as jcli
from larynx_tpu.convert.native import save_params
from larynx_tpu.models.hifi_gan import hifi_gan_config_from_json
from larynx_tpu.models.hifi_gan import init_params as j_hifi_init
from larynx_tpu.models.tacotron2 import Tacotron2Config as JConfig
from larynx_tpu.models.tacotron2 import init_params as j_init
from larynx_tpu.models.tacotron2 import model as jm
from larynx_tpu.server.app import ServerSettings as JServerSettings
from larynx_tpu.server.app import create_app as j_create_app

import larynx_tpu_torch
import larynx_tpu_torch.__main__ as cli
from larynx_tpu_torch.io import wavfile
from larynx_tpu_torch.models.tacotron2 import Tacotron2Config
from larynx_tpu_torch.models.tacotron2 import model as tm
from larynx_tpu_torch.runtime.scheduler import BatchScheduler
from larynx_tpu_torch.server.app import ServerSettings, create_app
from larynx_tpu_torch.weights import init_params, params_from_jax

from test_torch_pipeline import PHONEME_TABLE

TOL = 1e-5
INFER_TOL = 1e-4
LSB = 2

# tests/test_tacotron2.py's geometry
SMALL = dict(
    num_symbols=40, symbols_embedding_dim=32, encoder_embedding_dim=32, encoder_kernel_size=5,
    encoder_n_convolutions=2, prenet_dim=16, attention_rnn_dim=48, decoder_rnn_dim=48,
    attention_dim=24, attention_location_n_filters=8, attention_location_kernel_size=15,
    postnet_embedding_dim=32, postnet_kernel_size=5, postnet_n_convolutions=3, mel_channels=12,
    max_decoder_steps=40, p_prenet_dropout=0.0,
)
J_CFG = JConfig(**SMALL)
CFG = Tacotron2Config(**SMALL)
IDS = np.array([[3, 9, 1, 22, 17, 5, 30, 2], [4, 8, 2, 1, 7, 0, 0, 0]], dtype=np.int32)
LENGTHS = np.array([8, 5], dtype=np.int32)


def _numpy_tree(tree):
    return jax.tree.map(np.array, tree)


@pytest.fixture(scope="module")
def params():
    """(JAX tree as writable numpy, the port's tree)."""
    tree = _numpy_tree(j_init(jax.random.PRNGKey(0), J_CFG))
    return tree, params_from_jax(tree, "tacotron2")


def _with_gate_bias(tree, bias):
    tree = _numpy_tree(tree)
    tree["decoder"]["gate"]["b"][:] = bias
    return tree, params_from_jax(tree, "tacotron2")


def _rng_tensor(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _jax_infer(tree, cfg, ids, lengths, steps, key=None):
    mel, out_lengths = jm.infer(tree, cfg, jnp.asarray(ids), jnp.asarray(lengths), max_steps=steps,
                                key=key)
    return np.asarray(mel), np.asarray(out_lengths)


def _port_infer(tree, cfg, ids, lengths, steps, keep_masks=None):
    mel, out_lengths = tm.infer(tree, cfg, torch.from_numpy(ids).long(),
                                torch.from_numpy(lengths), max_steps=steps, keep_masks=keep_masks)
    return mel.numpy(), out_lengths.numpy()


def _jax_keep_masks(key, cfg, steps, bsz):
    """The masks the JAX decode draws: step i, layer l from
    ``bernoulli(fold_in(fold_in(key, i), l), 1 - p, [B, prenet_dim])``."""
    return torch.from_numpy(np.stack([np.stack([
        np.asarray(jax.random.bernoulli(jax.random.fold_in(jax.random.fold_in(key, i), layer),
                                        1.0 - cfg.p_prenet_dropout, (bsz, cfg.prenet_dim)))
        for layer in range(2)]) for i in range(steps)]))


def test_lstm_cell_matches_jax():
    rng = np.random.default_rng(0)
    p = {"w_ih": _rng_tensor(rng, 10, 56, scale=0.3), "w_hh": _rng_tensor(rng, 14, 56, scale=0.3),
         "b": _rng_tensor(rng, 56, scale=0.3)}
    x, h, c = _rng_tensor(rng, 3, 10), _rng_tensor(rng, 3, 14), _rng_tensor(rng, 3, 14)
    jh, jc = jm.lstm_cell(p, jnp.asarray(x), jnp.asarray(h), jnp.asarray(c))
    tp = {k: torch.from_numpy(np.ascontiguousarray(v.T)) for k, v in p.items()}
    th, tc = tm.lstm_cell(tp, torch.from_numpy(x), torch.from_numpy(h), torch.from_numpy(c))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=TOL, rtol=0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=TOL, rtol=0)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_masked_bilstm_direction_matches_jax(reverse):
    """Padded steps carry h and c unchanged: the reverse direction starts at
    each row's last valid frame."""
    rng = np.random.default_rng(1)
    p = {"w_ih": _rng_tensor(rng, 8, 24, scale=0.4), "w_hh": _rng_tensor(rng, 6, 24, scale=0.4),
         "b": _rng_tensor(rng, 24, scale=0.4)}
    x = _rng_tensor(rng, 2, 11, 8)
    mask = (np.arange(11)[None, :] < np.array([11, 6])[:, None]).astype(np.float32)
    want = np.asarray(jm._lstm_scan(p, jnp.asarray(x), reverse=reverse, mask=jnp.asarray(mask)))
    tp = {k: torch.from_numpy(np.ascontiguousarray(v.T)) for k, v in p.items()}
    got = tm._lstm_scan(tp, torch.from_numpy(x), reverse=reverse, mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    # a padded row's valid frames equal the row run alone
    alone = tm._lstm_scan(tp, torch.from_numpy(x[1:, :6]), reverse=reverse)
    np.testing.assert_allclose(got.numpy()[1, :6], alone.numpy()[0], atol=TOL, rtol=0)


def test_encode_matches_jax(params):
    tree, port = params
    memory, mask = jm.encode(tree, J_CFG, jnp.asarray(IDS), jnp.asarray(LENGTHS))
    t_memory, t_mask = tm.encode(port, CFG, torch.from_numpy(IDS).long(),
                                 torch.from_numpy(LENGTHS))
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(mask))
    np.testing.assert_allclose(t_memory.numpy(), np.asarray(memory), atol=TOL, rtol=0)


def test_postnet_matches_jax(params):
    tree, port = params
    rng = np.random.default_rng(2)
    mels = _rng_tensor(rng, 2, 30, CFG.mel_channels)
    want = np.asarray(jm.postnet(tree, J_CFG, jnp.asarray(mels)))
    got = tm.postnet(port, CFG, torch.from_numpy(mels)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("dropout", [False, True], ids=["dropout-off", "dropout-on"])
def test_infer_matches_jax(params, dropout):
    """40 decoder steps with the gate held off (bias -50), so every frame is
    kept; with dropout at p = 0.5 the port runs on the JAX decode's masks."""
    tree, port = _with_gate_bias(params[0], -50.0)
    j_cfg, cfg, key, keep = J_CFG, CFG, None, None
    if dropout:
        j_cfg = dataclasses.replace(J_CFG, p_prenet_dropout=0.5)
        cfg = dataclasses.replace(CFG, p_prenet_dropout=0.5)
        key = jax.random.PRNGKey(5)
        keep = _jax_keep_masks(key, j_cfg, 40, len(IDS))
    want, want_lengths = _jax_infer(tree, j_cfg, IDS, LENGTHS, 40, key)
    got, got_lengths = _port_infer(port, cfg, IDS, LENGTHS, 40, keep)
    assert got.shape == want.shape == (2, 40, CFG.mel_channels)
    np.testing.assert_array_equal(got_lengths, want_lengths)
    assert list(got_lengths) == [40, 40]
    np.testing.assert_allclose(got, want, atol=INFER_TOL, rtol=0)
    if dropout:  # the masks matter: the same decode without them differs
        assert np.abs(_port_infer(port, cfg, IDS, LENGTHS, 40)[0] - got).max() > 1e-2


def test_padded_batch_row_matches_row_alone(params):
    tree, port = _with_gate_bias(params[0], -50.0)
    batch, _ = _port_infer(port, CFG, IDS, LENGTHS, 12)
    alone, _ = _port_infer(port, CFG, IDS[1:, :5], LENGTHS[1:], 12)
    np.testing.assert_allclose(batch[1], alone[0], atol=TOL, rtol=0)


@pytest.mark.parametrize("bias,length", [(50.0, 1), (-50.0, 10)], ids=["stop-at-once", "never"])
def test_gate_bias_sets_lengths(params, bias, length):
    """+50: every row stops at its first frame; -50: no row stops, and each
    has max_steps frames."""
    tree, port = _with_gate_bias(params[0], bias)
    want, want_lengths = _jax_infer(tree, J_CFG, IDS, LENGTHS, 10)
    got, got_lengths = _port_infer(port, CFG, IDS, LENGTHS, 10)
    assert list(got_lengths) == list(want_lengths) == [length, length]
    assert got.shape == want.shape == (2, 10, CFG.mel_channels)


def test_rows_stop_at_different_steps(params):
    """A gate bias at which the two rows stop at different steps: the same
    lengths as JAX, and the kept frames (up to the longer row's stop) equal
    to JAX's, the last 10 before the crop included: the postnet's five k=5
    convs reach 10 frames past them, into frames after the stop."""
    steps = 40
    tree, port = params
    memory, mask = jm.encode(tree, J_CFG, jnp.asarray(IDS), jnp.asarray(LENGTHS))
    _, gates, _ = jm.decode_inference(tree, J_CFG, memory, mask, steps)
    gates = np.asarray(gates)  # the gate never feeds back: a bias only shifts it
    values = np.unique(gates)
    bias = None
    # thresholds midway between two gate values at least 2e-5 apart, so
    # that rounding (~1e-7) cannot move a crossing
    for lo, hi in zip(values[:-1], values[1:]):
        if hi - lo < 2e-5:
            continue
        candidate = -0.5 * (lo + hi)
        first = [int(np.argmax(g + candidate > 0)) + 1 if np.any(g + candidate > 0) else steps
                 for g in gates]
        if first[0] != first[1] and 12 <= max(first) <= steps - 10:
            bias = float(tree["decoder"]["gate"]["b"][0]) + float(candidate)
            break
    assert bias is not None, "no bias gives two stop steps"
    tree, port = _with_gate_bias(tree, bias)
    want, want_lengths = _jax_infer(tree, J_CFG, IDS, LENGTHS, steps)
    got, got_lengths = _port_infer(port, CFG, IDS, LENGTHS, steps)
    np.testing.assert_array_equal(got_lengths, want_lengths)
    assert want_lengths[0] != want_lengths[1]
    n = int(want_lengths.max())
    np.testing.assert_allclose(got[:, n - 10 : n], want[:, n - 10 : n], atol=INFER_TOL, rtol=0)
    np.testing.assert_allclose(got[:, :n], want[:, :n], atol=INFER_TOL, rtol=0)


def test_init_params_shapes_match_jax():
    want = j_init(jax.random.PRNGKey(0), J_CFG)
    got = init_params(torch.Generator().manual_seed(0), CFG)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got)[0], jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == np.float32, jax.tree_util.keystr(path)
    # the distributions' ranges, as the JAX init draws them
    lstm = got["decoder"]["attention_rnn"]["w_ih"]
    assert 0.9 / np.sqrt(48) < np.abs(lstm).max() <= 1.0 / np.sqrt(48)
    assert np.all(got["encoder"]["convs"][0]["bn"]["var"] == 1.0)


def test_keep_masks_follow_the_seed():
    a = tm.draw_keep_masks(dataclasses.replace(CFG, p_prenet_dropout=0.5), 7, 2, 3)
    b = tm.draw_keep_masks(dataclasses.replace(CFG, p_prenet_dropout=0.5), 7, 2, 3)
    c = tm.draw_keep_masks(dataclasses.replace(CFG, p_prenet_dropout=0.5), 7, 2, 4)
    assert a.shape == (7, 2, 2, CFG.prenet_dim) and a.dtype == torch.bool
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert 0.3 < a.float().mean() < 0.7


# -----------------------------------------------------------------------------
# A voice dir through both packages' entry points

VOICE = "en-us_torch_t2_parity-tacotron2"
VOICE_CONFIG = {
    "audio": {
        "filter_length": 1024, "hop_length": 256, "win_length": 1024, "mel_channels": 12,
        "sample_rate": 22050, "mel_fmin": 0.0, "mel_fmax": 8000.0, "signal_norm": False,
        "do_dynamic_range_compression": False, "convert_db_to_amp": False,
    },
    "model": dict(SMALL, num_symbols=len(PHONEME_TABLE), max_decoder_steps=60),
}
VOCODER_CONFIG = {  # tests/test_tacotron2.py's LOW HiFi-GAN
    "audio": {"num_mels": 12, "sampling_rate": 22050},
    "model": {
        "resblock": "2", "upsample_rates": [8, 8, 2, 2], "upsample_kernel_sizes": [16, 16, 4, 4],
        "upsample_initial_channel": 16, "resblock_kernel_sizes": [3, 5],
        "resblock_dilation_sizes": [[1, 2], [2, 6]],
    },
}
TEXT = "Hello world. A second sentence."


def _clear_caches():
    for module in (larynx_tpu, larynx_tpu_torch):
        module._TTS_MODEL_CACHE.clear()
        module._VOCODER_MODEL_CACHE.clear()
        module._ENGINE_CACHE.clear()


def stage_tacotron2_voice(root, gate_bias=-50.0):
    """A Tacotron2 voice with its own phonemes.txt (prenet dropout p = 0)
    and ``hifi_gan/vctk_small`` under ``root``.  The gate bias -50 keeps
    every sentence to the decode's full 60 steps (a random gate would stop
    at an arbitrary frame)."""
    lang, rest = VOICE.split("_", 1)
    voice_dir = root / lang / rest
    voice_dir.mkdir(parents=True)
    (voice_dir / "config.json").write_text(json.dumps(VOICE_CONFIG), encoding="utf-8")
    (voice_dir / "phonemes.txt").write_text(
        "".join(f"{i} {p}\n" for i, p in enumerate(PHONEME_TABLE)), encoding="utf-8")
    tree = _numpy_tree(j_init(jax.random.PRNGKey(3), JConfig(**VOICE_CONFIG["model"])))
    tree["decoder"]["gate"]["b"][:] = gate_bias
    save_params(voice_dir / "generator.npz", tree)
    voc_dir = root / "hifi_gan" / "vctk_small"
    voc_dir.mkdir(parents=True)
    (voc_dir / "config.json").write_text(json.dumps(VOCODER_CONFIG), encoding="utf-8")
    save_params(voc_dir / "generator.npz",
                j_hifi_init(jax.random.PRNGKey(1), hifi_gan_config_from_json(VOCODER_CONFIG)))
    return voice_dir, tree


@pytest.fixture(scope="module")
def voices(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_t2_voices")
    stage_tacotron2_voice(root)
    _clear_caches()
    yield root
    _clear_caches()


def _kwargs(voices):
    return dict(voice_or_lang=VOICE, vocoder_or_quality="low", custom_voices_dir=voices,
                no_download=True)


def _lsb(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


@pytest.fixture(scope="module")
def jax_results(voices):
    return list(larynx_tpu.text_to_speech(TEXT, **_kwargs(voices)))


def test_load_tts_model_loads_tacotron2(voices):
    model = larynx_tpu_torch.load_tts_model("tacotron2", voices / "en-us" / "torch_t2_parity-tacotron2")
    assert type(model).__name__ == "Tacotron2TextToSpeech"
    assert model.model_config.max_decoder_steps == 60


def test_text_to_speech_matches_jax(voices, jax_results):
    got = list(larynx_tpu_torch.text_to_speech(TEXT, device="cpu", **_kwargs(voices)))
    assert len(got) == len(jax_results) == 2
    for g, w in zip(got, jax_results):
        assert g.text == w.text and g.sample_rate == w.sample_rate == 22050
        # no gate fires: 60 frames of 256 samples
        assert g.audio.shape == (60 * 256,) and np.abs(w.audio.astype(np.int32)).max() > 1000
        assert _lsb(g.audio, w.audio) <= LSB


def test_stream_matches_jax(voices):
    """One chunk per sentence through the unfused fallback, as in JAX."""
    got = list(larynx_tpu_torch.stream_text_to_speech(TEXT, device="cpu", **_kwargs(voices)))
    kwargs = _kwargs(voices)
    del kwargs["no_download"]  # the JAX stream has no such argument
    want = list(larynx_tpu.stream_text_to_speech(TEXT, **kwargs))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert _lsb(g, w) <= LSB


def test_scheduler_matches_jax(voices, jax_results):
    scheduler = BatchScheduler(max_batch=8, max_wait_ms=10.0)
    try:
        got = list(larynx_tpu_torch.text_to_speech(TEXT, device="cpu", scheduler=scheduler,
                                                   **_kwargs(voices)))
    finally:
        scheduler.shutdown()
    assert len(got) == 2
    for g, w in zip(got, jax_results):
        assert _lsb(g.audio, w.audio) <= LSB


def test_cli_matches_jax_cli(voices, capsysbinary):
    argv = [TEXT, "--voice", VOICE, "--quality", "low", "--voices-dir", str(voices),
            "--denoiser-strength", "0"]
    cli.main(argv + ["--device", "cpu"])
    got = wavfile.read(io.BytesIO(capsysbinary.readouterr().out))
    jcli.main(argv)
    want = wavfile.read(io.BytesIO(capsysbinary.readouterr().out))
    assert got[0] == want[0] == 22050
    assert got[1].size > 20000 and _lsb(got[1], want[1]) <= LSB


def test_api_tts_matches_jax_server(voices):
    apps = [lambda: create_app(ServerSettings(voices_dir=str(voices), quality="low", device="cpu")),
            lambda: j_create_app(JServerSettings(voices_dir=str(voices), quality="low"))]

    async def fetch(make_app):
        client = TestClient(TestServer(make_app()))
        await client.start_server()
        try:
            resp = await client.get("/api/tts", params={"voice": VOICE.replace("_", "/", 1),
                                                        "text": TEXT})
            assert resp.status == 200 and resp.content_type == "audio/wav"
            return await resp.read()
        finally:
            await client.close()

    loop = asyncio.new_event_loop()
    try:
        got, want = (wavfile.read(io.BytesIO(loop.run_until_complete(fetch(a))))[1] for a in apps)
    finally:
        loop.close()
    assert got.size > 20000 and _lsb(got, want) <= LSB
