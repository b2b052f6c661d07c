"""The port's serving mesh against its single-device engine and the JAX mesh.

The port's ``SynthesisEngine(mesh=ServingMesh(["cpu"] * 4))`` runs each of
four positions' rows on the CPU, the same code path that a mesh of cards
runs.  It is held against the port's single-device engine with the same
seeded noise (the mesh draws the noise once, as the single-device engine
does, so the mel is the same), and against the JAX engine on
``Mesh(jax.devices()[:4], ("data",))`` at ``noise_scale`` 0 (torch cannot
draw JAX's noise), within the JAX package's own bound
(``tests/test_mesh_serving.py``): <= 2 LSB on < 2% of samples.  The mesh's
vocode runs uniform row groups at the bucket's width where the
single-device engine runs length-sorted groups at their own widths, so
float32 sums in another order move a sample by an int16 step.  The stream
runs on the first position alone and gives the single-device stream's
bytes.  ``make_sharded_synthesis`` is held against JAX's at ``noise_scale``
0 on its float audio, within 1e-4 of the audio's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from larynx_tpu.audio import AudioSettings as JAudioSettings
from larynx_tpu.models.glow_tts import GlowTTSConfig as JGlowConfig
from larynx_tpu.models.glow_tts.model import init_params as j_glow_init
from larynx_tpu.models.hifi_gan import HiFiGanConfig as JHiFiConfig
from larynx_tpu.models.hifi_gan.model import init_params as j_hifi_init
from larynx_tpu.models.waveglow import WaveGlowConfig as JWaveGlowConfig
from larynx_tpu.models.waveglow import model as j_wg
from larynx_tpu.parallel.serve import make_sharded_synthesis as j_make_sharded_synthesis
from larynx_tpu.runtime.engine import SynthesisEngine as JEngine

import larynx_tpu_torch
from larynx_tpu_torch.audio import AudioSettings
from larynx_tpu_torch.models.glow_tts import GlowTTSConfig
from larynx_tpu_torch.models.hifi_gan import HiFiGanConfig
from larynx_tpu_torch.models.waveglow import WaveGlowConfig
from larynx_tpu_torch.parallel import mesh as tmesh
from larynx_tpu_torch.parallel.mesh import ServingMesh, serving_mesh
from larynx_tpu_torch.parallel.serve import make_sharded_synthesis
from larynx_tpu_torch.runtime import engine as tengine
from larynx_tpu_torch.runtime.engine import SynthesisEngine
from larynx_tpu_torch.weights import params_from_jax

from test_torch_run_jobs import _clear_caches, _tts, voices_dir  # noqa: F401

N = 4
LSB, SHARE = 2, 0.02
GLOW = dict(hidden_channels=64, filter_channels=128, filter_channels_dp=64, n_layers_enc=2,
            n_blocks_dec=2, n_block_layers=2)
HIFI = dict(resblock="2", upsample_initial_channel=32, upsample_rates=(8, 8, 2, 2),
            upsample_kernel_sizes=(16, 16, 4, 4), resblock_kernel_sizes=(3, 5),
            resblock_dilation_sizes=((1, 2), (2, 6)))
WAVEGLOW = dict(mel_channels=80, flows=2, groups=8, early_every=4, early_size=2,
                wn_kernel_size=3, wn_channels=16, wn_layers=2, upsample_kernel=512,
                upsample_stride=256)
SETTINGS = dict(signal_norm=True, max_norm=1.0, symmetric_norm=True, clip_norm=True)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    key = jax.random.PRNGKey(0)
    glow = _np(j_glow_init(key, JGlowConfig(**GLOW)))
    cp = glow["decoder"]["coupling"]  # the zero-init coupling output, given signal
    cp["end_w"] = (np.random.default_rng(0).standard_normal(cp["end_w"].shape)
                   * 0.05).astype(np.float32)
    return glow, _np(j_hifi_init(jax.random.fold_in(key, 1), JHiFiConfig(**HIFI)))


def _engine(models, mesh=None, kind="hifi_gan", **kw):
    glow, hifi = models
    extra = {}
    if kind == "hifi_gan":
        extra = dict(vocoder_params=params_from_jax(hifi, "hifi_gan"),
                     vocoder_cfg=HiFiGanConfig(**HIFI))
    elif kind == "waveglow":
        extra = dict(vocoder_params=params_from_jax(_np(j_wg.init_params(
            jax.random.PRNGKey(2), JWaveGlowConfig(**WAVEGLOW))), "waveglow"),
            vocoder_cfg=WaveGlowConfig(**WAVEGLOW))
    return SynthesisEngine(params_from_jax(glow, "glow_tts"), GlowTTSConfig(**GLOW),
                           AudioSettings(**SETTINGS), vocoder_kind=kind, seed=7, device="cpu",
                           mesh=mesh, **extra, **kw)


def _cpu_mesh():
    return ServingMesh(["cpu"] * N)


def _ids(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 40, size=int(n)).astype(np.int64) for n in lengths]


def _close(got, want, lsb=LSB, share=SHARE):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int16 and a.shape == b.shape, (a.shape, b.shape)
        diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert diff.max() <= lsb, diff.max()
        assert np.mean(diff != 0) < share, np.mean(diff != 0)


def test_serving_mesh_discovery(monkeypatch):
    """None on the CPU whatever the flag; on N cards the largest power of
    two of them, distinct; None below two cards or with the flag off."""
    for flag in ("auto", "on", "off"):
        monkeypatch.setenv("LARYNX_TPU_MESH", flag)
        assert serving_mesh() is None  # no CUDA here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for count, want in ((8, 8), (6, 4), (3, 2), (2, 2), (1, None), (0, None)):
        monkeypatch.setattr(torch.cuda, "device_count", lambda c=count: c)
        monkeypatch.setenv("LARYNX_TPU_MESH", "auto")
        mesh = serving_mesh()
        if want is None:
            assert mesh is None
            continue
        assert mesh.shape == {"data": want}
        assert mesh.positions == tuple(torch.device("cuda", i) for i in range(want))
        monkeypatch.setenv("LARYNX_TPU_MESH", "off")
        assert serving_mesh() is None


def test_serving_mesh_positions():
    mesh = ServingMesh(["cpu"] * N)
    assert len(mesh) == N and mesh.shape == {"data": N}
    assert mesh.devices == (torch.device("cpu"),)
    assert ServingMesh(["cuda"] * 2).positions == (torch.device("cuda", 0),) * 2
    assert mesh == ServingMesh([torch.device("cpu")] * N) and mesh != ServingMesh(["cpu"] * 2)
    with pytest.raises(ValueError):
        ServingMesh([])


def test_mesh_engine_matches_single_device(models):
    """Five sentences, seeded noise, denoised: the mesh pads the batch to 8
    rows, two a position, and gives the single-device engine's audio."""
    ids = _ids(0, (12, 9, 15, 7, 11))
    want = _engine(models).synthesize_batch(ids, seed=5, denoiser_strength=0.004)
    eng = _engine(models, _cpu_mesh())
    enc, _g = eng.encode_launch(ids)
    assert enc[0].shape[0] == 8 and len(enc[0].shards) == N
    got = eng.synthesize_batch(ids, seed=5, denoiser_strength=0.004)
    _close(got, want)


def test_mesh_engine_matches_jax_mesh(models):
    """The port's mesh against the JAX engine on a 4-device mesh, noise 0."""
    glow, hifi = models
    jeng = JEngine(glow, JGlowConfig(**GLOW), JAudioSettings(**SETTINGS), vocoder_kind="hifi_gan",
                   vocoder_params=hifi, vocoder_cfg=JHiFiConfig(**HIFI), seed=7,
                   mesh=Mesh(np.asarray(jax.devices()[:N]), ("data",)))
    ids = _ids(1, (12, 9, 15, 7, 11))
    want = jeng.synthesize_batch(ids, noise_scale=0.0)
    got = _engine(models, _cpu_mesh()).synthesize_batch(ids, noise_scale=0.0)
    _close(got, want)


def test_mesh_vocode_grouping_clamps_final_window(models, monkeypatch):
    """Under an area cap whose group does not divide the padded batch, the
    final group clamps to the batch's end; every group splits into N equal
    slices, one a position, and slices of padding alone are not vocoded."""
    eng, single = _engine(models, _cpu_mesh()), _engine(models)
    ids = _ids(3, np.random.default_rng(3).integers(6, 14, size=13))
    n = len(ids)
    enc, g = eng.encode_launch(ids, 2.0)
    y = enc.lengths.numpy()
    b = enc[0].shape[0]
    m = eng.policy.mel_bucket(int(y[:n].max()))
    # per-device cap 3m: groups of 12 rows of 16 -> [0, 12), then [4, 16) clamped
    monkeypatch.setattr(tengine, "MAX_VOCODE_AREA", 3 * m)
    assert b == 16
    parts, b_rows = eng.synthesize_launch(enc, y, g, n, seed=5)
    assert [idxs[0] for _p, idxs in parts] == [0, 3, 6, 9, 4, 7, 10]
    assert all(len(idxs) == 3 for _p, idxs in parts)
    rows = eng.crop_rows(eng.vocode_collect(parts, b_rows), y, n, 0.0)
    _close(rows, single.synthesize_batch(ids, seed=5, length_scale=2.0))


def test_mesh_engine_streaming(models):
    """The stream on a mesh runs on its first position: the single-device
    stream's bytes, chunk for chunk."""
    ids = np.arange(1, 30, dtype=np.int64)
    got = list(_engine(models, _cpu_mesh()).synthesize_stream(ids, seed=5, chunk_frames=16))
    want = list(_engine(models).synthesize_stream(ids, seed=5, chunk_frames=16))
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_mesh_engine_griffin_lim(models):
    """Griffin-Lim's rows on their positions, from the single-device
    engine's initial phase."""
    ids = _ids(4, (10, 14, 8))
    want = _engine(models, kind="griffin_lim", griffin_lim_iters=4).synthesize_batch(ids, seed=3)
    got = _engine(models, _cpu_mesh(), kind="griffin_lim",
                  griffin_lim_iters=4).synthesize_batch(ids, seed=3)
    _close(got, want)
    assert got[0].size > 1000


def test_mesh_engine_waveglow(models):
    """WaveGlow on the mesh: the prior drawn once at the single-device
    engine's rows, uniform groups over the positions."""
    ids = _ids(0, (12, 9, 15, 7, 11))
    want = _engine(models, kind="waveglow").synthesize_batch(ids, seed=5)
    got = _engine(models, _cpu_mesh(), kind="waveglow").synthesize_batch(ids, seed=5)
    _close(got, want)


def test_mesh_phonemes_to_mels_on_first_position(models):
    ids = np.arange(1, 20, dtype=np.int64)
    np.testing.assert_array_equal(
        _engine(models, _cpu_mesh()).phonemes_to_mels(ids, seed=2),
        _engine(models).phonemes_to_mels(ids, seed=2))


def test_pooling_off_on_a_mesh(voices_dir, monkeypatch):  # noqa: F811
    """_run_jobs pools the units that share a vocoder, except on a mesh
    (``larynx_tpu/__init__.py:427-434``): each unit vocodes alone."""
    calls = []
    real_launch = SynthesisEngine.vocode_launch

    def counting_launch(self, *args, **kw):
        calls.append((self.mesh is not None, args[2]))
        return real_launch(self, *args, **kw)

    monkeypatch.setattr(SynthesisEngine, "vocode_launch", counting_launch)
    _clear_caches()
    base = _tts(larynx_tpu_torch, voices_dir)
    assert calls == [(False, 4)]
    calls.clear()
    monkeypatch.setattr(larynx_tpu_torch, "_engine_mesh", lambda device: _cpu_mesh())
    _clear_caches()
    meshed = _tts(larynx_tpu_torch, voices_dir)
    _clear_caches()
    assert len(calls) >= 3 and all(on_mesh for on_mesh, _n in calls)
    assert sum(n for _m, n in calls) == 4
    _close([r.audio for r in meshed], [r.audio for r in base])


def test_make_sharded_synthesis_matches_jax(models):
    glow, hifi = models
    mesh = Mesh(np.asarray(jax.devices()[:N]), ("data",))
    rng = np.random.default_rng(6)
    ids = rng.integers(1, 40, size=(N, 16)).astype(np.int32)
    lengths = np.array([16, 12, 9, 14], np.int32)
    for audio_settings in (None, SETTINGS):
        jfn = j_make_sharded_synthesis(
            JGlowConfig(**GLOW), JHiFiConfig(**HIFI), mesh, 64,
            None if audio_settings is None else JAudioSettings(**audio_settings))
        want, want_y = jfn(glow, hifi, jnp.asarray(ids), jnp.asarray(lengths),
                           jax.random.PRNGKey(0), noise_scale=0.0)
        fn = make_sharded_synthesis(
            GlowTTSConfig(**GLOW), HiFiGanConfig(**HIFI), _cpu_mesh(), 64,
            None if audio_settings is None else AudioSettings(**audio_settings))
        got, got_y = fn(params_from_jax(glow, "glow_tts"), params_from_jax(hifi, "hifi_gan"),
                        ids, lengths, seed=0, noise_scale=0.0)
        np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))
        want = np.asarray(want)
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    # the mel alone, without a vocoder
    mel, _ = make_sharded_synthesis(GlowTTSConfig(**GLOW), None, _cpu_mesh(), 64)(
        params_from_jax(glow, "glow_tts"), None, ids, lengths, seed=0, noise_scale=0.0)
    assert mel.shape == (N, 64, 80)


def test_sharded_synthesis_rows_must_split(models):
    fn = make_sharded_synthesis(GlowTTSConfig(**GLOW), None, _cpu_mesh(), 64)
    with pytest.raises(ValueError, match="do not split"):
        fn(params_from_jax(models[0], "glow_tts"), None, np.ones((3, 8), np.int64),
           np.full((3,), 8), seed=0)


def test_engine_cache_keys_the_mesh(monkeypatch):
    """_get_engine asks for the serving mesh on the default CUDA device only."""
    asked = []
    monkeypatch.setattr(tmesh, "serving_mesh", lambda: asked.append(1) or None)
    assert larynx_tpu_torch._engine_mesh("cpu") is None
    assert larynx_tpu_torch._engine_mesh("cuda:1") is None and not asked
    assert larynx_tpu_torch._engine_mesh("cuda") is None and asked == [1]
    assert larynx_tpu_torch._engine_mesh(None) is None and asked == [1, 1]
