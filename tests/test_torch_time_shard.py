"""The port's time and grid shards against its single-device vocode and JAX's.

On ``ServingMesh(["cpu"] * 4)``.  Bounds, from ``tests/test_time_shard.py``:

* the plain time shard and the grid against the single-device batched
  vocode: <= 1 LSB on < 0.1% of samples (a window's float32 sums run in
  another order than the whole mel's);
* denoised: <= 2 LSB on < 2% (the gathered rows' STFT is over the padded
  width);
* the port against JAX's time shard: <= 2 LSB on < 2% (float32 in both,
  sums in other orders on each side);
* ``halo=0`` must differ: the halo carries the equality;
* ``_grid_vocode_plan`` and ``waveglow_halo_frames`` equal JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from larynx_tpu.audio import AudioSettings as JAudioSettings
from larynx_tpu.models.waveglow import WaveGlowConfig as JWaveGlowConfig
from larynx_tpu.models.waveglow import model as j_wg
from larynx_tpu.parallel import time_shard as jts
from larynx_tpu.runtime.engine import SynthesisEngine as JEngine

from larynx_tpu_torch.models.waveglow import WaveGlowConfig
from larynx_tpu_torch.models.waveglow import model as t_wg
from larynx_tpu_torch.parallel import time_shard as ts
from larynx_tpu_torch.runtime.engine import postprocess, stream_halo_frames, to_int16
from larynx_tpu_torch.weights import params_from_jax

from test_torch_mesh_serving import HIFI, N, SETTINGS, _close, _cpu_mesh, _engine, models  # noqa: F401

PLAIN = dict(lsb=1, share=1e-3)


def _random_mel(rows=1, m=256, lens=(219,), seed=42):
    rng = np.random.default_rng(seed)
    mel = rng.uniform(-1.0, 1.0, size=(rows, m, 80)).astype(np.float32)
    mask = (np.arange(m)[None, :] < np.asarray(lens)[:, None]).astype(np.float32)
    return torch.from_numpy(mel), torch.from_numpy(mask)


def _replicas(engine):
    return {dev: rep[1] for dev, rep in engine._replicas.items()}


def _single(engine, mel, mask, denoise=False, strength=0.0, z=None):
    bias = engine._get_bias_spec() if denoise else None
    s = torch.full((mel.shape[0], 1, 1), strength)
    return engine._vocode(mel, mask, bias, s, denoise, z).numpy()


def _time_shard(engine, halo):
    return ts.make_time_sharded_vocode(engine.vocoder_cfg, engine.audio_settings, _cpu_mesh(),
                                       halo)


@pytest.fixture(scope="module")
def single_vocode(models):
    """The single-device batched vocode of ``_random_mel()``, run once for
    the time-shard cases that compare against it."""
    return _single(_engine(models), *_random_mel())


@pytest.fixture(scope="module")
def single_row(models):
    """The single-device engine's audio of the one-sentence batch (seed 5,
    length scale 2), plain and denoised, run once per strength."""
    ids = [np.arange(1, 40, dtype=np.int64)]
    return {strength: _engine(models).synthesize_batch(ids, seed=5, length_scale=2.0,
                                                       denoiser_strength=strength)
            for strength in (0.0, 0.01)}


def test_time_sharded_vocode_matches_batched(models, single_vocode):
    eng = _engine(models)
    mel, mask = _random_mel()
    want = single_vocode
    got = _time_shard(eng, stream_halo_frames(eng.vocoder_cfg))(_replicas(eng), mel, mask)
    _close(list(got.numpy()), list(want), **PLAIN)


def test_time_sharded_vocode_needs_halo(models, single_vocode):
    eng = _engine(models)
    mel, mask = _random_mel()
    got = _time_shard(eng, 0)(_replicas(eng), mel, mask).numpy()
    assert got.shape == single_vocode.shape
    assert not np.array_equal(got, single_vocode)


def test_time_sharded_vocode_denoised(models):
    eng = _engine(models)
    mel, mask = _random_mel()
    want = _single(eng, mel, mask, denoise=True, strength=0.01)
    got = _time_shard(eng, stream_halo_frames(eng.vocoder_cfg))(
        _replicas(eng), mel, mask, bias_spec=eng._get_bias_spec(),
        strength=torch.full((1, 1, 1), 0.01), denoise=True)
    _close(list(got.numpy()), list(want))


def test_time_sharded_vocode_matches_jax(models):
    """The port's 1 x 4 time shard against JAX's on a 4-device mesh."""
    _glow, hifi = models
    eng = _engine(models)
    mel, mask = _random_mel(seed=7)
    from larynx_tpu.models.hifi_gan import HiFiGanConfig as JHiFiConfig

    jfn = jts.make_time_sharded_vocode(
        JHiFiConfig(**HIFI), JAudioSettings(**SETTINGS),
        Mesh(np.asarray(jax.devices()[:N]), ("data",)), halo=stream_halo_frames(eng.vocoder_cfg))
    want = np.asarray(jfn(hifi, jnp.asarray(mel.numpy()), jnp.asarray(mask.numpy())))
    got = _time_shard(eng, stream_halo_frames(eng.vocoder_cfg))(_replicas(eng), mel, mask)
    _close(list(got.numpy()), list(want))


def test_grid_sharded_vocode_matches_batched(models):
    """Three rows on the 2 x 2 grid, the last row shard half padding."""
    eng = _engine(models)
    mel, mask = _random_mel(rows=3, lens=(219, 256, 65), seed=7)
    want = _single(eng, mel, mask)
    fn = ts.make_grid_sharded_vocode(eng.vocoder_cfg, eng.audio_settings, _cpu_mesh().positions,
                                     2, 2, halo=stream_halo_frames(eng.vocoder_cfg))
    out = fn(_replicas(eng), mel, mask)
    assert [idxs for _p, idxs in out.parts] == [[0, 1], [2]]
    _close(list(out.numpy()), list(want), **PLAIN)


def test_grid_needs_as_many_devices(models):
    eng = _engine(models)
    with pytest.raises(ValueError, match="needs 4 devices"):
        ts.make_grid_sharded_vocode(eng.vocoder_cfg, eng.audio_settings, ["cpu"] * 3, 2, 2, 1)


def test_mesh_engine_single_row_time_shards(models, single_row):
    """A 1-sentence batch routes through the time shard (past the gate) and
    gives the single-device engine's audio, plain and denoised."""
    ids = [np.arange(1, 40, dtype=np.int64)]
    for strength in (0.0, 0.01):
        eng = _engine(models, _cpu_mesh())
        want = single_row[strength]
        got = eng.synthesize_batch(ids, seed=5, length_scale=2.0, denoiser_strength=strength)
        assert eng._time_shard_hits == 1
        _close(got, want)


def test_time_shard_length_gate(models, single_row, monkeypatch):
    """The gate is read at each call: above every bucket the row takes the
    group path, at 0 the time shard; the default is 2 x N x halo
    (``larynx_tpu/runtime/engine.py:537-548``)."""
    ids = [np.arange(1, 40, dtype=np.int64)]
    want = single_row[0.0]
    eng = _engine(models, _cpu_mesh())
    monkeypatch.setenv("LARYNX_TPU_TIME_SHARD_MIN_FRAMES", "1000000")
    assert eng._time_shard_min_frames == 1000000
    _close(eng.synthesize_batch(ids, seed=5, length_scale=2.0), want)
    assert eng._time_shard_hits == 0
    monkeypatch.setenv("LARYNX_TPU_TIME_SHARD_MIN_FRAMES", "0")
    _close(eng.synthesize_batch(ids, seed=5, length_scale=2.0), want)
    assert eng._time_shard_hits == 1
    monkeypatch.delenv("LARYNX_TPU_TIME_SHARD_MIN_FRAMES")
    assert eng._time_shard_min_frames == 2 * N * stream_halo_frames(eng.vocoder_cfg)


def test_mesh_engine_partial_batch_uses_grid(models):
    """Three valid rows of four positions take the rows x time grid."""
    ids = [np.arange(1, 40, dtype=np.int64), np.arange(3, 47, dtype=np.int64) % 45 + 1,
           np.arange(5, 31, dtype=np.int64)]
    eng = _engine(models, _cpu_mesh())
    want = _engine(models).synthesize_batch(ids, seed=5, length_scale=6.0)
    got = eng.synthesize_batch(ids, seed=5, length_scale=6.0)
    assert eng._grid_shard_hits == 1 and eng._time_shard_hits == 0
    _close(got, want)


class _PlanStub:
    """What JAX's ``_grid_vocode_plan`` reads of its engine."""

    def __init__(self, n, halo):
        self._n_data, self._ts_halo = n, halo


PLAN_CASES = [
    (n, n_valid, m, halo, area)
    for n in (2, 4, 8)
    for n_valid in (1, 2, 3, 5, 7)
    for m, halo in ((128, 36), (512, 36), (2048, 36), (512, 101), (4096, 101), (1024, 4))
    for area in (None, 4096)
    if n_valid < n
]


@pytest.mark.parametrize("n, n_valid, m, halo, area", PLAN_CASES[::3])
def test_grid_vocode_plan_equals_jax(models, n, n_valid, m, halo, area):
    eng = _engine(models)
    eng._n_data, eng._ts_halo = n, 36
    want = JEngine._grid_vocode_plan(_PlanStub(n, 36), n_valid, m, halo=halo, area=area)
    assert eng._grid_vocode_plan(n_valid, m, halo=halo, area=area) == want
    assert eng._grid_vocode_plan(n_valid, m) == JEngine._grid_vocode_plan(
        _PlanStub(n, 36), n_valid, m)


@pytest.mark.parametrize("kw", [{}, dict(flows=4, wn_layers=2, groups=8, upsample_kernel=128,
                                          upsample_stride=64), dict(wn_layers=4, wn_kernel_size=5)])
def test_waveglow_halo_frames_equals_jax(kw):
    assert ts.waveglow_halo_frames(WaveGlowConfig(**kw)) == jts.waveglow_halo_frames(
        JWaveGlowConfig(**kw))


def test_waveglow_grid_vocode_matches_batched(models):
    """Three rows on the 2 x 2 grid at JAX's test geometry (halo 4 frames),
    the prior sliced per window; the halo-0 control differs."""
    kw = dict(mel_channels=80, flows=4, groups=8, early_every=2, early_size=2, wn_kernel_size=3,
              wn_channels=32, wn_layers=2, upsample_kernel=128, upsample_stride=64)
    jparams = jax.tree.map(np.asarray, j_wg.init_params(jax.random.PRNGKey(3),
                                                        JWaveGlowConfig(**kw)))
    rng = np.random.default_rng(3)
    for flow in jparams["flows"]:
        flow["wn"]["end_w"] = (0.1 * rng.standard_normal(flow["wn"]["end_w"].shape)).astype(
            np.float32)
    cfg = WaveGlowConfig(**kw)
    eng = _engine(models, kind="waveglow")
    params = t_wg.pack_params(params_from_jax(jparams, "waveglow"), cfg)
    m = 128
    mel, mask = _random_mel(rows=3, m=m, lens=(100, 128, 57), seed=11)
    blocks = m * cfg.upsample_stride // cfg.groups
    lens = np.array([100, 128, 57])
    z = 0.9 * torch.randn((3, blocks, 8), generator=torch.Generator().manual_seed(5))
    z = torch.where(torch.from_numpy(np.arange(blocks)[None, :] < (
        lens * cfg.upsample_stride // cfg.groups)[:, None])[..., None], z, 0.0)

    audio = t_wg.infer(params, cfg, postprocess(mel, mask, eng.audio_settings).transpose(1, 2),
                       z=z).float()
    want = to_int16(audio, (mask > 0).sum(dim=1) * cfg.upsample_stride).numpy()
    halo = ts.waveglow_halo_frames(cfg)
    assert halo == 4
    grid = ts.make_waveglow_grid_vocode(cfg, eng.audio_settings, _cpu_mesh().positions, 2, 2,
                                        halo=halo)
    got = grid({torch.device("cpu"): params}, mel, mask, z).numpy()
    _close(list(got), list(want), **PLAIN)
    no_halo = ts.make_waveglow_grid_vocode(cfg, eng.audio_settings, _cpu_mesh().positions, 2, 2,
                                           halo=0)
    assert not np.array_equal(no_halo({torch.device("cpu"): params}, mel, mask, z).numpy(), want)
