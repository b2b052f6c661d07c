"""The port's GlowTTS training against ``larynx_tpu``'s, on the CPU.

Same numpy inputs and params (the JAX init under a fixed key, converted by
``params_from_jax``) through both packages, at ``tests/test_training.py``'s
SMALL_CFG.  Tolerances:

* MAS paths: equal, element for element.
* forward flow, alignment log-likelihood, losses: float32 sums in another
  order, ~1e-6 relative; held to 1e-5 of the output's scale.
* gradients of a whole training forward: per leaf within 1e-4 of the
  leaf's scale, the scale floored at 1e-4 of the largest gradient (a leaf
  whose true gradient is zero, as the attention's key bias, holds rounding
  noise only).
* optimizers: the same gradient sequences through both; after 5 updates
  within 1e-5 relative, 1e-6 of the learning rate absolute.
* mel targets: ``torch.fft`` against pocketfft, ~1e-4 relative on the
  magnitudes (ROADMAP "STFT numerics"): 1e-4 absolute on the normalised
  log-mel.
"""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from larynx_tpu.audio import AudioSettings as JAudioSettings
from larynx_tpu.audio import mel_basis as j_mel_basis
from larynx_tpu.models.glow_tts import flows as jflows
from larynx_tpu.models.glow_tts import init_params as j_init
from larynx_tpu.models.glow_tts import training as jtr
from larynx_tpu.models.glow_tts.config import GlowTTSConfig as JConfig
from larynx_tpu.models.glow_tts.data import Dataset as JDataset
from larynx_tpu.models.glow_tts.data import mel_targets as j_mel_targets
from larynx_tpu.models.glow_tts.model import encode as j_encode
from larynx_tpu.models.glow_tts.model import speaker_embedding as j_speaker_embedding
from larynx_tpu.parallel import train as jptrain

from larynx_tpu_torch.audio import AudioSettings
from larynx_tpu_torch.convert.native import load_params
from larynx_tpu_torch.io import wavfile
from larynx_tpu_torch.models.glow_tts import flows
from larynx_tpu_torch.models.glow_tts import training as tr
from larynx_tpu_torch.models.glow_tts.config import GlowTTSConfig
from larynx_tpu_torch.models.glow_tts.data import Dataset, mel_basis_tensor, mel_targets
from larynx_tpu_torch.models.glow_tts.model import encode, speaker_embedding
from larynx_tpu_torch.parallel import train as ptrain
from larynx_tpu_torch.train import save_voice_params
from larynx_tpu_torch.weights import params_from_jax

from test_torch_pipeline import PHONEME_TABLE

SMALL = dict(num_symbols=46, hidden_channels=64, filter_channels=128, filter_channels_dp=64,
             mel_channels=80, n_layers_enc=2, n_blocks_dec=2, n_block_layers=2, window_size=4,
             mean_only=True, prenet=True)
MULTI = dict(SMALL, n_speakers=4, gin_channels=16)


def _jax_params(kw, seed=0):
    """The JAX init with the zero-init coupling outputs perturbed, so that
    the couplings act."""
    params = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(seed), JConfig(**kw)))
    cp = params["decoder"]["coupling"]
    cp["end_w"] = (np.random.default_rng(seed).standard_normal(cp["end_w"].shape)
                   * 0.05).astype(np.float32)
    return params


def _batch(seed=0, b=2, t=12, m=48):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 46, (b, t)).astype(np.int32)
    id_lengths = np.array([t] + [t - 3] * (b - 1), np.int32)
    mels = (rng.standard_normal((b, m, 80)) * 0.5).astype(np.float32)
    mel_lengths = np.array([m] + [m - 11] * (b - 1), np.int32)
    return {"ids": ids, "id_lengths": id_lengths, "mels": mels, "mel_lengths": mel_lengths}


def _t(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)
            for k, v in batch.items()}


def _scale_close(out, ref, rel, what=""):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(out) - ref).max()
    assert err <= rel * max(np.abs(ref).max(), 1e-30), f"{what}: {err} vs scale {np.abs(ref).max()}"


def _alignment_problem(seed, b=3, t_x=7, t_y=19):
    rng = np.random.default_rng(seed)
    value = rng.standard_normal((b, t_x, t_y)).astype(np.float32)
    x_lengths = rng.integers(2, t_x + 1, size=b)
    y_lengths = np.maximum(rng.integers(t_x, t_y + 1, size=b), x_lengths)
    mask = np.zeros((b, t_x, t_y), dtype=np.float32)
    for i in range(b):
        mask[i, : x_lengths[i], : y_lengths[i]] = 1.0
    return value, mask


@pytest.mark.parametrize("seed,shape", [(s, (3, 7, 19)) for s in range(5)]
                         + [(5, (4, 30, 200)), (6, (2, 64, 256))])
def test_maximum_path_matches_jax(seed, shape):
    value, mask = _alignment_problem(seed, *shape)
    want = np.asarray(jtr.maximum_path(jnp.asarray(value), jnp.asarray(mask)))
    got = tr.maximum_path(torch.from_numpy(value), torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [SMALL, MULTI], ids=["single", "speaker_g"])
def test_forward_flow_matches_jax_and_inverts(kw):
    params = _jax_params(kw)
    batch = _batch()
    mel_lengths = (batch["mel_lengths"] // 2) * 2
    y_mask = (np.arange(48)[None, :] < mel_lengths[:, None]).astype(np.float32)
    mels = batch["mels"] * y_mask[..., None]
    jg = g = None
    if kw is MULTI:
        jg = j_speaker_embedding(params, jnp.asarray([1, 3]))
    want_z, want_ld = jflows.decoder(params["decoder"], jnp.asarray(mels), jnp.asarray(y_mask),
                                     JConfig(**kw), reverse=False, g=jg)

    tparams = params_from_jax(params, "glow_tts")
    cfg = GlowTTSConfig(**kw)
    if kw is MULTI:
        g = speaker_embedding(tparams, torch.tensor([1, 3]))
    z, logdet = flows.decoder(tparams["decoder"], torch.from_numpy(mels), torch.from_numpy(y_mask),
                              cfg, reverse=False, g=g)
    _scale_close(z.numpy(), want_z, 1e-5, "z")
    _scale_close(logdet.numpy(), want_ld, 1e-5, "logdet")
    back, _ = flows.decoder(tparams["decoder"], z, torch.from_numpy(y_mask), cfg, reverse=True, g=g)
    # the reverse flow undoes the forward one: float32 rounding only
    assert (back - torch.from_numpy(mels)).abs().max().item() <= 1e-4


def test_alignment_and_losses_match_jax():
    rng = np.random.default_rng(3)
    b, t_x, m, c = 2, 9, 24, 8
    z = rng.standard_normal((b, m, c)).astype(np.float32)
    x_m = rng.standard_normal((b, t_x, c)).astype(np.float32)
    x_logs = (rng.standard_normal((b, t_x, c)) * 0.1).astype(np.float32)
    _scale_close(tr.alignment_log_likelihood(*map(torch.from_numpy, (z, x_m, x_logs))).numpy(),
                 jtr.alignment_log_likelihood(*map(jnp.asarray, (z, x_m, x_logs))), 1e-5, "logp")

    mu = rng.standard_normal((b, m, c)).astype(np.float32)
    logs = (rng.standard_normal((b, m, c)) * 0.1).astype(np.float32)
    logdet = rng.standard_normal(b).astype(np.float32)
    mask = np.ones((b, m), dtype=np.float32)
    mask[1, 17:] = 0
    args = (z * mask[..., None], mu, logs, logdet, mask)
    _scale_close(tr.mle_loss(*map(torch.from_numpy, args)).numpy(),
                 jtr.mle_loss(*map(jnp.asarray, args)), 1e-6, "mle")

    logw, logw_hat = (rng.standard_normal((b, t_x)).astype(np.float32) for _ in range(2))
    lengths = np.array([9, 6], np.int32)
    _scale_close(tr.duration_loss(*map(torch.from_numpy, (logw, logw_hat, lengths))).numpy(),
                 jtr.duration_loss(*map(jnp.asarray, (logw, logw_hat, lengths))), 1e-6, "dur")


def test_intersperse_matches_jax():
    for seq in ([], [3], [5, 1, 4]):
        assert tr.intersperse(seq, 0) == jtr.intersperse(seq, 0)


def _jax_path(params, cfg, b):
    """JAX's MAS path of a training forward, from its own pieces."""
    x_m, x_logs, _, _, _, x_mask = j_encode(params, cfg, b["ids"], b["id_lengths"])
    ml = (b["mel_lengths"] // cfg.n_sqz) * cfg.n_sqz
    y_mask = (jnp.arange(b["mels"].shape[1])[None, :] < ml[:, None]).astype(jnp.float32)
    z, _ = jflows.decoder(params["decoder"], b["mels"], y_mask, cfg, reverse=False)
    logp = jtr.alignment_log_likelihood(z, x_m, x_logs)
    return jtr.maximum_path(logp, x_mask[:, :, None] * y_mask[:, None, :])


def _port_path(params, cfg, b):
    with torch.no_grad():
        x_m, x_logs, _, _, _, x_mask = encode(params, cfg, b["ids"], b["id_lengths"])
        ml = (b["mel_lengths"] // cfg.n_sqz) * cfg.n_sqz
        y_mask = (torch.arange(b["mels"].shape[1])[None, :] < ml[:, None]).float()
        z, _ = flows.decoder(params["decoder"], b["mels"], y_mask, cfg, reverse=False)
        logp = tr.alignment_log_likelihood(z, x_m, x_logs)
        return tr.maximum_path(logp, x_mask[:, :, None] * y_mask[:, None, :])


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _leaves(tree[k], f"{path}/{k}")]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree) for kv in _leaves(v, f"{path}/{i}")]
    return [(path, tree)]


def test_training_forward_loss_and_gradients_match_jax():
    params, batch = _jax_params(SMALL), _batch()
    jcfg, cfg = JConfig(**SMALL), GlowTTSConfig(**SMALL)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = _t(batch)
    tparams = ptrain.trainable(params_from_jax(params, "glow_tts"))
    # both packages pick the same alignment, or the losses differ by design
    want_path = jax.jit(_jax_path, static_argnums=1)(params, jcfg, jb)
    np.testing.assert_array_equal(_port_path(tparams, cfg, tb).numpy(), np.asarray(want_path))

    def loss_fn(p, b):
        return jtr.training_forward(p, jcfg, b["ids"], b["id_lengths"], b["mels"],
                                    b["mel_lengths"])

    (j_loss, j_metrics), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, jb)
    loss, metrics = tr.training_forward(tparams, cfg, tb["ids"], tb["id_lengths"], tb["mels"],
                                        tb["mel_lengths"])
    loss.backward()
    for key in ("mle_loss", "duration_loss", "loss"):
        _scale_close(metrics[key].numpy(), j_metrics[key], 1e-5, key)

    want = dict(_leaves(params_from_jax(jax.tree.map(np.asarray, j_grads), "glow_tts")))
    got = _leaves(tparams)
    floor = 1e-4 * max(v.abs().max().item() for v in want.values())
    assert [k for k, _ in got] == sorted(want)
    for path, leaf in got:
        ref = want[path]
        if path.endswith("weight_inv"):  # the forward flow never reads it
            assert leaf.grad is None and ref.abs().max().item() == 0.0
            continue
        err = (leaf.grad - ref).abs().max().item()
        assert err <= 1e-4 * max(ref.abs().max().item(), floor), (path, err)


@pytest.mark.parametrize("kw", [SMALL, MULTI], ids=["single", "speaker_g"])
def test_actnorm_ddi_init_matches_jax(kw):
    params, batch = _jax_params(kw), _batch(seed=1)
    speakers = np.array([0, 2]) if kw is MULTI else None
    want = jtr.actnorm_ddi_init(params, JConfig(**kw), jnp.asarray(batch["mels"]),
                                jnp.asarray(batch["mel_lengths"]),
                                None if speakers is None else jnp.asarray(speakers))
    got = tr.actnorm_ddi_init(params_from_jax(params, "glow_tts"), GlowTTSConfig(**kw),
                              torch.from_numpy(batch["mels"]),
                              torch.from_numpy(batch["mel_lengths"]).long(),
                              None if speakers is None else torch.from_numpy(speakers))
    for key in ("logs", "bias"):
        _scale_close(got["decoder"]["actnorm"][key].numpy(), want["decoder"]["actnorm"][key], 1e-5,
                     key)


def _gradient_sequence(seed, shapes, steps=5):
    rng = np.random.default_rng(seed)
    # a spread of magnitudes, some above the clip value of 5
    return [[(rng.standard_normal(s) * rng.choice([1e-3, 0.1, 8.0], size=s)).astype(np.float32)
             for s in shapes] for _ in range(steps)]


def _run_port_optimizer(opt, init, grads):
    params = [torch.tensor(p, requires_grad=True) for p in init]
    state = opt.init({str(i): p for i, p in enumerate(params)})
    lrs = []
    for step in grads:
        for p, g in zip(params, step):
            p.grad = torch.from_numpy(g.copy())
        opt.update(state)
        lrs.append(state.adam.param_groups[0]["lr"])
    return [p.detach().numpy() for p in params], lrs


def _run_optax(opt, init, grads):
    params = [jnp.asarray(p) for p in init]
    state = opt.init(params)
    for step in grads:
        updates, state = opt.update([jnp.asarray(g) for g in step], state, params)
        params = optax.apply_updates(params, updates)
    return [np.asarray(p) for p in params]


@pytest.mark.parametrize("seed", range(5))
def test_glow_tts_optimizer_matches_optax(seed):
    """Value clipping, Adam (0.9, 0.98, 1e-9) and Noam at optax's count:
    the k-th update (from 0) takes noam(max(k, 1)), so the first two share
    noam(1)."""
    cfg = GlowTTSConfig(**SMALL)
    shapes = [(7, 5), (5,), (3, 4, 2)]
    init = [np.random.default_rng(100 + seed).standard_normal(s).astype(np.float32)
            for s in shapes]
    grads = _gradient_sequence(seed, shapes)
    got, lrs = _run_port_optimizer(ptrain.make_optimizer(cfg, warmup_steps=3), init, grads)
    want = _run_optax(jptrain.make_optimizer(JConfig(**SMALL), warmup_steps=3), init, grads)
    noam = jptrain.noam_schedule(cfg.hidden_channels, 3)
    np.testing.assert_allclose(lrs, [float(noam(max(k, 1))) for k in range(5)], rtol=1e-6)
    assert lrs[0] == lrs[1] != lrs[2]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6 * max(lrs))


def test_saved_weight_inv_is_the_inverse_where_jax_keeps_the_init(tmp_path):
    """JAX's GlowTTS training leaves ``invconv.weight_inv`` at the init's
    inverse: the forward flow never reads it, so its gradient is zero and
    Adam does not move it, while ``weight`` moves.  The port saves
    inv(weight)."""
    params, batch, cfg = _jax_params(SMALL), _batch(seed=2), GlowTTSConfig(**SMALL)
    # a large learning rate, so that the weights move visibly in 3 steps
    kwargs = dict(warmup_steps=1, learning_rate_scale=0.5)
    j_opt = jptrain.make_optimizer(JConfig(**SMALL), **kwargs)
    j_state = jptrain.init_train_state(jax.tree.map(jnp.asarray, params), j_opt)
    j_step = jptrain.make_train_step(JConfig(**SMALL), j_opt)
    for _ in range(3):
        j_state, _ = j_step(j_state, {k: jnp.asarray(v) for k, v in batch.items()})
    j_inv = j_state.params["decoder"]["invconv"]
    np.testing.assert_array_equal(np.asarray(j_inv["weight_inv"]),
                                  params["decoder"]["invconv"]["weight_inv"])
    j_w = np.asarray(j_inv["weight"], np.float64)
    assert np.abs(j_w - params["decoder"]["invconv"]["weight"]).max() > 1e-2
    assert np.abs(j_w @ np.asarray(j_inv["weight_inv"]) - np.eye(4)).max() > 1e-2

    opt = ptrain.make_optimizer(cfg, **kwargs)
    state = ptrain.init_train_state(params_from_jax(params, "glow_tts"), opt)
    step = ptrain.make_train_step(cfg, opt)
    for _ in range(3):
        state, metrics = step(state, batch)
    assert np.isfinite(metrics["loss"].item())
    save_voice_params(tmp_path / "generator.npz", state.params)
    saved = load_params(tmp_path / "generator.npz")["decoder"]["invconv"]
    np.testing.assert_array_equal(saved["weight"],
                                  state.params["decoder"]["invconv"]["weight"].detach().numpy())
    assert np.abs(saved["weight"] - params["decoder"]["invconv"]["weight"]).max() > 1e-2
    np.testing.assert_allclose(saved["weight"].astype(np.float64) @ saved["weight_inv"], np.eye(4)
                               [None].repeat(2, 0), atol=1e-6)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_train_corpus")
    wav_dir = root / "wavs"
    wav_dir.mkdir()
    rng = np.random.default_rng(0)
    texts = ["Hello world.", "A voice is born.", "Testing one two three.",
             "The quick brown fox.", "It is a test.", "Good morning."]
    with open(root / "metadata.csv", "w", encoding="utf-8", newline="") as f:
        writer = csv.writer(f, delimiter="|")
        for i, text in enumerate(texts):
            n = int(22050 * (0.4 + 0.1 * i))
            t = np.arange(n) / 22050.0
            audio = 0.3 * np.sin(2 * np.pi * (120 + 20 * i) * t) + 0.05 * rng.standard_normal(n)
            wavfile.write(wav_dir / f"utt{i}.wav", 22050, (audio * 32767).astype(np.int16))
            writer.writerow([f"utt{i}", text])
        writer.writerow(["missing", "No wav for this one."])
    return root


def test_mel_targets_match_jax():
    rng = np.random.default_rng(4)
    audio = (0.3 * np.sin(np.arange(2, 9000) * 0.05)[None] + 0.05 * rng.standard_normal((2, 8998))
             ).astype(np.float32)
    settings = AudioSettings()
    want = j_mel_targets(jnp.asarray(audio), JAudioSettings(),
                         jnp.asarray(j_mel_basis(22050, 1024, 80, 0.0, 8000.0)))
    got = mel_targets(torch.from_numpy(audio), settings, mel_basis_tensor(settings, "cpu"))
    assert got.shape == want.shape == (2, 32, 80)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_dataset_batches_match_jax(corpus):
    """The same examples in the same shuffle order, at the padded shapes;
    the last, partial batch and the missing wav are dropped."""
    table = {p: i for i, p in enumerate(PHONEME_TABLE)}
    args = (corpus / "metadata.csv", corpus / "wavs", table)
    want = list(JDataset(*args, JAudioSettings()).batches(2, 64, 128, shuffle_seed=7))
    got = list(Dataset(*args, AudioSettings()).batches(2, 64, 128, shuffle_seed=7))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["ids"].shape == (2, 64) and g["mels"].shape == (2, 128, 80)
        for key in ("ids", "id_lengths", "mel_lengths"):
            np.testing.assert_array_equal(g[key], w[key])
            assert g[key].dtype == w[key].dtype
        np.testing.assert_allclose(g["mels"], w["mels"], atol=1e-4)
