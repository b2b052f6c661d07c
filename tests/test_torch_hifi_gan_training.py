"""The port's HiFi-GAN training against ``larynx_tpu``'s, on the CPU.

Same numpy params (the JAX inits under fixed keys, converted by
``params_from_jax``) and audio through both packages, at
``tests/test_hifi_gan_training.py``'s SMALL_CFG.  Tolerances:

* discriminator scores and feature maps, losses: float32 sums in another
  order, ~1e-7 relative; held to 1e-5 of the output's scale.
* ``log_mel``: ``torch.fft`` against pocketfft (ROADMAP "STFT numerics"),
  1e-4 absolute on log-mels of O(10).
* one train step, against JAX's objectives at the same params (the
  generator's at the port's updated discriminators: Adam's first step is
  lr * sign(g), and a gradient at rounding level may take the other sign
  in the other package), in float64 (XLA's float32 conv gradients on the
  CPU sit up to 1.3e-3 relative from float64 on the period-5
  discriminator's convs, the port's float32 within 1e-5): losses within
  1e-5 relative, every gradient leaf within 1e-4 of the leaf's scale.
* the optimizer: the same gradient sequences through both; after 5 updates
  within 1e-5 relative, 1e-6 of the learning rate absolute.
* layouts and the state-dict import: exact, and 1e-6 relative where the
  import folds norms in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from larynx_tpu.audio import AudioSettings as JAudioSettings
from larynx_tpu.audio import mel_basis as j_mel_basis
from larynx_tpu.models.hifi_gan import HiFiGanConfig as JConfig
from larynx_tpu.models.hifi_gan import discriminators as jd
from larynx_tpu.models.hifi_gan import init_params as j_init
from larynx_tpu.models.hifi_gan import model as jgen
from larynx_tpu.models.hifi_gan import training as jtr

from larynx_tpu_torch.audio import AudioSettings
from larynx_tpu_torch.models.glow_tts.config import GlowTTSConfig
from larynx_tpu_torch.models.glow_tts.data import mel_basis_tensor
from larynx_tpu_torch.models.hifi_gan import discriminators as disc
from larynx_tpu_torch.models.hifi_gan import training as tr
from larynx_tpu_torch.models.hifi_gan.config import HiFiGanConfig
from larynx_tpu_torch.models.tacotron2.config import Tacotron2Config
from larynx_tpu_torch.models.waveglow import WaveGlowConfig
from larynx_tpu_torch.parallel import train as ptrain
from larynx_tpu_torch.weights import init_params, params_from_jax, params_to_jax

from test_torch_glow_tts_training import SMALL as GLOW_SMALL
from test_torch_glow_tts_training import _leaves, _run_optax, _run_port_optimizer
from test_torch_glow_tts_training import _gradient_sequence, _scale_close

SMALL = dict(resblock="2", upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
             upsample_initial_channel=32, resblock_kernel_sizes=(3,),
             resblock_dilation_sizes=((1, 2),))
FRAMES = 16


@pytest.fixture(scope="module")
def nets():
    """(generator, discriminators) as native numpy trees: the JAX init of
    the generator, the port's of the discriminators (the same shapes and
    distributions, drawn faster)."""
    gen = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0), JConfig(**SMALL)))
    return gen, init_params(torch.Generator().manual_seed(1), "discriminators")


def _audio(seed, b=2, n=FRAMES * 256):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 22050.0
    return (0.3 * np.sin(2 * np.pi * rng.uniform(100, 300, (b, 1)) * t)
            + 0.05 * rng.standard_normal((b, n))).astype(np.float32)


@pytest.mark.parametrize("kind", ["multi_period", "multi_scale"])
def test_discriminators_match_jax(nets, kind):
    """Scores and every feature map (channels-first in the port) of real and
    fake audio, with a length that is no multiple of the periods (reflect
    padding)."""
    real, fake = _audio(0, n=3001), _audio(1, n=3001)
    want = jax.jit(getattr(jd, kind))(nets[1], real, fake)
    got = getattr(disc, kind)(params_from_jax(nets[1], "discriminators"),
                              torch.from_numpy(real), torch.from_numpy(fake))
    for scores_g, scores_w in zip(got[:2], want[:2]):
        for g, w in zip(scores_g, scores_w):
            _scale_close(g.numpy(), w, 1e-5, "score")
    for fmaps_g, fmaps_w in zip(got[2:], want[2:]):
        for layers_g, layers_w in zip(fmaps_g, fmaps_w):
            for g, w in zip(layers_g, layers_w):
                w = np.asarray(w)
                w = w.transpose(0, 3, 1, 2) if w.ndim == 4 else w.transpose(0, 2, 1)
                assert g.shape == w.shape
                _scale_close(g.numpy(), w, 1e-5, "fmap")


def test_gan_losses_match_jax():
    rng = np.random.default_rng(2)
    scores = [[rng.standard_normal((2, n)).astype(np.float32) for n in (7, 13, 5)]
              for _ in range(2)]
    fmaps = [[[rng.standard_normal((2, 3, n)).astype(np.float32) for n in (9, 4)]
              for _ in range(3)] for _ in range(2)]
    tt = lambda tree: jax.tree.map(torch.from_numpy, tree)  # noqa: E731
    jj = lambda tree: jax.tree.map(jnp.asarray, tree)  # noqa: E731
    _scale_close(disc.discriminator_loss(*tt(scores)).numpy(),
                 jd.discriminator_loss(*jj(scores)), 1e-6, "d")
    _scale_close(disc.generator_loss(tt(scores[1])).numpy(),
                 jd.generator_loss(jj(scores[1])), 1e-6, "g")
    _scale_close(disc.feature_loss(*tt(fmaps)).numpy(), jd.feature_loss(*jj(fmaps)), 1e-6, "fm")


def test_log_mel_matches_jax():
    audio = _audio(3, n=9000)
    want = jtr.log_mel(jnp.asarray(audio), JAudioSettings(),
                       jnp.asarray(j_mel_basis(22050, 1024, 80, 0.0, 8000.0)))
    settings = AudioSettings()
    got = tr.log_mel(torch.from_numpy(audio), settings, mel_basis_tensor(settings, "cpu"))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def _jax_d_loss(d_params, real, fake):
    return (jd.discriminator_loss(*jd.multi_period(d_params, real, fake)[:2])
            + jd.discriminator_loss(*jd.multi_scale(d_params, real, fake)[:2]))


def _jax_g_loss(g_params, d_params, real, mels, basis):
    """JAX's generator objective (``larynx_tpu/models/hifi_gan/training.py``)."""
    fake = jgen.generator(g_params, JConfig(**SMALL), mels)
    _, sg_p, fr_p, fg_p = jd.multi_period(d_params, real, fake)
    _, sg_s, fr_s, fg_s = jd.multi_scale(d_params, real, fake)
    adv = jd.generator_loss(sg_p) + jd.generator_loss(sg_s)
    fm = jd.feature_loss(fr_p, fg_p) + jd.feature_loss(fr_s, fg_s)
    settings = JAudioSettings()
    mel_l1 = jnp.mean(jnp.abs(jtr.log_mel(fake, settings, basis)
                              - jtr.log_mel(real, settings, basis)))
    return adv + fm + jtr.MEL_LOSS_WEIGHT * mel_l1, {"adv_loss": adv, "fm_loss": fm,
                                                     "mel_l1": mel_l1}


def test_gan_train_step_losses_and_gradients_match_jax(nets):
    """One ``make_gan_train_step``: the discriminators' loss and gradients on
    the detached fake, then the generator's against the discriminators
    after their update, each against JAX's objective at the same params."""
    gen, dis = nets
    cfg = HiFiGanConfig(**SMALL)
    # one row of 8 frames: JAX's float64 convs on the CPU are slow
    audio = _audio(4, b=1, n=8 * 256)
    mels = np.random.default_rng(5).standard_normal((1, 8, 80)).astype(np.float32)
    opt = ptrain.Optimizer(lambda k: 2e-4, betas=(0.8, 0.99))
    gen_t = ptrain.trainable(params_from_jax(gen, "hifi_gan"))
    dis_t = ptrain.trainable(params_from_jax(dis, "discriminators"))
    state = tr.GanTrainState(gen_t, dis_t, opt.init(gen_t), opt.init(dis_t))
    state, metrics = tr.make_gan_train_step(cfg, AudioSettings(), opt, opt)(
        state, {"mels": torch.from_numpy(mels), "audio": torch.from_numpy(audio)})

    f64 = lambda tree: jax.tree.map(lambda a: np.asarray(a, np.float64), tree)  # noqa: E731
    with jax.enable_x64():
        fake = jax.jit(jgen.generator, static_argnums=1)(f64(gen), JConfig(**SMALL), f64(mels))
        d_loss, d_grads = jax.jit(jax.value_and_grad(_jax_d_loss))(f64(dis), f64(audio), fake)
        # the generator's objective against the port's updated discriminators
        basis = j_mel_basis(22050, 1024, 80, 0.0, 8000.0, dtype=np.float64)
        updated = params_to_jax(state.disc_params, "discriminators")
        (g_loss, parts), g_grads = jax.jit(jax.value_and_grad(_jax_g_loss, has_aux=True))(
            f64(gen), f64(updated), f64(audio), f64(mels), basis)
    for key, want in dict(parts, d_loss=d_loss, g_loss=g_loss).items():
        _scale_close(metrics[key].numpy(), want, 1e-5, key)
    for params, grads, kind in ((state.disc_params, d_grads, "discriminators"),
                                (state.gen_params, g_grads, "hifi_gan")):
        want = dict(_leaves(params_from_jax(jax.tree.map(np.asarray, grads), kind)))
        got = _leaves(params)
        assert [k for k, _ in got] == sorted(want)
        for path, leaf in got:
            ref = want[path]
            err = (leaf.grad - ref).abs().max().item()
            assert err <= 1e-4 * ref.abs().max().item(), (kind, path, err)


@pytest.mark.parametrize("seed", range(5))
def test_gan_optimizer_matches_optax(seed):
    """Adam (0.8, 0.99) at optax's continuous exponential decay,
    lr * decay^(k / every) at the k-th update."""
    shapes = [(6, 4), (4,), (2, 3, 5)]
    init = [np.random.default_rng(200 + seed).standard_normal(s).astype(np.float32)
            for s in shapes]
    grads = _gradient_sequence(seed, shapes)
    got, lrs = _run_port_optimizer(
        ptrain.Optimizer(ptrain.exponential_decay(2e-4, 2, 0.5), betas=(0.8, 0.99)), init, grads)
    schedule = optax.exponential_decay(2e-4, 2, 0.5)
    want = _run_optax(optax.adam(schedule, b1=0.8, b2=0.99), init, grads)
    np.testing.assert_allclose(lrs, [float(schedule(k)) for k in range(5)], rtol=1e-6)
    assert lrs[1] == pytest.approx(2e-4 * 0.5 ** 0.5)  # continuous, not a staircase
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6 * max(lrs))


@pytest.mark.parametrize("kind", ["glow_tts", "hifi_gan", "discriminators", "waveglow",
                                  "tacotron2"])
def test_params_to_jax_inverts_params_from_jax(nets, kind):
    tree = {
        "glow_tts": lambda: init_params(torch.Generator().manual_seed(0), GlowTTSConfig(
            **dict(GLOW_SMALL, n_speakers=3, gin_channels=8))),
        "hifi_gan": lambda: nets[0],
        "discriminators": lambda: nets[1],
        "waveglow": lambda: init_params(torch.Generator().manual_seed(1), WaveGlowConfig(
            mel_channels=8, flows=4, early_every=2, wn_channels=16, wn_layers=2,
            upsample_kernel=128, upsample_stride=64)),
        "tacotron2": lambda: init_params(torch.Generator().manual_seed(2), Tacotron2Config(
            num_symbols=20, symbols_embedding_dim=16, encoder_embedding_dim=16, prenet_dim=8,
            attention_rnn_dim=24, decoder_rnn_dim=24, attention_dim=12, mel_channels=12,
            postnet_embedding_dim=16, postnet_n_convolutions=3)),
    }[kind]()
    back = params_to_jax(params_from_jax(tree, kind), kind)
    want, got = _leaves(tree), _leaves(back)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=path)


def test_discriminator_init_has_the_jax_shapes(nets):
    got = _leaves(nets[1])
    want = _leaves(jax.eval_shape(jd.init_discriminators, jax.random.PRNGKey(1)))
    assert [(k, v.shape, v.dtype) for k, v in got] == [(k, v.shape, v.dtype) for k, v in want]
    # uniform 1/sqrt(fan_in): the first MSD conv's fan_in is 15, the second's 41 * 32
    leaves = dict(got)
    assert 0.2 < np.abs(leaves["/scales/0/convs/0/w"]).max() <= 15**-0.5
    assert np.abs(leaves["/scales/0/convs/1/w"]).max() <= (41 * 32) ** -0.5


def test_discriminators_from_state_dict_matches_jax(nets):
    """A state dict in the reference's naming: MPD convs under weight norm
    and plain MSD convs against JAX's import; the first scale's convs under
    spectral norm (as the reference's) against W / (u^T W v).  JAX's import
    takes a spectral-norm conv's ``weight_v`` (the power iteration's
    vector) for weight norm's and fails on it, so that case has no JAX
    side."""
    rng = np.random.default_rng(6)
    tparams = params_from_jax(nets[1], "discriminators")

    def convs(p):
        return [(f"convs.{j}", c) for j, c in enumerate(p["convs"])] + [("conv_post", p["post"])]

    sd, spectral = {}, {}
    for i, p in enumerate(tparams["periods"]):
        for name, conv in convs(p):
            v = conv["w"].numpy().astype(np.float64) * rng.uniform(0.5, 2.0)
            sd[f"mpd.discriminators.{i}.{name}.weight_v"] = v
            sd[f"mpd.discriminators.{i}.{name}.weight_g"] = rng.uniform(
                0.5, 1.5, (v.shape[0], 1, 1, 1))
            sd[f"mpd.discriminators.{i}.{name}.bias"] = conv["b"].numpy()
    for i, p in enumerate(tparams["scales"]):
        for name, conv in convs(p):
            sd[f"msd.discriminators.{i}.{name}.weight"] = conv["w"].numpy()
            sd[f"msd.discriminators.{i}.{name}.bias"] = conv["b"].numpy()
    want = dict(_leaves(params_from_jax(jd.discriminators_from_state_dict(sd), "discriminators")))
    got = _leaves(disc.discriminators_from_state_dict(sd))
    assert [k for k, _ in got] == sorted(want)
    for path, g in got:
        np.testing.assert_allclose(g.numpy(), want[path].numpy(), rtol=1e-6, atol=1e-9,
                                   err_msg=path)

    for name, conv in convs(tparams["scales"][0]):
        prefix = f"msd.discriminators.0.{name}"
        w = sd.pop(f"{prefix}.weight").astype(np.float64)
        u, v = rng.standard_normal(w.shape[0]), rng.standard_normal(w[0].size)
        sd.update({f"{prefix}.weight_orig": w, f"{prefix}.weight_u": u, f"{prefix}.weight_v": v})
        spectral[name] = w / (u @ w.reshape(w.shape[0], -1) @ v)
    got = disc.discriminators_from_state_dict(sd)["scales"][0]
    for name, conv in convs(got):
        np.testing.assert_allclose(conv["w"].numpy(), spectral[name], rtol=1e-6, err_msg=name)
