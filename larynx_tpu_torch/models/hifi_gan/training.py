"""HiFi-GAN adversarial training step.

Counterpart of ``larynx_tpu/models/hifi_gan/training.py``: LSGAN losses
over the multi-period and multi-scale discriminators, feature matching,
and a 45x L1 loss between log-mels.  One step updates the discriminators
on the detached fake, then the generator against the updated
discriminators.  The generator trains on unpacked params (no ``"mrf"``
entry), so it runs the resblocks as torch convs under autograd, as the JAX
package trains it without its Pallas kernels.

Data parallel on a ``TrainMesh`` (``parallel/train.py``): each rank takes
its equal share of the global batch's rows (the trainer requires the batch
to divide over the ranks).  Every loss is a mean over equal shards, so a
rank's share of the global loss is its local loss over the number of data
ranks; both updates sum the shares' gradients over the data group before
Adam, and every rank's discriminators, then generator, stay the same.
"""

import typing
from dataclasses import dataclass

import torch

import larynx_tpu_torch.dsp.stft as dsp
from larynx_tpu_torch.audio import AudioSettings
from larynx_tpu_torch.models.glow_tts.data import mel_basis_tensor
from larynx_tpu_torch.models.hifi_gan import discriminators as disc
from larynx_tpu_torch.models.hifi_gan import model as gen_model
from larynx_tpu_torch.models.hifi_gan.config import HiFiGanConfig
from larynx_tpu_torch.parallel.train import (
    Optimizer,
    OptState,
    local_rows,
    reduce_grads,
    trainable,
    zero_grads,
)
from larynx_tpu_torch.weights import init_params, params_from_jax, tree_to

MEL_LOSS_WEIGHT = 45.0


def log_mel(audio: torch.Tensor, settings: AudioSettings, basis: torch.Tensor) -> torch.Tensor:
    """[B, T] -> [B, n_mels, M] = log(clamp(mel_basis @ |STFT|, 1e-5)),
    differentiable in the audio."""
    mag, _ = dsp.stft_magnitude_phase(audio, settings.filter_length, settings.hop_length)
    return torch.log(torch.clamp(torch.einsum("mf,bft->bmt", basis, mag), min=1e-5))


@dataclass
class GanTrainState:
    gen_params: typing.Any
    disc_params: typing.Any
    gen_opt: OptState
    disc_opt: OptState
    step: int = 0


def init_gan_state(
    generator: torch.Generator,
    cfg: HiFiGanConfig,
    gen_optimizer: Optimizer,
    disc_optimizer: Optimizer,
    device="cpu",
    gen_params=None,
) -> GanTrainState:
    """A random generator (unless ``gen_params``, unpacked, in the port's
    layout, are given) and random discriminators from ``generator``, as
    trainable leaves on ``device``, each with its optimizer."""
    if gen_params is None:
        gen_params = params_from_jax(init_params(generator, cfg), "hifi_gan")
    disc_params = params_from_jax(init_params(generator, "discriminators"), "discriminators")
    gen_params = trainable(tree_to(gen_params, device))
    disc_params = trainable(tree_to(disc_params, device))
    return GanTrainState(gen_params=gen_params, disc_params=disc_params,
                         gen_opt=gen_optimizer.init(gen_params),
                         disc_opt=disc_optimizer.init(disc_params))


def discriminator_loss_fn(disc_params, real, fake) -> torch.Tensor:
    sr_p, sg_p, _, _ = disc.multi_period(disc_params, real, fake)
    sr_s, sg_s, _, _ = disc.multi_scale(disc_params, real, fake)
    return disc.discriminator_loss(sr_p, sg_p) + disc.discriminator_loss(sr_s, sg_s)


def generator_loss_fn(disc_params, real, fake, settings, basis):
    """(total, {"adv", "fm", "mel_l1"}) of the generator's output ``fake``."""
    sr_p, sg_p, fr_p, fg_p = disc.multi_period(disc_params, real, fake)
    sr_s, sg_s, fr_s, fg_s = disc.multi_scale(disc_params, real, fake)
    adv = disc.generator_loss(sg_p) + disc.generator_loss(sg_s)
    fm = disc.feature_loss(fr_p, fg_p) + disc.feature_loss(fr_s, fg_s)
    mel_l1 = torch.mean(torch.abs(log_mel(fake, settings, basis) - log_mel(real, settings, basis)))
    return adv + fm + MEL_LOSS_WEIGHT * mel_l1, {"adv": adv, "fm": fm, "mel_l1": mel_l1}


def make_gan_train_step(
    cfg: HiFiGanConfig,
    settings: AudioSettings,
    gen_optimizer: Optimizer,
    disc_optimizer: Optimizer,
    mesh=None,
):
    """(state, batch) -> (state, metrics), both nets updated in place.

    Batch: {"mels": [B, M, n_mels] log-mels, "audio": [B, M * upsample]}
    as tensors on the params' device, the global batch.  The generator runs
    once; its output, detached, trains the discriminators, then the same
    output (JAX's second forward pass computes the same values) trains the
    generator against the updated discriminators.  Metrics are device
    scalars (on a mesh, this rank's shares of the global means)."""
    basis_of = {}
    share = 1.0 if mesh is None else 1.0 / mesh.n_data

    def train_step(state: GanTrainState, batch):
        batch = local_rows(batch, mesh)
        mels, real = batch["mels"], batch["audio"]
        if real.device not in basis_of:
            basis_of[real.device] = mel_basis_tensor(settings, real.device)
        basis = basis_of[real.device]
        fake = gen_model.generator(state.gen_params, cfg, mels)

        zero_grads(state.disc_opt)
        d_loss = discriminator_loss_fn(state.disc_params, real, fake.detach()) * share
        d_loss.backward()
        reduce_grads(state.disc_opt, mesh)
        disc_optimizer.update(state.disc_opt)

        zero_grads(state.gen_opt)
        g_loss, parts = generator_loss_fn(state.disc_params, real, fake, settings, basis)
        g_loss = g_loss * share
        gen_leaves = state.gen_opt.adam.param_groups[0]["params"]
        for p, g in zip(gen_leaves, torch.autograd.grad(g_loss, gen_leaves)):
            p.grad = g
        reduce_grads(state.gen_opt, mesh)
        gen_optimizer.update(state.gen_opt)
        state.step += 1
        return state, {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(),
                       "mel_l1": parts["mel_l1"].detach() * share,
                       "fm_loss": parts["fm"].detach() * share,
                       "adv_loss": parts["adv"].detach() * share}

    return train_step
