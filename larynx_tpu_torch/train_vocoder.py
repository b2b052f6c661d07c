"""Vocoder training CLI: ``python -m larynx_tpu_torch.train_vocoder``.

Counterpart of ``larynx_tpu/train_vocoder.py``, on random hop-aligned
audio segments, written as a vocoder dir (``config.json`` +
``generator.npz`` in the native layout) that both packages'
``get_vocoder_model`` load.  The flags are the JAX CLI's.  One process
trains on ``--device`` (default ``cuda``); HiFi-GAN also trains data
parallel under ``python -m torch.distributed.run --nproc-per-node N``
(``parallel/mesh.py::make_mesh`` with no model axis, as JAX's), every rank
drawing the same global batch and taking its rows, rank 0 alone writing
and logging.  Two divergences from JAX, which quietly trains on one device
in both cases, where N processes have no such meaning: a HiFi-GAN batch
that does not divide over the ranks, and WaveGlow (one device in JAX) under
a world above 1, exit naming the sizes.

* ``--family hifi_gan``: the generator against the multi-period and
  multi-scale discriminators, with feature-matching and mel losses; both
  nets use Adam (betas (0.8, 0.99)) at optax's continuous exponential
  decay.
* ``--family waveglow``: the flow's negative log-likelihood at ``--sigma``
  (``models/waveglow/model.py::loss_fn``, unfused WN stacks), Adam at
  optax's defaults on the same decay, mels at the model's own hop.  The
  save records ``sigma`` in ``config.json`` and recomputes every
  invertible 1x1's ``w_inv`` from the trained ``w`` in float64 (``w_inv``
  is not trained).
"""

import argparse
import dataclasses
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

from larynx_tpu_torch.audio import AudioSettings
from larynx_tpu_torch.convert.native import load_params, save_params
from larynx_tpu_torch.device import resolve_device, to_device
from larynx_tpu_torch.io import wavfile
from larynx_tpu_torch.models.glow_tts.data import _pcm_to_float, mel_basis_tensor
from larynx_tpu_torch.models.hifi_gan.config import HiFiGanConfig
from larynx_tpu_torch.models.hifi_gan.training import init_gan_state, log_mel, make_gan_train_step
from larynx_tpu_torch.models.waveglow import model as wg_model
from larynx_tpu_torch.models.waveglow.config import WaveGlowConfig, waveglow_config_from_json
from larynx_tpu_torch.parallel.mesh import is_rank0, make_mesh, world_size
from larynx_tpu_torch.parallel.train import (
    LOG_EVERY,
    MetricHistory,
    Optimizer,
    exponential_decay,
    init_train_state,
    zero_grads,
)
from larynx_tpu_torch.weights import init_params, params_from_jax, params_to_jax

_LOGGER = logging.getLogger("larynx_tpu_torch.train_vocoder")

# released vocoder geometries by quality preset
GEOMETRY = {
    "high": dict(
        resblock="1", upsample_initial_channel=512,
        upsample_rates=(8, 8, 2, 2), upsample_kernel_sizes=(16, 16, 4, 4),
        resblock_kernel_sizes=(3, 7, 11),
        resblock_dilation_sizes=((1, 3, 5),) * 3,
    ),
    "medium": dict(
        resblock="1", upsample_initial_channel=128,
        upsample_rates=(8, 8, 2, 2), upsample_kernel_sizes=(16, 16, 4, 4),
        resblock_kernel_sizes=(3, 7, 11),
        resblock_dilation_sizes=((1, 3, 5),) * 3,
    ),
    "low": dict(
        resblock="2", upsample_initial_channel=256,
        upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
        resblock_kernel_sizes=(3, 5, 7),
        resblock_dilation_sizes=((1, 2), (2, 6), (3, 12)),
    ),
}


def get_args(argv=None):
    parser = argparse.ArgumentParser("larynx-tpu-torch-train-vocoder")
    parser.add_argument("--wav-dir", required=True, help="Directory of .wav files")
    parser.add_argument("--out-dir", required=True, help="Vocoder model dir to write")
    parser.add_argument(
        "--family", choices=("hifi_gan", "waveglow"), default="hifi_gan",
        help="Vocoder family to train (default: hifi_gan)",
    )
    parser.add_argument(
        "--quality", choices=list(GEOMETRY), default="low",
        help="hifi_gan geometry preset (default: low)",
    )
    parser.add_argument("--sigma", type=float, default=1.0,
                        help="waveglow training prior sigma (default: 1.0)")
    parser.add_argument("--config", help="JSON with a model section overriding the preset")
    parser.add_argument("--segment-frames", type=int, default=32,
                        help="Mel frames per training segment (default: 32)")
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--steps", type=int, default=100000)
    parser.add_argument("--learning-rate", type=float, default=2e-4)
    parser.add_argument("--lr-decay", type=float, default=0.999)
    parser.add_argument("--lr-decay-every", type=int, default=1000)
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--checkpoint-every", type=int, default=5000)
    parser.add_argument("--resume", help="generator.npz to resume the generator from")
    parser.add_argument(
        "--device", default="cuda",
        help="Device to train on (default: cuda; a CUDA device with no GPU raises)",
    )
    parser.add_argument("--debug", action="store_true")
    return parser.parse_args(argv)


def _load_corpus(wav_dir: Path, min_samples: int):
    """[audio float32 in [-1, 1]] of every readable wav of at least
    ``min_samples``, in name order."""
    corpus = []
    for path in sorted(wav_dir.glob("*.wav")):
        try:
            _rate, pcm = wavfile.read(path)
        except (OSError, wavfile.WavFileError):
            _LOGGER.warning("Skipping unreadable %s", path)
            continue
        if pcm.ndim > 1:
            pcm = pcm[:, 0]
        audio = _pcm_to_float(pcm)
        if audio.shape[0] >= min_samples:
            corpus.append(audio)
    return corpus


def _make_mel_fn(settings: AudioSettings, frames: int, device):
    """Segment audio [B, T] -> the generator's input log-mels
    [B, frames, n_mels], padded with log(1e-5) where the STFT gives fewer."""
    basis = mel_basis_tensor(settings, device)

    def make_mels(audio: torch.Tensor) -> torch.Tensor:
        m = log_mel(audio, settings, basis).transpose(1, 2)
        if m.shape[1] >= frames:
            return m[:, :frames, :]
        return torch.nn.functional.pad(m, (0, 0, 0, frames - m.shape[1]),
                                       value=float(np.log(1e-5)))

    return make_mels


def _corpus(args, seg_samples: int, up: int):
    """``_load_corpus`` of ``--wav-dir`` with room for a segment and a hop;
    no usable wav ends the run."""
    corpus = _load_corpus(Path(args.wav_dir), seg_samples + up)
    if not corpus:
        raise SystemExit(f"no usable wavs >= {seg_samples + up} samples in {args.wav_dir}")
    return corpus


def _sample_batch(rng, corpus, batch_size, seg_samples, up) -> np.ndarray:
    """Hop-aligned random crops, so that mel frames line up."""
    batch_audio = np.empty((batch_size, seg_samples), np.float32)
    for i in range(batch_size):
        audio = corpus[rng.integers(len(corpus))]
        max_off = (audio.shape[0] - seg_samples) // up
        off = int(rng.integers(max_off + 1)) * up
        batch_audio[i] = audio[off : off + seg_samples]
    return batch_audio


def _run_steps(args, corpus, seg_samples: int, up: int, device, make_mels, train_step, save,
               log_line, group=None) -> list:
    """The vocoder trainers' loop: ``--steps`` steps, each
    ``train_step(audio, mels)`` -> metrics on a batch of random hop-aligned
    crops (the global batch: every rank draws the same), a log line every
    LOG_EVERY steps (``log_line(step, last metrics, steps/s)``), a save
    every ``--checkpoint-every`` steps and at the end or an interrupt.
    Returns every step's metrics as host floats (summed over the data
    ``group``'s shares)."""
    rng = np.random.default_rng(args.seed)
    history = MetricHistory(group)
    step = 0
    t0 = time.time()
    try:
        while step < args.steps:
            audio = to_device(_sample_batch(rng, corpus, args.batch_size, seg_samples, up), device)
            history.append(train_step(audio, make_mels(audio)))
            step += 1
            if step % LOG_EVERY == 0:
                log_line(step, history.flush(), step / max(time.time() - t0, 1e-9))
            if step % args.checkpoint_every == 0:
                save(step)
    except KeyboardInterrupt:
        _LOGGER.info("Interrupted")
    finally:
        history.flush()
        save(step)
    return history.steps


def save_waveglow(out_dir: Path, params, cfg: WaveGlowConfig, sigma: float) -> None:
    """A WaveGlow vocoder dir: ``config.json`` (the config with the trained
    ``sigma``) and ``generator.npz``, every ``convinv.w_inv`` recomputed as
    inv(w) in float64."""
    with open(out_dir / "config.json", "w", encoding="utf-8") as f:
        json.dump(dict(dataclasses.asdict(cfg), sigma=sigma), f)
    tree = params_to_jax(params, "waveglow")
    for flow in tree["flows"]:
        conv = flow["convinv"]
        conv["w_inv"] = np.linalg.inv(conv["w"].astype(np.float64)).astype(np.float32)
    save_params(out_dir / "generator.npz", tree)


def _train_waveglow(args, device):
    """``--family waveglow`` (``larynx_tpu/train_vocoder.py::_train_waveglow``)."""
    cfg = waveglow_config_from_json(args.config) if args.config else WaveGlowConfig()
    # the conditioning mels are the model's own: one frame per
    # upsample_stride samples at its sample rate
    settings = AudioSettings(mel_channels=cfg.mel_channels, sample_rate=cfg.sampling_rate,
                             hop_length=cfg.upsample_stride)
    up = cfg.upsample_stride
    seg_samples = args.segment_frames * up
    corpus = _corpus(args, seg_samples, up)
    _LOGGER.info("Training waveglow on %d file(s), %d-sample segments, device %s",
                 len(corpus), seg_samples, device)

    optimizer = Optimizer(exponential_decay(args.learning_rate, args.lr_decay_every,
                                            args.lr_decay))
    if args.resume:
        params = params_from_jax(load_params(args.resume), "waveglow", device)
        _LOGGER.info("Resumed from %s (parameters only: Adam starts again at step 0)",
                     args.resume)
    else:
        params = params_from_jax(init_params(torch.Generator().manual_seed(args.seed), cfg),
                                 "waveglow", device)
    # w_inv is not trained: JAX's zero gradient gives it a zero Adam update
    state = init_train_state(params, optimizer, frozen=("w_inv",))
    make_mels = _make_mel_fn(settings, args.segment_frames, device)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    def train_step(audio, mels):
        zero_grads(state.opt_state)
        loss = wg_model.loss_fn(state.params, cfg, audio, mels, args.sigma)
        loss.backward()
        optimizer.update(state.opt_state)
        state.step += 1
        return {"nll": loss.detach()}

    def save(step: int):
        save_waveglow(out_dir, state.params, cfg, args.sigma)
        _LOGGER.info("Saved waveglow checkpoint at step %s to %s", step, out_dir)

    def log_line(step, m, rate):
        _LOGGER.info("step %s nll %.4f %.2f steps/s", step, m["nll"], rate)

    return state, _run_steps(args, corpus, seg_samples, up, device, make_mels, train_step, save,
                             log_line)


def main(argv=None):
    """Train; returns the final state (a ``GanTrainState``, or for
    WaveGlow a ``parallel.train.TrainState``) and every step's metrics as
    host floats."""
    args = get_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.debug else
                        logging.INFO if is_rank0() else logging.WARNING)
    # float32 convs and matmuls, as the port's inference CLI
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    world = world_size()
    if args.family == "waveglow":
        if world > 1:
            raise SystemExit(f"waveglow trains on one device (as the JAX trainer); this run has "
                             f"world size {world}: run it without torch.distributed.run")
        return _train_waveglow(args, resolve_device(args.device))
    if args.batch_size % world:
        raise SystemExit(f"--batch-size {args.batch_size} does not split over world size {world}: "
                         "pass a multiple of the number of processes")
    mesh = make_mesh(model_parallel=1, device=args.device)
    try:
        return _train_hifi_gan(args, mesh)
    finally:
        mesh.close()


def _train_hifi_gan(args, mesh):
    device = mesh.device

    geometry = dict(GEOMETRY[args.quality])
    if args.config:
        with open(args.config, "r", encoding="utf-8") as f:
            loaded = json.load(f)
        known = set(HiFiGanConfig.__dataclass_fields__)
        geometry.update({
            k: tuple(tuple(x) if isinstance(x, list) else x for x in v)
            if isinstance(v, list) else v
            for k, v in loaded.get("model", loaded).items() if k in known
        })
    cfg = HiFiGanConfig(**geometry)
    settings = AudioSettings()
    up = cfg.total_upsample
    seg_samples = args.segment_frames * up
    corpus = _corpus(args, seg_samples, up)
    _LOGGER.info("Training %s vocoder on %d file(s), %d-sample segments, device %s",
                 args.quality, len(corpus), seg_samples, device)

    schedule = exponential_decay(args.learning_rate, args.lr_decay_every, args.lr_decay)
    gen_opt = Optimizer(schedule, betas=(0.8, 0.99))
    disc_opt = Optimizer(schedule, betas=(0.8, 0.99))
    gen_params = None
    if args.resume:
        gen_params = params_from_jax(load_params(args.resume), "hifi_gan")
        _LOGGER.info("Resumed generator from %s", args.resume)
    state = init_gan_state(torch.Generator().manual_seed(args.seed), cfg, gen_opt, disc_opt,
                           device=device, gen_params=gen_params)
    gan_step = make_gan_train_step(cfg, settings, gen_opt, disc_opt, mesh=mesh)

    make_mels = _make_mel_fn(settings, args.segment_frames, device)
    out_dir = Path(args.out_dir)
    if mesh.rank == 0:
        out_dir.mkdir(parents=True, exist_ok=True)

    def save(step: int):
        if mesh.rank != 0:
            return
        with open(out_dir / "config.json", "w", encoding="utf-8") as f:
            json.dump({
                "audio": {"num_mels": settings.mel_channels, "sampling_rate": settings.sample_rate},
                "model": {k: list(v) if isinstance(v, tuple) else v for k, v in geometry.items()},
            }, f)
        save_params(out_dir / "generator.npz", params_to_jax(state.gen_params, "hifi_gan"))
        _LOGGER.info("Saved vocoder checkpoint at step %s to %s", step, out_dir)

    def log_line(step, m, rate):
        _LOGGER.info("step %s d %.4f g %.4f (mel_l1 %.4f) %.2f steps/s", step, m["d_loss"],
                     m["g_loss"], m["mel_l1"], rate)

    return state, _run_steps(
        args, corpus, seg_samples, up, device, make_mels,
        lambda audio, mels: gan_step(state, {"mels": mels, "audio": audio})[1], save, log_line,
        group=mesh.data_group)


if __name__ == "__main__":
    main()
