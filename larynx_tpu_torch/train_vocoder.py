"""HiFi-GAN vocoder training CLI: ``python -m larynx_tpu_torch.train_vocoder``.

Counterpart of ``larynx_tpu/train_vocoder.py`` for the HiFi-GAN family, on
one device (``--device``, default ``cuda``): the generator against the
multi-period and multi-scale discriminators, with feature-matching and mel
losses, on random hop-aligned audio segments, written as a vocoder dir
(``config.json`` + ``generator.npz`` in the native layout) that both
packages' ``get_vocoder_model`` load.  The flags are the JAX CLI's; both
nets use Adam (betas (0.8, 0.99)) at optax's continuous exponential decay.
``--family waveglow`` is not ported yet (ROADMAP).
"""

import argparse
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
from larynx_tpu_torch.parallel.train import Optimizer, exponential_decay
from larynx_tpu_torch.weights import params_from_jax, params_to_jax

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
        help="Vocoder family to train (default: hifi_gan; waveglow is not ported yet)",
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


def _sample_batch(rng, corpus, batch_size, seg_samples, up) -> np.ndarray:
    """Hop-aligned random crops, so that mel frames line up."""
    batch_audio = np.empty((batch_size, seg_samples), np.float32)
    for i in range(batch_size):
        audio = corpus[rng.integers(len(corpus))]
        max_off = (audio.shape[0] - seg_samples) // up
        off = int(rng.integers(max_off + 1)) * up
        batch_audio[i] = audio[off : off + seg_samples]
    return batch_audio


def main(argv=None):
    """Train; returns the final GAN state and every step's metrics (device
    scalars)."""
    args = get_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.debug else logging.INFO)
    if args.family == "waveglow":
        raise NotImplementedError(
            "--family waveglow: WaveGlow training is not ported yet (ROADMAP, modules to port: "
            "WaveGlow and Tacotron2 training)")
    device = resolve_device(args.device)
    # float32 convs and matmuls, as the port's inference CLI
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

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

    corpus = _load_corpus(Path(args.wav_dir), seg_samples + up)
    if not corpus:
        raise SystemExit(f"no usable wavs >= {seg_samples + up} samples in {args.wav_dir}")
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
    train_step = make_gan_train_step(cfg, settings, gen_opt, disc_opt)

    make_mels = _make_mel_fn(settings, args.segment_frames, device)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    def save(step: int):
        with open(out_dir / "config.json", "w", encoding="utf-8") as f:
            json.dump({
                "audio": {"num_mels": settings.mel_channels, "sampling_rate": settings.sample_rate},
                "model": {k: list(v) if isinstance(v, tuple) else v for k, v in geometry.items()},
            }, f)
        save_params(out_dir / "generator.npz", params_to_jax(state.gen_params, "hifi_gan"))
        _LOGGER.info("Saved vocoder checkpoint at step %s to %s", step, out_dir)

    rng = np.random.default_rng(args.seed)
    history = []
    step = 0
    t0 = time.time()
    try:
        while step < args.steps:
            audio = to_device(_sample_batch(rng, corpus, args.batch_size, seg_samples, up), device)
            state, metrics = train_step(state, {"mels": make_mels(audio), "audio": audio})
            step += 1
            history.append(metrics)
            if step % 10 == 0:
                _LOGGER.info("step %s d %.4f g %.4f (mel_l1 %.4f) %.2f steps/s", step,
                             float(metrics["d_loss"]), float(metrics["g_loss"]),
                             float(metrics["mel_l1"]), step / max(time.time() - t0, 1e-9))
            if step % args.checkpoint_every == 0:
                save(step)
    except KeyboardInterrupt:
        _LOGGER.info("Interrupted")
    finally:
        save(step)
    return state, history


if __name__ == "__main__":
    main()
