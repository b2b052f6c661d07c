"""Acoustic-model training CLI: ``python -m larynx_tpu_torch.train``.

Counterpart of ``larynx_tpu/train.py`` for the GlowTTS family, on one
device (``--device``, default ``cuda``): maximum-likelihood training with
monotonic alignment search, from an LJSpeech-style corpus (``metadata.csv``
+ a wav dir) to a voice dir that both packages load (``config.json``,
``phonemes.txt``, ``generator.npz`` in the native layout).  The flags are
the JAX CLI's.  The saved checkpoint's invertible 1x1 inverses are
recomputed from the trained weights: training moves ``weight`` and leaves
``weight_inv`` without a gradient.  ``--resume`` loads parameters only:
the optimizer and the learning-rate schedule start again, as in the JAX
trainer.  Not ported yet (ROADMAP): ``--family tacotron2`` and a model
axis (``--model-parallel`` above 1).
"""

import argparse
import json
import logging
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from larynx_tpu_torch.audio import AudioSettings
from larynx_tpu_torch.convert.native import load_params, save_params
from larynx_tpu_torch.device import resolve_device
from larynx_tpu_torch.models.glow_tts import config_from_voice_json
from larynx_tpu_torch.models.glow_tts.data import Dataset
from larynx_tpu_torch.models.glow_tts.training import actnorm_ddi_init
from larynx_tpu_torch.parallel.train import (
    batch_to,
    init_train_state,
    make_optimizer,
    make_train_step,
)
from larynx_tpu_torch.text.ids import load_phoneme_ids
from larynx_tpu_torch.weights import init_params, params_from_jax, params_to_jax

_LOGGER = logging.getLogger("larynx_tpu_torch.train")


def get_args(argv=None):
    parser = argparse.ArgumentParser(prog="larynx-tpu-torch.train")
    parser.add_argument(
        "--family", choices=("glow_tts", "tacotron2"), default="glow_tts",
        help="Acoustic-model family to train (default: glow_tts; tacotron2 is not ported yet)",
    )
    parser.add_argument("--metadata", required=True, help="metadata.csv (id|text)")
    parser.add_argument("--wav-dir", required=True, help="Directory of <id>.wav files")
    parser.add_argument(
        "--output-dir", required=True,
        help="Voice dir to write (generator.npz/config.json/phonemes.txt)",
    )
    parser.add_argument("--config", help="Voice config.json to train with (defaults: harvard dims)")
    parser.add_argument("--phonemes", required=True,
                        help="phonemes.txt (id<space>phoneme per line)")
    parser.add_argument("--language", default="en-us")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--warmup-steps", type=int, default=4000)
    parser.add_argument(
        "--learning-rate", type=float, default=1e-3,
        help="Peak learning rate (tacotron2 family; NVIDIA default 1e-3)",
    )
    parser.add_argument("--grad-clip", type=float, default=5.0)
    parser.add_argument("--max-id-len", type=int, default=192)
    parser.add_argument("--max-mel-len", type=int, default=1024)
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument(
        "--model-parallel", type=int, default=None,
        help="Model axis size (one device: 1; a larger mesh is not ported yet)",
    )
    parser.add_argument("--checkpoint-every", type=int, default=1000, help="Steps between saves")
    parser.add_argument("--resume", help="generator.npz to resume from")
    parser.add_argument(
        "--ddi", action="store_true", help="Data-dependent ActNorm init from the first batch"
    )
    parser.add_argument(
        "--device", default="cuda",
        help="Device to train on (default: cuda; a CUDA device with no GPU raises)",
    )
    parser.add_argument("--debug", action="store_true")
    return parser.parse_args(argv)


def save_voice_params(path: Path, params) -> None:
    """The port's GlowTTS params as a native ``generator.npz``, every
    ``invconv.weight_inv`` recomputed as inv(weight) in float64."""
    tree = params_to_jax(params, "glow_tts")
    invconv = tree["decoder"]["invconv"]
    invconv["weight_inv"] = np.linalg.inv(invconv["weight"].astype(np.float64)).astype(np.float32)
    save_params(path, tree)


def main(argv=None):
    """Train; returns the final train state and every step's metrics
    (device scalars)."""
    args = get_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.debug else logging.INFO)
    if args.family == "tacotron2":
        raise NotImplementedError(
            "--family tacotron2: Tacotron2 training is not ported yet (ROADMAP, modules to port: "
            "WaveGlow and Tacotron2 training)")
    if args.model_parallel not in (None, 1):
        raise NotImplementedError(
            "--model-parallel: the training mesh is not ported yet (ROADMAP, modules to port: "
            "multi-GPU); the port trains on one device")
    device = resolve_device(args.device)
    # float32 convs and matmuls, as the port's inference CLI
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    if args.config:
        with open(args.config, encoding="utf-8") as f:
            raw_config = json.load(f)
    else:
        raw_config = {"audio": {}, "model": {}}
    known = set(AudioSettings.__dataclass_fields__)
    settings = AudioSettings(**{k: v for k, v in raw_config.get("audio", {}).items() if k in known})
    with open(args.phonemes, encoding="utf-8") as f:
        phoneme_to_id = load_phoneme_ids(f)

    dataset = Dataset(args.metadata, args.wav_dir, phoneme_to_id, settings, lang=args.language,
                      device=device)
    _LOGGER.info("Dataset: %s utterances; device %s", len(dataset), device)

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "config.json", "w", encoding="utf-8") as f:
        json.dump(raw_config, f, indent=2)
    shutil.copyfile(args.phonemes, out_dir / "phonemes.txt")

    cfg = config_from_voice_json(raw_config)
    if args.resume:
        params = params_from_jax(load_params(args.resume), "glow_tts", device)
        _LOGGER.info("Resumed parameters from %s (parameters only: the optimizer and the "
                     "learning-rate schedule start again at step 0)", args.resume)
    else:
        params = params_from_jax(
            init_params(torch.Generator().manual_seed(args.seed), cfg), "glow_tts", device)

    optimizer = make_optimizer(cfg, warmup_steps=args.warmup_steps, grad_clip=args.grad_clip)
    batch_kwargs = dict(max_id_len=args.max_id_len, max_mel_len=args.max_mel_len)
    if args.ddi and not args.resume:
        first = next(dataset.batches(args.batch_size, shuffle_seed=args.seed, **batch_kwargs), None)
        if first is not None:
            _LOGGER.info("Running data-dependent ActNorm init")
            b = batch_to(first, device)
            params = actnorm_ddi_init(params, cfg, b["mels"], b["mel_lengths"])
    state = init_train_state(params, optimizer)
    train_step = make_train_step(cfg, optimizer)

    def save(step: int):
        save_voice_params(out_dir / "generator.npz", state.params)
        _LOGGER.info("Saved checkpoint at step %s to %s", step, out_dir)

    history = []
    step = 0
    try:
        for epoch in range(args.epochs):
            epoch_start = time.time()
            losses = []
            for batch in dataset.batches(args.batch_size, shuffle_seed=args.seed + epoch,
                                         **batch_kwargs):
                state, metrics = train_step(state, batch)
                step += 1
                history.append(metrics)
                # metrics stay on the device: a float() per step would wait
                # for the step
                losses.append(metrics["loss"])
                if step % 10 == 0:
                    _LOGGER.info("step %s loss %.4f (mle %.4f dur %.4f)", step,
                                 float(metrics["loss"]), float(metrics["mle_loss"]),
                                 float(metrics["duration_loss"]))
                if step % args.checkpoint_every == 0:
                    save(step)
            _LOGGER.info("epoch %s done in %.1fs mean loss %.4f", epoch, time.time() - epoch_start,
                         float(torch.stack(losses).mean()) if losses else float("nan"))
    except KeyboardInterrupt:
        _LOGGER.info("Interrupted")
    finally:
        save(step)
    return state, history


if __name__ == "__main__":
    main()
