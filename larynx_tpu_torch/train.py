"""Acoustic-model training CLI: ``python -m larynx_tpu_torch.train``.

Counterpart of ``larynx_tpu/train.py``, from an LJSpeech-style corpus
(``metadata.csv`` + a wav dir) to a voice dir that both packages load
(``config.json``, ``phonemes.txt``, ``generator.npz`` in the native
layout).  The flags are the JAX CLI's.  ``--resume`` loads parameters
only, on every rank: the optimizer and the learning-rate schedule start
again, as in the JAX trainer, and the log says so.  An empty phoneme table
fails before the output dir is written.

One process trains on ``--device`` (default ``cuda``).  On N devices,
``python -m torch.distributed.run --nproc-per-node N -m
larynx_tpu_torch.train ...`` starts one process per device
(``parallel/mesh.py::make_mesh``: ``cuda:{LOCAL_RANK}`` unless
``--device`` names an index, NCCL on CUDA, gloo on the CPU), on a (data,
model) grid with ``--model-parallel`` model ranks (default JAX's: 2 on an
even world above 1).  Every rank builds the same global batch and takes
its rows; GlowTTS's encoder is tensor parallel over the model ranks
(``--model-parallel`` must divide its heads and filter channels), and
Tacotron2 repeats its data rank's work on them, as JAX replicates it.
Rank 0 alone writes the output dir and logs; the saved GlowTTS params are
gathered from the model ranks into the single-device layout first.

* ``--family glow_tts``: maximum-likelihood training with monotonic
  alignment search.  The saved invertible 1x1 inverses are recomputed from
  the trained weights: training moves ``weight`` and leaves ``weight_inv``
  without a gradient.
* ``--family tacotron2``: teacher forcing
  (``models/tacotron2/training.py``), a global-norm clip and AdamW (weight
  decay 1e-6) at a linear warmup to ``--learning-rate``; ``num_symbols`` is
  sized from the phoneme table into the written ``config.json``.  Name the
  output dir ``<voice>-tacotron2`` for the loaders to route it.
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
from larynx_tpu_torch.models.glow_tts import config_from_voice_json
from larynx_tpu_torch.models.glow_tts.data import Dataset
from larynx_tpu_torch.models.glow_tts.training import actnorm_ddi_init
from larynx_tpu_torch.models.tacotron2 import training as t2_training
from larynx_tpu_torch.models.tacotron2.config import tacotron2_config_from_voice_json
from larynx_tpu_torch.parallel.mesh import (
    check_model_parallel,
    gather_params,
    is_rank0,
    make_mesh,
    shard_params,
)
from larynx_tpu_torch.parallel.train import (
    LOG_EVERY,
    MetricHistory,
    Optimizer,
    batch_to,
    data_sum,
    init_train_state,
    linear_schedule,
    local_rows,
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
        help="Acoustic-model family to train (default: glow_tts)",
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
        help="Model axis size under torchrun (default: 2 on an even world above 1, else 1)",
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


RESUMED = ("Resumed parameters from %s (parameters only: the optimizer and the learning-rate "
           "schedule start again at step 0)")


def _epochs(args, dataset, train_step, history: MetricHistory, save, log_line):
    """The trainers' loop: ``args.epochs`` passes over the dataset's
    batches, ``train_step(batch, step)`` -> metrics, a log line every
    LOG_EVERY steps (``log_line(step, last metrics)``), a save every
    ``--checkpoint-every`` steps and at the end or an interrupt.  Each
    epoch's mean loss is read from the history (flushed, over the data
    group on a mesh, at the epoch's end)."""
    step = 0
    try:
        for epoch in range(args.epochs):
            epoch_start = time.time()
            first = step
            for batch in dataset.batches(args.batch_size, max_id_len=args.max_id_len,
                                         max_mel_len=args.max_mel_len,
                                         shuffle_seed=args.seed + epoch):
                metrics = train_step(batch, step)
                step += 1
                history.append(metrics)
                if step % LOG_EVERY == 0:
                    log_line(step, history.flush())
                if step % args.checkpoint_every == 0:
                    save(step)
            history.flush()
            losses = [m["loss"] for m in history.steps[first:]]
            _LOGGER.info("epoch %s done in %.1fs mean loss %.4f", epoch, time.time() - epoch_start,
                         float(np.mean(losses)) if losses else float("nan"))
    except KeyboardInterrupt:
        _LOGGER.info("Interrupted")
    finally:
        history.flush()
        save(step)


def _train_tacotron2(args, raw_config, dataset, mesh, out_dir: Path):
    """``--family tacotron2`` (``larynx_tpu/train.py::_train_tacotron2``)."""
    device = mesh.device
    cfg = tacotron2_config_from_voice_json(raw_config)
    optimizer = Optimizer(linear_schedule(0.0, args.learning_rate, max(args.warmup_steps, 1)),
                          grad_clip=args.grad_clip, clip="global_norm", weight_decay=1e-6)
    if args.resume:
        params = params_from_jax(load_params(args.resume), "tacotron2", device)
        _LOGGER.info("Resumed parameters from %s (parameters only: the linear warmup and Adam's "
                     "moments start again at step 0)", args.resume)
    else:
        params = params_from_jax(
            init_params(torch.Generator().manual_seed(args.seed), cfg), "tacotron2", device)
    state = t2_training.init_train_state(params, optimizer)
    step_fn = t2_training.make_train_step(cfg, optimizer, mesh)

    def train_step(batch, step):
        bsz, t = batch["ids"].shape
        masks = t2_training.draw_train_masks(cfg, bsz, t, batch["mels"].shape[1], args.seed + 1,
                                             step, device)
        return step_fn(state, batch, masks)[1]

    def save(step: int):
        if mesh.rank == 0:
            save_params(out_dir / "generator.npz", params_to_jax(state.params, "tacotron2"))
            _LOGGER.info("Saved checkpoint at step %s to %s", step, out_dir)

    def log_line(step, m):
        _LOGGER.info("step %s loss %.4f (mel %.4f/%.4f gate %.4f)", step, m["loss"],
                     m["mel_pre"], m["mel_post"], m["gate"])

    history = MetricHistory(mesh.data_group)
    _epochs(args, dataset, train_step, history, save, log_line)
    return state, history.steps


def main(argv=None):
    """Train; returns the final train state (on a mesh, this rank's) and
    every step's metrics as host floats."""
    args = get_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.debug else
                        logging.INFO if is_rank0() else logging.WARNING)
    mesh = make_mesh(args.model_parallel, device=args.device)
    try:
        return _main(args, mesh)
    finally:
        mesh.close()


def _main(args, mesh):
    device = mesh.device
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
    if not phoneme_to_id:
        raise SystemExit(f"{args.phonemes}: no phonemes (expected 'id phoneme' lines)")

    dataset = Dataset(args.metadata, args.wav_dir, phoneme_to_id, settings, lang=args.language,
                      device=device)
    _LOGGER.info("Dataset: %s utterances; device %s; mesh: data %s, model %s", len(dataset),
                 device, mesh.n_data, mesh.model_parallel)

    if args.family == "tacotron2":
        # the symbol table sized from the phoneme set, so that the written
        # config.json reloads the trained geometry
        raw_config.setdefault("model", {}).setdefault("num_symbols",
                                                      max(phoneme_to_id.values()) + 1)
    out_dir = Path(args.output_dir)
    if mesh.rank == 0:
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_dir / "config.json", "w", encoding="utf-8") as f:
            json.dump(raw_config, f, indent=2)
        shutil.copyfile(args.phonemes, out_dir / "phonemes.txt")
    if args.family == "tacotron2":
        return _train_tacotron2(args, raw_config, dataset, mesh, out_dir)

    cfg = config_from_voice_json(raw_config)
    check_model_parallel(cfg, mesh.model_parallel)
    if args.resume:
        params = params_from_jax(load_params(args.resume), "glow_tts", device)
        _LOGGER.info(RESUMED, args.resume)
    else:
        params = params_from_jax(
            init_params(torch.Generator().manual_seed(args.seed), cfg), "glow_tts", device)

    optimizer = make_optimizer(cfg, warmup_steps=args.warmup_steps, grad_clip=args.grad_clip)
    batch_kwargs = dict(max_id_len=args.max_id_len, max_mel_len=args.max_mel_len)
    if args.ddi and not args.resume:
        first = next(dataset.batches(args.batch_size, shuffle_seed=args.seed, **batch_kwargs), None)
        if first is not None:
            _LOGGER.info("Running data-dependent ActNorm init")
            b = batch_to(local_rows(first, mesh), device)
            params = actnorm_ddi_init(params, cfg, b["mels"], b["mel_lengths"],
                                      reduce=data_sum(mesh))
    state = init_train_state(shard_params(params, mesh), optimizer)
    step_fn = make_train_step(cfg, optimizer, mesh)

    def save(step: int):
        full = gather_params(state.params, mesh)  # every model rank takes part
        if mesh.rank == 0:
            save_voice_params(out_dir / "generator.npz", full)
            _LOGGER.info("Saved checkpoint at step %s to %s", step, out_dir)

    def log_line(step, m):
        _LOGGER.info("step %s loss %.4f (mle %.4f dur %.4f)", step, m["loss"], m["mle_loss"],
                     m["duration_loss"])

    history = MetricHistory(mesh.data_group)
    _epochs(args, dataset, lambda batch, _step: step_fn(state, batch)[1], history, save, log_line)
    return state, history.steps


if __name__ == "__main__":
    main()
