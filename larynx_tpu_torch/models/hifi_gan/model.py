"""HiFi-GAN generator: mel [B, T, n_mels] -> waveform [B, T * 256].

Counterpart of ``larynx_tpu/models/hifi_gan/model.py::generator``:
conv_pre -> per stage [leaky_relu -> transposed-conv upsample -> averaged
multi-receptive-field resblocks] -> leaky_relu(0.01) -> conv_post -> tanh.

Stages with C <= 128 run the whole section through
``ops.mrf_block.mrf_section``, one kernel launch per resblock unit on CUDA
(9 per universal_large stage), as the JAX package runs them through its
Pallas kernels; :func:`pack_params` packs
their weights once, at load.  Wider stages use plain
torch convs, as the JAX package uses XLA there.  The upsample is a plain
transposed conv: the JAX package's packed upsample only fills TPU lanes.
Params without ``"mrf"`` (unpacked: the GAN trainer's) run every stage as
torch convs under autograd, as the JAX package trains the generator
without its Pallas kernels; no loader reaches that path.

The generator runs in its params' dtype: float32, or bfloat16 (the JAX
engine's vocoder precision on an accelerator), where stage 1 and the
transposed convs are bfloat16 torch convs, every leaky-ReLU is JAX's
bfloat16 one (``models/nn.py``) and the MRF sections run the kernel's
bfloat16 instantiation.
"""

import typing

import torch

from larynx_tpu_torch.models.hifi_gan.config import HiFiGanConfig
from larynx_tpu_torch.models.nn import conv1d, conv_transpose1d, leaky_relu
from larynx_tpu_torch.ops.mrf_block import mrf_section, pack_mrf_stage
from larynx_tpu_torch.runtime import trace

Params = typing.Dict[str, typing.Any]

LRELU_SLOPE = 0.1


def _resblock1(p: Params, x: torch.Tensor, dilations) -> torch.Tensor:
    """3 x (lrelu -> dilated conv -> lrelu -> plain conv) residual."""
    for c1, c2, d in zip(p["convs1"], p["convs2"], dilations):
        xt = conv1d(leaky_relu(x, LRELU_SLOPE), c1["w"], c1["b"], dilation=d)
        xt = conv1d(leaky_relu(xt, LRELU_SLOPE), c2["w"], c2["b"])
        x = xt + x
    return x


def _resblock2(p: Params, x: torch.Tensor, dilations) -> torch.Tensor:
    """n x (lrelu -> dilated conv) residual."""
    for c, d in zip(p["convs"], dilations):
        x = conv1d(leaky_relu(x, LRELU_SLOPE), c["w"], c["b"], dilation=d) + x
    return x


def pack_params(params: Params, cfg: HiFiGanConfig) -> Params:
    """params plus ``"mrf"``: per stage, the :class:`MRFStage` that
    ``mrf_section`` takes where C <= 128, else None, packed in the params'
    dtype.  Call once, on the device and in the dtype the generator runs
    in."""
    nk = cfg.num_kernels
    stages = []
    for i, up in enumerate(params["ups"]):
        if up["w"].shape[1] > 128:  # transposed conv [C_in, C_out, k]
            stages.append(None)
            continue
        stages.append(pack_mrf_stage(
            params["resblocks"][i * nk : (i + 1) * nk],
            kernel_sizes=cfg.resblock_kernel_sizes,
            dilations_per_block=cfg.resblock_dilation_sizes,
            convs_per_unit=2 if cfg.resblock == "1" else 1,
        ))
    return dict(params, mrf=stages)


def generator(params: Params, cfg: HiFiGanConfig, mel: torch.Tensor) -> torch.Tensor:
    """mel [B, T, num_mels] -> audio [B, T * total_upsample]; ``params``
    from :func:`pack_params` (or unpacked, for training), mel in their
    dtype."""
    x = conv1d(mel, params["conv_pre"]["w"], params["conv_pre"]["b"], padding=3)
    nk = cfg.num_kernels
    dilations = tuple(tuple(d) for d in cfg.resblock_dilation_sizes)
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        x = leaky_relu(x, LRELU_SLOPE)
        up = params["ups"][i]
        x = conv_transpose1d(x, up["w"], up["b"], stride=u, padding=(k - u) // 2)
        stage = params["mrf"][i] if "mrf" in params else None
        if stage is not None:
            b, t, c = x.shape
            with trace.span("kernel.mrf_section", profile=False, B=b, T=t, C=c,
                            itemsize=x.element_size(),
                            kernel_sizes=stage.kernel_sizes,
                            dilations=stage.dilations_per_block,
                            convs_per_unit=stage.convs_per_unit):
                x = mrf_section(x.contiguous(), stage)
        else:
            acc = None
            for rb, ds in zip(params["resblocks"][i * nk : (i + 1) * nk], dilations):
                y = _resblock1(rb, x, ds) if cfg.resblock == "1" else _resblock2(rb, x, ds)
                acc = y if acc is None else acc + y
            x = acc / nk
    x = leaky_relu(x, 0.01)  # default torch leaky_relu slope in the reference
    x = conv1d(x, params["conv_post"]["w"], params["conv_post"]["b"], padding=3)
    return torch.tanh(x)[..., 0]
