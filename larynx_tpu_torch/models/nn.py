"""Shared functional NN primitives, channels-last ([B, T, C]) layout.

Counterpart of ``larynx_tpu/models/nn.py``.  Activations keep the JAX
package's channels-last layout at every public boundary; weights are in
PyTorch's layout, converted once at load (``larynx_tpu_torch.weights``):
convs ``[C_out, C_in, k]``, transposed convs ``[C_in, C_out, k]`` and 1x1
projections ``[C_out, C_in]``.
"""

import functools
import typing

import torch
import torch.nn.functional as F

Params = typing.Dict[str, typing.Any]


def matmul1x1(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """Pointwise (1x1) conv: x [..., C_in], w [C_out, C_in], b [C_out]."""
    return F.linear(x, w, b)


def conv1d(
    x: torch.Tensor,
    w: torch.Tensor,
    b=None,
    dilation: int = 1,
    padding: typing.Optional[int] = None,
) -> torch.Tensor:
    """1-D convolution, channels-last: x [B, T, C_in], w [C_out, C_in, k].

    ``padding=None`` is torch-style 'same' for odd kernels:
    ``(k*d - d) // 2`` on both sides.
    """
    k = w.shape[-1]
    if padding is None:
        padding = (k * dilation - dilation) // 2
    y = F.conv1d(x.transpose(1, 2), w, b, padding=padding, dilation=dilation)
    return y.transpose(1, 2)


def conv_transpose1d(
    x: torch.Tensor, w: torch.Tensor, b=None, stride: int = 1, padding: int = 0
) -> torch.Tensor:
    """Transposed conv, channels-last: x [B, T, C_in], w [C_in, C_out, k].

    Output length ``(T - 1) * stride + k - 2 * padding``.
    """
    y = F.conv_transpose1d(x.transpose(1, 2), w, b, stride=stride, padding=padding)
    return y.transpose(1, 2)


def layer_norm(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-4
) -> torch.Tensor:
    """LayerNorm over the channel (last) axis with the reference's eps."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta


def sequence_mask(
    lengths: torch.Tensor, max_length: int, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """[B] lengths -> [B, max_length] {0,1} mask of ``dtype``."""
    pos = torch.arange(max_length, device=lengths.device, dtype=lengths.dtype)
    return (pos[None, :] < lengths[:, None]).to(dtype)


@functools.lru_cache(maxsize=None)
def bf16_value(v: float) -> float:
    """v rounded to the nearest bfloat16 number (0.1 -> 0.10009765625)."""
    return float(torch.tensor(v, dtype=torch.bfloat16))


def leaky_relu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    """x, or x * slope below zero.  In bfloat16 this is JAX's rounding: the
    slope is a bfloat16 number and the product x * bf16(slope), exact in
    float32, is rounded to bfloat16 (torch's ``x * 0.1`` would round x *
    0.1 and differ on ~10% of negative values)."""
    if x.dtype == torch.bfloat16:
        return F.leaky_relu(x, bf16_value(slope))
    return torch.where(x >= 0, x, x * slope)
