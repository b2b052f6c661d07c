"""Device choice for the port's entry points.

Entry points run on the GPU unless the caller names another device.  With
no GPU they raise, whether the device is left to them or named as CUDA: a
run never continues quietly on the CPU, and a server never starts that
would fail every request.
"""

import typing

import numpy as np
import torch


def resolve_device(device: typing.Union[str, torch.device, None] = None) -> torch.device:
    """``None`` -> ``cuda``; anything else is taken as the caller's choice.
    A CUDA device with no GPU present raises."""
    resolved = torch.device("cuda" if device is None else device)
    if resolved.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "larynx_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU explicitly"
        )
    return resolved


def to_device(arr: np.ndarray, device: typing.Union[str, torch.device]) -> torch.Tensor:
    """A host array as a tensor on ``device``.  On CUDA it goes through
    pinned memory by a non-blocking copy: a copy from pageable memory would
    wait for everything queued on the stream, which stalls the host behind
    the card between launches."""
    tensor = torch.from_numpy(np.ascontiguousarray(arr))
    if torch.device(device).type == "cuda":
        return tensor.pin_memory().to(device, non_blocking=True)
    return tensor.to(device)
