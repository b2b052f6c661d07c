"""Device choice for the port's entry points.

Entry points run on the GPU unless the caller names another device.  With
no GPU and no explicit device they raise: a run never continues quietly on
the CPU.
"""

import typing

import torch


def resolve_device(device: typing.Union[str, torch.device, None] = None) -> torch.device:
    """``None`` -> ``cuda``; anything else is taken as the caller's choice."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "larynx_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU explicitly"
        )
    return torch.device("cuda")
