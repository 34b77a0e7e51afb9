"""Device resolution and hardware probes.

The port's entry points run on the GPU unless the caller asks for the
CPU: ``device`` defaults to ``"cuda"``, and a CUDA request on a machine
without CUDA raises instead of quietly running on the CPU (a CPU run
must never pass for a GPU run).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means ``"cuda"``,
    and a bare ``"cuda"`` becomes the current CUDA device (``cuda:N``, as
    tensors report it). Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA was asked for (the port's default device) but "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run the plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def is_sm90(device: Optional[torch.device] = None) -> bool:
    """True when ``device`` (default: the current CUDA device) is a
    Hopper part (compute capability 9.x), the target of the port's
    kernels."""
    if not torch.cuda.is_available():
        return False
    return torch.cuda.get_device_capability(device)[0] == 9
