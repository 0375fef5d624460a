"""Where the port puts data that comes from the host.

Constructors from host data (numpy arrays, lists, a :class:`CooBuilder`'s
buffers, a NetCDF file) put their tensors on the card unless the caller asks
for another device: :func:`default_device` is ``cuda``. On a machine without
CUDA such a call raises; it never falls back to the CPU quietly. Pass
``device="cpu"`` to build on the CPU. Tensors passed in stay where they
are, and ops follow the device of their operands.
"""

from __future__ import annotations

from typing import Any

import torch

__all__ = ["default_device", "resolve_device"]

DeviceLike = Any


def default_device() -> torch.device:
    """The device of data built from the host when ``device`` is None."""
    return torch.device("cuda")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a :class:`torch.device`; None means
    :func:`default_device`, which raises when CUDA is not available."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "spsparse_torch: host data goes to the CUDA card by default, but "
            "torch.cuda.is_available() is false; pass device='cpu' to build "
            "on the CPU")
    return default_device()
