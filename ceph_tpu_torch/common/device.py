"""Device resolution for every entry point of the port.

Entry points take an explicit ``device`` and default to ``cuda``.  With
no card present that default raises: the port never carries on quietly
on the CPU.  Only a caller that names ``cpu`` runs there.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]

#: the device every entry point uses unless told otherwise
DEFAULT_DEVICE = "cuda"


def resolve_device(device: DeviceLike = DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and
    no card is present, or names a device type the port does not run on."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but no CUDA device is "
                f"available; pass device='cpu' to run on the host")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(dev)!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) exist")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r}: the port "
                         f"runs on 'cuda' or 'cpu'")
    return dev
