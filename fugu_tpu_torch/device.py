"""The device the port runs on.

``resolve`` turns a device name into a ``torch.device`` that every
engine call receives explicitly.  Asking for CUDA on a machine without a
CUDA device raises: the port never falls back to the CPU on its own.
The CPU is used only when the caller asks for it by name (tests, and
small local runs), and then every kernel wrapper takes its plain
PyTorch version.
"""

from __future__ import annotations

from typing import Union

import torch


def resolve(spec: Union[str, torch.device] = "cuda") -> torch.device:
    """``torch.device`` for ``spec`` ("cuda", "cuda:N" or "cpu").

    CUDA devices come back with an explicit index, so that a device
    compares equal to the ``.device`` of the tensors placed on it."""
    dev = torch.device(spec)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {spec!r} requested but torch.cuda.is_available() "
                "is False"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {spec!r} (cuda or cpu)")
    return dev
