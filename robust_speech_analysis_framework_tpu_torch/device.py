"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a torch.device; raises if CUDA is asked for and absent.

    Entry points default to ``"cuda"`` and never carry on quietly on the CPU:
    the CPU runs only when the caller asks for it.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but torch.cuda.is_available() is False; pass "
                "device='cpu' to run the plain PyTorch path on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
