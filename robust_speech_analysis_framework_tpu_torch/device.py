"""Device selection for the port's entry points."""

from __future__ import annotations

import contextlib
from typing import Iterator, Union

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


@contextlib.contextmanager
def fp32_convs() -> Iterator[None]:
    """Run the enclosed cuDNN convolutions in IEEE float32, whatever the
    process-wide setting (torch lets cuDNN convolutions use TF32 by default),
    and restore the caller's setting on exit.

    The port's results are held to the CPU and to the JAX reference in
    float32, so its precision is its own decision. Only torch's
    ``fp32_precision`` API is used: mixing it with the legacy
    ``allow_tf32`` flags makes torch raise when the legacy flag is read.
    """
    conv = torch.backends.cudnn.conv
    saved = conv.fp32_precision
    conv.fp32_precision = "ieee"
    try:
        yield
    finally:
        conv.fp32_precision = saved
