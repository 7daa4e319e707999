"""Device selection for the port's entry points, and the precision of its
convolutions."""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

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


def conv1d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
           cdt: torch.dtype, **kwargs) -> torch.Tensor:
    """``F.conv1d`` with operands and result in ``cdt`` (Flax's ``Conv(dtype=)``),
    float32 convolutions in IEEE float32 (:func:`fp32_convs`).

    oneDNN's bfloat16 grouped convolution on the CPU is wrong (torch 2.13:
    cosine 0.07 against float32 at the positional conv's shape), so a
    bfloat16 convolution on the CPU takes ATen's own kernel.
    """
    args = (x.to(cdt), weight.to(cdt), None if bias is None else bias.to(cdt))
    avoid_onednn = x.device.type == "cpu" and cdt == torch.bfloat16
    with fp32_convs(), (_onednn_off() if avoid_onednn else contextlib.nullcontext()):
        return torch.nn.functional.conv1d(*args, **kwargs)


@contextlib.contextmanager
def _onednn_off() -> Iterator[None]:
    saved = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = saved
