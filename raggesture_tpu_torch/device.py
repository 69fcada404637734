"""Where an entry point runs: the CUDA card unless the caller asks for the CPU."""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the CUDA card; without one this raises rather than
    carrying on on the CPU.  Any explicit device is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


@contextlib.contextmanager
def float32_products() -> Iterator[None]:
    """Within the block, float32 matmuls and convolutions on a CUDA card
    multiply in float32, not TF32 (cuDNN allows TF32 by default); the
    process's flags are restored on the way out."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
