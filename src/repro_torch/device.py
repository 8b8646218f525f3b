"""Device rule of the port: the card unless the caller asks for the CPU.

Entry points take ``device="cuda"`` by default and raise when no card is
present; nothing falls back to the CPU on its own. Scoring follows the
device of the tensors it is given (a CUDA tensor goes to the kernel, a
CPU tensor to the plain version).
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names a missing card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def is_dtensor(x) -> bool:
    """True for a ``torch.distributed.tensor.DTensor`` (a step sharded by
    ``parallel/spmd.py``), known by its type's name so that a check costs
    no import of the distributed package."""
    return type(x).__name__ == "DTensor"


def full_fp32_matmul() -> None:
    """Run float32 products in full float32 on the card (no TF32).

    The reference computes in full float32, and the exact integer-code
    products of the plain scoring path rely on it. The flag is process
    wide; the port only ever switches it off.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
