"""Device selection for the PyTorch port.

Entry points take a ``device`` argument that defaults to ``"cuda"``.  The
CPU is used only when a caller asks for it (the tests do); asking for
``"cuda"`` on a machine without a card raises instead of falling back.

Importing this module pins float32 matrix products to full precision:
TF32 keeps about three decimal digits, and reduced-precision passes were
measured to wreck this plant's window solves (early course-window
violations rose from ~0.01 to 38-56 under bf16 passes).
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    no card is present."""
    dev = torch.device(device if device is not None else DEFAULT_DEVICE)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


def matmul_precision() -> str:
    """The float32 matmul precision in force (reported by the bench)."""
    return torch.get_float32_matmul_precision()
