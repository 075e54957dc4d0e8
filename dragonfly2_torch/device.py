"""Device and dtype policy: counterpart of ``default_compute_dtype`` in the
reference's ``models/mlp.py``.

On CUDA, matmul inputs are rounded to bfloat16 and products accumulate in
float32 (the reference's ``preferred_element_type=float32``); on the CPU
everything is float32. TF32 is switched off for matmuls and cuDNN so a
float32 product on the card is a float32 product.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    the process has no card (never carries on on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False;"
            " pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def compute_dtype(device: "str | torch.device") -> torch.dtype:
    """bfloat16 matmul inputs on the card, float32 on the CPU."""
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32


def matmul_f32acc(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``a @ b`` with both inputs rounded to ``dtype`` and the products
    summed in float32 — ``jnp.dot(..., preferred_element_type=float32)``.
    A bfloat16 product is exact in float32, so upcasting the rounded
    inputs and multiplying in float32 (TF32 off) reproduces it; a
    bfloat16-output matmul would round the sum as well."""
    return a.to(dtype).float() @ b.to(dtype).float()
