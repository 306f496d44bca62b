"""Device resolution and the matmul precision of the port's entry points.

An entry point runs on the GPU unless its caller asks for the CPU by
name.  With no GPU and no such request it raises: a serving run that
silently dropped to the CPU would report CPU numbers under a device's
name.  The CPU is for the tests, which compare the port with the JAX
package through the kernels' plain PyTorch versions.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the current CUDA device.  Raises RuntimeError when
    CUDA is asked for (or implied) and no GPU is present, and ValueError
    for a device type the port does not run on."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch: no CUDA device is available; pass "
                "device='cpu' to run the plain PyTorch path explicitly")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"paddle_tpu_torch runs on 'cuda' or 'cpu', "
                         f"not {dev.type!r}")
    # float32 means float32 on the card: no TF32 in matrix products or
    # cuDNN convolutions (TF32 keeps about three decimal digits, which
    # would move logits beyond the tolerances the port is held to)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # a bf16 matrix product accumulates in float32 to the end, as the
    # reference's (preferred_element_type=float32): cuBLAS may otherwise
    # round split-K partial sums to bf16 before adding them
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    return dev
