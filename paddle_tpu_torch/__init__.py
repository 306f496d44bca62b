"""PyTorch/CUDA port of ``paddle_tpu``, built for one NVIDIA H100.

The package mirrors ``paddle_tpu``'s module paths, so
``paddle_tpu_torch/X.py`` is the counterpart of ``paddle_tpu/X.py`` and
is tested against it on the same inputs.  It imports ``torch``, numpy
and the standard library only: never ``jax``, never ``paddle_tpu``.

What it covers so far is the paged serving path: the Transformer served
by ``serving.PagedTransformerGenerator`` behind
``serving.ContinuousBatchingScheduler``.  Its one TPU kernel, the
ragged paged-attention walk, is a CUDA C++ kernel for ``sm_90a``
(``kernels/csrc/ragged_paged_attention.cu``), built at first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU they raise instead of falling back (``device.py``).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
