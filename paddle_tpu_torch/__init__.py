"""PyTorch/CUDA port of ``paddle_tpu``, built for one NVIDIA H100.

The package mirrors ``paddle_tpu``'s module paths, so
``paddle_tpu_torch/X.py`` is the counterpart of ``paddle_tpu/X.py`` and
is tested against it on the same inputs.  It imports ``torch``, numpy
and the standard library only: never ``jax``, never ``paddle_tpu``.

What it covers so far: Transformer training through ``fluid`` (float32
and the bf16 recipe), the LSTM text classifiers, the book's first two
chapters, and the paged serving path, the Transformer served by
``serving.PagedTransformerGenerator`` (its Fluid programs run through
``fluid.Executor``; greedy and beam search) behind
``serving.ContinuousBatchingScheduler``, with the dense
``serving.TransformerGenerator`` and ``FullRerunDecoder`` beside it.
Every TPU kernel of ``paddle_tpu`` has a CUDA C++ counterpart for
``sm_90a`` under ``kernels/csrc/``, built at first use.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``device="cpu"``, ``fluid.CPUPlace()``, a generator's
``place=fluid.CPUPlace()``); without a GPU they raise instead of
falling back (``device.py``).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
