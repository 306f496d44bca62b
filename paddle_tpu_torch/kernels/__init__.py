"""Kernels of the port.  ``flash_attention.ragged_decode_attention`` is
the serving path's paged attention: a CUDA C++ kernel for ``sm_90a``
(``csrc/ragged_paged_attention.cu``, built by ``_build``) on CUDA tensors,
its plain PyTorch version on CPU tensors."""
