"""PyTorch / CUDA port of lfr_tpu for one NVIDIA H100.

A second package beside ``lfr_tpu`` (the JAX reference, left unchanged).
It imports ``torch``, numpy, scipy and the standard library only.  Entry
points take ``device=`` and default to ``"cuda"``; the plain PyTorch
versions of the hand-written kernels run when the caller passes
``device="cpu"``.  ``python -m lfr_tpu_torch`` lists the commands.
"""
