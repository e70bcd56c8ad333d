"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper (H100).

Module names mirror ``repro`` so each piece has an obvious counterpart:
``repro_torch.models.model`` ports ``repro.models.model``, and so on. The
package imports torch, numpy and the standard library only — never jax and
nothing from ``repro`` — and keeps its own copies of the numpy planner code
it needs.

Entry points default to ``device="cuda"``; pass ``device="cpu"`` to run the
plain PyTorch versions of the kernels (the tests do). A kernel wrapper given
a CUDA tensor launches its hand-written kernel or raises; it never falls
back to the plain version.
"""
