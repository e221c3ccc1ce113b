"""PyTorch/CUDA port of ``from_ddpm_to_stable_diffusion_tpu`` for one NVIDIA H100.

The JAX package beside this one is the reference: each module here mirrors
a module of it by name and public function names, keeps its layouts (NHWC
images and latents, (B, H, L, D) attention) and is held against it by the
``tests/test_torch_*.py`` parity tests. Every Pallas kernel on a ported path
is a hand-written CUDA kernel under ``csrc/``, built at first use
(:mod:`.ops._build`); on CPU tensors each kernel wrapper runs its plain
PyTorch version instead.

This package imports ``torch`` and never ``jax``.
"""
