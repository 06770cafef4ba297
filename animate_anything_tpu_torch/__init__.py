"""animate_anything_tpu_torch — the PyTorch/CUDA port of animate_anything_tpu.

The JAX package stays the reference. This package mirrors its sub-package
and module names (core/, diffusion/, ops/, models/, pipelines/, utils/) and
its layouts at public functions: UNet input (b, f, h, w, c), the fused
spatial batch (b·f, h, w, c), transformer rows (n, s, c). Module parameter
names follow the diffusers key layout, so a JAX param tree exported by
``utils/convert.py`` loads with ``load_state_dict(strict=True)``.

Every Pallas kernel on the image-to-video path has a hand-written Hopper
kernel under ``csrc/``; its Python wrapper runs the plain PyTorch version for
CPU tensors and the kernel (or an error) for CUDA tensors.
"""

__version__ = "0.1.0"
