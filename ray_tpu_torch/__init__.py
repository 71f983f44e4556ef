"""ray_tpu_torch — the PyTorch and CUDA port of ray_tpu's compute plane.

Each module mirrors the path of its counterpart in ``ray_tpu/`` (for
example ``ray_tpu_torch/ops/attention.py`` ← ``ray_tpu/ops/attention.py``).
The package imports ``torch``, ``numpy`` and the standard library only:
nothing of JAX, flax or ``ray_tpu``. Every Pallas TPU kernel on a ported
path is a CUDA C++ kernel under ``csrc/``, built for ``sm_90a`` at first
use (``ray_tpu_torch.native``). Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``, where each kernel's plain PyTorch version
runs instead.
"""
