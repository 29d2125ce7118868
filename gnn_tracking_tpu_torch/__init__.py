"""PyTorch + CUDA port of ``gnn_tracking_tpu`` for NVIDIA Hopper (H100).

The package mirrors the JAX package's module paths and class names so each
module's counterpart is easy to find. Plain tensor code is PyTorch; every
kernel that the JAX package wrote in Pallas is a hand-written CUDA C++
kernel under ``csrc/``, built with ``nvcc`` at first use (``_build.py``).

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; a CPU tensor takes each kernel's plain PyTorch version.
"""

__version__ = "0.1.0"
