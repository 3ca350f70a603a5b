"""myzkp_tpu_torch: the PyTorch + CUDA port of myzkp_tpu.

Importing the package has no side effects: it imports neither ``jax`` nor the
JAX package, builds nothing and starts nothing.  The CUDA kernels are built
from ``csrc/`` on first use (see ``_ext.py``).
"""

__version__ = "0.1.0"
