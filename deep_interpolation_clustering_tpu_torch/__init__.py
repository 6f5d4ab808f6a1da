"""deep_interpolation_clustering_tpu_torch — the PyTorch/CUDA port of the
deep temporal interpolation-clustering framework.

The JAX package `deep_interpolation_clustering_tpu` is the reference this
port is held against; the layout and module names mirror it so each module
has a counterpart there. This package imports `torch` and nothing of the JAX
package. Kernels written by hand for Hopper (`csrc/*.cu`) are built with
`nvcc` at first use and launched only for tensors on a CUDA device; a tensor
on the CPU takes the kernel's plain PyTorch version.

Ported so far: the p1 pretraining step (batch inputs, SCI -> CCI -> biLSTM
encoder, biLSTM decoder -> CompressFC -> RBF push, heads, losses, clip and
amsgrad Adam) and a lean trainer around it.
"""

__version__ = "0.1.0"

from .config import Config
from . import info

__all__ = ["Config", "info", "__version__"]
