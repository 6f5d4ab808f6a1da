"""deep_interpolation_clustering_tpu_torch — the PyTorch/CUDA port of the
deep temporal interpolation-clustering framework.

The JAX package `deep_interpolation_clustering_tpu` is the reference this
port is held against; the layout and module names mirror it so each module
has a counterpart there. This package imports `torch` and nothing of the JAX
package. Kernels written by hand for Hopper (`csrc/*.cu`) are built with
`nvcc` at first use and launched only for tensors on a CUDA device; a tensor
on the CPU takes the kernel's plain PyTorch version.

Ported so far: the p1, p2, p3 and p4 stages. p1's step (batch inputs, SCI ->
CCI -> biLSTM encoder, biLSTM decoder -> CompressFC -> RBF push, heads,
losses, clip and amsgrad Adam, SGD or RMSprop), its trainer (epochs with
validation, per-metric best checkpoints in the JAX npz format, early stop,
restore, feature dumps) and its entry point `python -m
deep_interpolation_clustering_tpu_torch.cli.p1`; p2's K selection (elbow,
gap statistic with the internal metrics, DBSCAN on the device and its
explorer, OPTICS on the host; `cli.p2`); p3's DEC head, KL and
triplet losses, k-means on the device and `ClusterTrainer` (`cli.p3`); p4's
alignment and final labels, DBSCAN's included (`cli.p4`); data-parallel and
multi-process runs on `torch.distributed` (`parallel/`: p1 and p3 under
`--data_parallel` and `--num_processes`, p2 and p4 under `--num_processes`).
"""

__version__ = "0.1.0"

from .config import Config
from . import info

__all__ = ["Config", "info", "__version__"]
