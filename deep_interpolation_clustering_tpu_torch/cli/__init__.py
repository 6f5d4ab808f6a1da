"""CLI entry points of the port (counterparts of the JAX package's):

    python -m deep_interpolation_clustering_tpu_torch.cli.p1
"""
