"""Data parallelism and spatial sharding over ``torch.distributed`` process
groups (counterpart of ``parallel/`` in the JAX package)."""

from .mesh import DataMesh, make_data_mesh, make_hybrid_data_mesh, make_mesh

__all__ = ["DataMesh", "make_data_mesh", "make_hybrid_data_mesh", "make_mesh"]
