"""Port of ``src/repro/utils/__init__.py``."""

from repro_torch.utils.tree import (
    tree_client_mean,
    tree_leaves,
    tree_map,
    tree_num_params,
    tree_zeros_like,
)

__all__ = ["tree_client_mean", "tree_leaves", "tree_map", "tree_num_params",
           "tree_zeros_like"]
