"""Small helpers of the port (``repro.utils``): the parameter-tree algebra
the task-generic driver and the tree optimizers need (``pytree``)."""
from repro_torch.utils.pytree import tree_dot, tree_l2_norm, tree_map

__all__ = ["tree_dot", "tree_l2_norm", "tree_map"]
