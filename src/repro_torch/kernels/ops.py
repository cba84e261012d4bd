"""Tree-level wrappers over the kernels (``repro.kernels.ops``).

Only :func:`consensus_step_tree` has a use. The JAX module's other wrappers
(``wkv6``, ``swa_attention``, ``consensus_step``, ``decay_accum``) exist to
pick Pallas's interpret mode off the TPU; the port's ``dispatch`` already
routes by the tensors' device (the hand-written kernel on the card, the plain
version on the CPU), so they have no counterpart here.
"""
from __future__ import annotations

from repro_torch.kernels import dispatch


def consensus_step_tree(grads_m, mixing):
    """The gossip mix ``mixing @ G`` of a tree of ``(m, ...)`` grads: the
    leaves concatenated to one ``(m, n)`` matrix, one ``consensus_mix`` (one
    ``consensus_step`` launch on the card; fp32, no TF32), and split back
    into a new tree of the same layout."""
    flat, spec = dispatch.stacked_ravel_spec(grads_m)
    return spec.unravel(dispatch.consensus_mix(flat, mixing))
