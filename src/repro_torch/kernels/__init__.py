"""Device dispatch (``dispatch``) and the hand-written Hopper kernels of the
port (``policy_infer``, ``decay_accum``, ``flat_update``, ``consensus_step``,
``consensus_gather``, ``topk_scatter``, ``wkv6``, ``swa_attention`` +
``csrc/``).

Kernels are built with ``nvcc`` at first use (``_build.load``), never at
import, so this package imports on a host without a card.
"""
