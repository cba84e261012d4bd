"""Token data of the port (``repro.data``)."""
from repro_torch.data.pipeline import (
    MemmapTokens,
    SyntheticLM,
    make_batch_iterator,
)

__all__ = ["MemmapTokens", "SyntheticLM", "make_batch_iterator"]
