"""The LM of the ``dense`` and ``moe`` families with a global-attention
layer pattern: layers, attention, the MoE FFN on the grouped-matmul
kernel, and the model (``init_params``, ``LM``)."""
from repro_torch.models.model import LM, init_params

__all__ = ["LM", "init_params"]
