"""Precision specs: value/index storage dtypes as a dispatch axis.

SpMM is bandwidth-bound (the paper's central claim), and bytes are
dominated by per-nonzero value + index traffic — so halving element
sizes roughly doubles the bandwidth ceiling ``beta * AI``.  A
:class:`Precision` names the storage dtypes of a packed layout;
arithmetic always accumulates in fp32, so only memory traffic and
operand rounding change.

The tokens (``f32i32`` / ``bf16i32`` / ``bf16i16``) and the int16
sentinel rule are the reference package's; the dtypes are torch's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: Storage bytes per element for the value/index dtypes a layout may pack.
_VALUE_DTYPES = {"float32": 4, "bfloat16": 2}
_INDEX_DTYPES = {"int32": 4, "int16": 2}

#: Largest addressed extent a packed int16 index vector may cover.  The
#: packers reserve one sentinel slot equal to the extent itself, so the
#: extent — not just ``extent - 1`` — must be representable: extents up
#: to ``2**15 - 1`` are legal, ``2**15`` is not.
INT16_MAX_EXTENT = 2 ** 15 - 1


def int16_extent_ok(extent: int) -> bool:
    """True iff int16 indices may address ``extent`` positions."""
    return 0 <= int(extent) <= INT16_MAX_EXTENT


@dataclasses.dataclass(frozen=True)
class Precision:
    """Value/index storage precision of a packed sparse layout.

    Dtypes are held as strings so the spec is hashable (cache keys),
    comparable, and JSON-serializable without dtype imports.
    """

    value_dtype: str = "float32"   # "float32" | "bfloat16"
    index_dtype: str = "int32"     # "int32" | "int16"

    def __post_init__(self):
        if self.value_dtype not in _VALUE_DTYPES:
            raise ValueError(
                f"value_dtype must be one of {sorted(_VALUE_DTYPES)}, "
                f"got {self.value_dtype!r}")
        if self.index_dtype not in _INDEX_DTYPES:
            raise ValueError(
                f"index_dtype must be one of {sorted(_INDEX_DTYPES)}, "
                f"got {self.index_dtype!r}")

    @property
    def sizeof_val(self) -> int:
        """Bytes per stored value element."""
        return _VALUE_DTYPES[self.value_dtype]

    @property
    def sizeof_idx(self) -> int:
        """Bytes per stored index element."""
        return _INDEX_DTYPES[self.index_dtype]

    @property
    def value_torch(self) -> torch.dtype:
        """The value dtype as a torch dtype."""
        return torch.bfloat16 if self.value_dtype == "bfloat16" \
            else torch.float32

    @property
    def index_np(self):
        """The index dtype as a numpy dtype object."""
        return np.int16 if self.index_dtype == "int16" else np.int32

    @property
    def eps(self) -> float:
        """Machine epsilon of the value dtype (tolerance scaling)."""
        return float(torch.finfo(self.value_torch).eps)

    @property
    def reduced(self) -> bool:
        """True when values are stored below fp32."""
        return self.value_dtype != "float32"

    @property
    def token(self) -> str:
        """Short stable name (cache keys, CSV ``dtype`` column)."""
        v = "bf16" if self.value_dtype == "bfloat16" else "f32"
        i = "i16" if self.index_dtype == "int16" else "i32"
        return f"{v}{i}"

    def index_ok(self, extent: int) -> bool:
        """True iff this spec's index dtype can address ``extent``."""
        return self.index_dtype == "int32" or int16_extent_ok(extent)


#: The canonical points on the precision axis the dispatcher enumerates.
PRECISION_FP32 = Precision("float32", "int32")
PRECISION_BF16 = Precision("bfloat16", "int16")
PRECISION_BF16_I32 = Precision("bfloat16", "int32")
DEFAULT_PRECISION = PRECISION_FP32
PRECISIONS = (PRECISION_FP32, PRECISION_BF16_I32, PRECISION_BF16)

_PRECISION_ALIASES = {
    "f32": PRECISION_FP32, "fp32": PRECISION_FP32,
    "float32": PRECISION_FP32, "f32i32": PRECISION_FP32,
    "bf16": PRECISION_BF16, "bfloat16": PRECISION_BF16,
    "bf16i16": PRECISION_BF16, "bf16i32": PRECISION_BF16_I32,
}


def as_precision(spec) -> Precision:
    """Coerce a user-facing precision argument to a :class:`Precision`.

    Accepts a ``Precision``, ``None`` (the fp32 default), or a short
    string token (``"fp32"``, ``"bf16"``, ``"bf16i32"``, ``"bf16i16"``).
    """
    if spec is None:
        return DEFAULT_PRECISION
    if isinstance(spec, Precision):
        return spec
    if isinstance(spec, str):
        try:
            return _PRECISION_ALIASES[spec.lower()]
        except KeyError:
            raise ValueError(
                f"unknown precision {spec!r}; expected one of "
                f"{sorted(_PRECISION_ALIASES)}") from None
    raise TypeError(f"cannot interpret {spec!r} as a Precision")
