"""The paper's own experiment configuration (Tables III-V), field for field
as the reference package has it.

It names the generated matrix suite's scale
(``repro_torch.core.patterns.paper_suite``), the dense widths d, the seven
implementations compared (each a registry format with a ``torch`` and a
``cuda`` spec), the BCSR block edge, the value dtype, the timing repeats
(the minimum is reported) and the hub fraction of the scale-free model.

The defaults are the reference's, which sized them for a CPU host: at
n = 2**16 the working sets of B and C at d = 64 (16 MB each in fp32)
exceed a host's last-level cache.  On the H100 "out of cache" means
beyond the 50 MB L2 (``repro_torch.core.hardware.H100_L2_BYTES``), so at
d = 64 in fp32 the suite needs ``scale >= 18`` (B and C 64 MB each); a
run on the card passes that scale to ``paper_suite`` itself.
"""
import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SpMMExperimentConfig:
    scale: int = 16                  # log2(n) for the generated suite
    d_values: Tuple[int, ...] = (1, 4, 16, 64)
    implementations: Tuple[str, ...] = ("csr", "ell", "bcsr", "dia",
                                        "binned", "rowsplit", "ell_coo")
    bcsr_block: int = 64             # t for the CSB-analogue
    dtype: str = "float32"           # the paper uses float64
    repeats: int = 5                 # timing repeats (min is reported)
    hub_fraction: float = 0.001      # paper: f = 0.1% of nodes


CONFIG = SpMMExperimentConfig()
