"""The paper's own experiment configurations (§5.1, §5.2).

The port's copy of ``repro/configs/paper_randnla.py``: the port imports
nothing of the reference package, so the dataclasses are repeated here.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class RSVDExperiment:
    n: int = 4096          # matrix size (paper §5.1.1)
    rank: int = 256        # target rank p
    oversample: int = 10   # s (fixed in §5.1)
    power_iters: int = 0
    s_p: float = 1e-4      # smallest prescribed singular value
    seeds: int = 10        # matrices per family


@dataclasses.dataclass(frozen=True)
class HOSVDExperiment:
    dims: tuple = (256, 256, 256)
    ranks: tuple = (32, 32, 32)
    pad: int = 2           # Algorithm 3 rank padding


PAPER_RSVD = RSVDExperiment()
PAPER_HOSVD = HOSVDExperiment()
