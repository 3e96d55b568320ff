"""The launch plans of the hand-written kernels, for the launch audit.

Each kernel wrapper's ``launch_grid(...)`` states, in plain Python, the
grid of its ``.cu`` launch line and the region of each output (or
workspace) that a block index writes.  ``repro_torch.analysis.launch_audit``
enumerates those plans to prove that no two blocks that may run at once
write the same element and that every element of an output is written.
"""

from __future__ import annotations

from typing import Callable, Hashable, NamedTuple, Optional


class Write(NamedTuple):
    """A region a block writes: ``region`` indexes the buffer (flattened
    where ``flat``).  Blocks that share a ``ticket`` write it once between
    them: the one that draws a grid row's last ticket."""
    buffer: str
    region: tuple
    ticket: Optional[Hashable] = None
    flat: bool = False


class Launch(NamedTuple):
    """One kernel launch: its grid (x, y, z as the launch line gives it)
    and the regions block ``idx`` writes (its blocks may run at once)."""
    kernel: str
    grid: tuple[int, ...]
    writes: Callable[[tuple[int, ...]], list[Write]]


class LaunchPlan(NamedTuple):
    """A wrapper's launches, in stream order, the shapes of the buffers
    they write and the buffers that must be written whole."""
    launches: tuple[Launch, ...]
    buffers: dict[str, tuple[int, ...]]
    covered: tuple[str, ...]
