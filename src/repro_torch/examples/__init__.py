"""The reference's seven examples (``examples/*.py``), ported: the canonical
drives of the library's entry points.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Each module's ``main(argv=None) -> dict`` parses the reference example's
arguments plus ``--device`` (the card by default) and ``--seed`` (every
``torch.Generator`` and key derives from it), prints the reference's lines
and returns the numbers it printed.  The draws are the port's, not
threefry's, so only numbers that depend on a spectrum or a true rank (not
on one draw) match the reference example's.
"""

from __future__ import annotations

import argparse


def add_common_args(ap: argparse.ArgumentParser) -> None:
    """``--device`` and ``--seed``, which every example takes."""
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu, the plain PyTorch path")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds every torch.Generator and key of the run")
