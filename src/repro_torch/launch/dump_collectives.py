"""Debug tool: list the largest collectives of one cell (port of
``repro/launch/dump_collectives.py``).

    PYTHONPATH=src python -m repro_torch.launch.dump_collectives <arch> <shape> [n]

Runs the cell's step once on the (16, 16) production mesh as the dry run
does (``launch/dryrun.py``: rank 0 of a fake world, fake tensors) and
prints its ``n`` largest collectives (15 by default), grouped by kind, op,
caller and bytes a call, with their call counts.  An eager step runs each
layer's collectives once a layer, so the counts take the place of the
reference's while-loop trip scaling.
"""

from __future__ import annotations

import sys

from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import registry as R


def main(argv=None) -> list[dict]:
    argv = sys.argv[1:] if argv is None else argv
    arch, shape_name = argv[0], argv[1]
    top_n = int(argv[2]) if len(argv) > 2 else 15
    cfg = R.get_arch(arch)
    row = DR.run_cell(cfg, DR.SHAPES[shape_name],
                      mesh_mod.make_production_mesh(), probe=False)
    rows = row["collective_calls"]
    print(f"{arch} x {shape_name}: mb={row['micro_batches']} total "
          f"{sum(r['total_bytes'] for r in rows) / 1e9:.1f} GB in "
          f"{sum(r['calls'] for r in rows)} calls")
    for r in rows[:top_n]:
        print(f"{r['total_bytes'] / 1e9:9.2f}GB x{r['calls']:4d} "
              f"{r['kind']:14s} {r['bytes'] / 1e6:10.2f}MB a call  "
              f"{r['op']}  {r['caller']}")
    return rows


if __name__ == "__main__":
    main()
