"""``mfu_pct`` of the HOSVD cells, read the same way, as a metric of its own:
there it moves ``busy_ms.hosvd``, the end-to-end metric those cells keep
bounded (their host-paced rate and tail spread too widely to bound)."""

from bench.readers import load

read = load("mfu_pct")
