"""``latency_p95_ms`` of the HOSVD cells, read the same way, reported per
layer: the host sets their pace, and its drift spreads the tail by 10-17 %
between runs, more than half of any bound the benchmark may set."""

from bench.readers import load

read = load("latency_p95_ms")
