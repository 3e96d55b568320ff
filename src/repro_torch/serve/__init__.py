"""Serving: the slot-pool model step, incremental KV compression and the
closed-loop engine (the scheduler, load generator and metrics are not
ported yet)."""
