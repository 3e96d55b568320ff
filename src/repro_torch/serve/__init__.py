"""Serving: the slot-pool model step, incremental KV compression (linear and
rolling), the closed-loop engine, and the continuous-batching scheduler with
its load generator and SLO metrics."""
