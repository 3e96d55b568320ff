"""Entry points that run the port's slices end to end (``serve``: prefill
and the engine)."""
