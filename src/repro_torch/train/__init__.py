"""The training loop and its checkpoints (``loop``, ``checkpoint``)."""
