"""Data layouts of the port (``data/pipeline.py``: the out-of-core matrix
writers of the tile sources)."""
