"""Data of the port (``data/pipeline.py``): the token pipelines of the
training slice and the out-of-core matrix writers of the tile sources."""
