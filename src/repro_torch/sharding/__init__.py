"""Sharding across processes (port of ``repro/sharding``): the leaves'
specs (``rules``) and the active mesh with its collectives
(``activation``)."""
