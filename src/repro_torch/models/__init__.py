"""Transformer model of the port: layers, parameters, caches, steps."""
