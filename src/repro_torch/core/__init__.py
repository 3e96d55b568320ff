"""RandNLA consumers of the mixed-precision projection (port of repro.core)."""
