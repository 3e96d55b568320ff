"""The port's own copies of the reference's experiment configurations."""
