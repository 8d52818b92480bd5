"""Training (port of repro.train): optimizers and the CNN loop."""
