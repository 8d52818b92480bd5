"""The paper's CNN benchmarks (port of repro.models.cnn)."""
