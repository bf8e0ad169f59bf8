"""Plain PyTorch references of the benchmark's models, steps and losses."""
