"""Training on the port: losses, the steps, the two-phase trainer and its
CLI (``python -m fast_srgan_torch.train``)."""
