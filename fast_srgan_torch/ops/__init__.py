"""Plain PyTorch ops of the generator: instance norm and the LR-domain tail."""
