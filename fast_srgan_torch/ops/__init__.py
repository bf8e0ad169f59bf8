"""Plain PyTorch ops: instance norm, the LR-domain tail, bicubic resize."""
