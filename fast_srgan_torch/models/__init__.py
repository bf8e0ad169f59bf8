"""Generator module of the port."""

from fast_srgan_torch.models.generator import Generator

__all__ = ["Generator"]
