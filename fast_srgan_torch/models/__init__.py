"""Modules of the port: the generator, the discriminator and VGG19 features."""

from fast_srgan_torch.models.discriminator import Discriminator
from fast_srgan_torch.models.generator import Generator
from fast_srgan_torch.models.vgg import VGG19Features

__all__ = ["Discriminator", "Generator", "VGG19Features"]
