"""Training steps of the port: losses and the pretrain/GAN steps."""
