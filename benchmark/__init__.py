"""The benchmark of fast_srgan_torch on the card: see harness.py."""
