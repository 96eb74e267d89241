"""Models: support sets, the SNGAN, StyleGAN2, BigGAN and ProgGAN
generators, the
uniform generator contract and ``gan_load``."""
