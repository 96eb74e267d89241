"""Models: support sets, the StyleGAN2, BigGAN and ProgGAN generators, the
uniform generator contract and ``gan_load``."""
