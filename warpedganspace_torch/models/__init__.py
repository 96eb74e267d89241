"""Models: support sets, the StyleGAN2 and BigGAN generators, the uniform
generator contract and ``gan_load``."""
