"""Models: support sets, the StyleGAN2 generator, the uniform generator contract and its builders."""
