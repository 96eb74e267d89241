"""Latent-code sampling."""
