"""Converters from reference state dicts and JAX parameter pytrees to the port's modules."""
