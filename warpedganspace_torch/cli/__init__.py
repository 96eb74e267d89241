"""Command-line pipeline scripts with the JAX package's flags and experiments tree."""
