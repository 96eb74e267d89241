"""The plain reference: straightforward PyTorch of the published models and
of WarpedGANSpace's warp and training step, in float32 with TF32 off (the
warp in float64). It reads the benchmark's inputs in their reference layouts
and imports nothing of the program under test."""
