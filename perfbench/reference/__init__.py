"""Plain PyTorch references of what the port computes. Nothing here
imports the port or JAX."""
