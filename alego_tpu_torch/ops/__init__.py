"""Tensor ops of the port: geometry, projection, segmentation, features,
correspondence search and solvers, each beside its CUDA kernel where the
reference had a Pallas kernel."""
