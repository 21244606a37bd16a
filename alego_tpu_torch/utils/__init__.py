"""Host-side utilities of the port: the synthetic renderer and trajectory
metrics (numpy-only copies of the reference's)."""
