"""G1 group law and the MSM of the port."""
