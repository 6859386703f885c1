"""Field engines of the port: strict limbs, lazy radix-13 digits, K1."""
