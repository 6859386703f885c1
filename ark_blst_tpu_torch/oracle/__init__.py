"""Host-int BLS12-381 oracle (G1 subset): the port's trusted reference."""
