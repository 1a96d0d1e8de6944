"""Core pieces of the port: the numerics policy and the PRNG discipline."""
