"""Weight carriers from the JAX package's checkpoints into the port."""
