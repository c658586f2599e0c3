"""Training of the port's models: optimizer, data, step, checkpoints."""
