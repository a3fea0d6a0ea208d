"""Training of the port: optimizer, the update step, the host loop."""
