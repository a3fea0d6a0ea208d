"""Models of the port: LIF cells, the prediction layer, FireNet."""
