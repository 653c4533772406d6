"""Models of the port (dense family so far)."""
