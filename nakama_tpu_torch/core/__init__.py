"""Core account logic of the port (authentication so far)."""
