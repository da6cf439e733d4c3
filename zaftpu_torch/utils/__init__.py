"""Host-side utilities of the port (the operator disk cache)."""
