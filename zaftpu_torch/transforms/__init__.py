"""The public transforms of the port."""
