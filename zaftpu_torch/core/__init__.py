"""Host numerics of the port: windows, validation, framing, DFT operators."""
