"""The model code of the port: layers, attention, the dense decoder."""
