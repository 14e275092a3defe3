"""The dense decoder of the port: layers, attention, blocks and the model."""
