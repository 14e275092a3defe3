"""Examples that drive the port's entry points (the trainer)."""
