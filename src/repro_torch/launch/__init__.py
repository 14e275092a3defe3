"""Entry points of the port that run a model (the server and the trainer)."""
