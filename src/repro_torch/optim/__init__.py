"""Optimizers of the port: AdamW and Adafactor over the model's tensors."""
