"""The synthetic LM data of the port's trainer."""
