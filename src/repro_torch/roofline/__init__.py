"""The schedule cost model of the port's autotuner, with the H100's constants."""

from .analysis import schedule_cost_model

__all__ = ["schedule_cost_model"]
