"""Executor decisions of the port (the attention decisions so far)."""

from .tuner import AttnDecision, attn_block_q, choose_attn_impl

__all__ = ["AttnDecision", "attn_block_q", "choose_attn_impl"]
