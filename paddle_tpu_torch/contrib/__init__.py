"""Contributed extensions: bf16 mixed precision."""
