"""Attention forms of the port (plain PyTorch)."""
