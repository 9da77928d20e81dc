"""Attention forms (plain PyTorch) and the bounded host prefetcher."""
