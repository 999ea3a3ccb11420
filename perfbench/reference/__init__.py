"""The plain reference of the adapted step, in plain PyTorch and float32.

It imports nothing of the system under test."""
