"""Independent adaptation streams over CUDA devices (``streams.py``)."""
