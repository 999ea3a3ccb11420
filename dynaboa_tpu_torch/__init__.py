"""dynaboa_tpu_torch: the PyTorch / CUDA port of dynaboa_tpu for an NVIDIA
H100.

The sub-packages mirror ``dynaboa_tpu`` module for module (``ops``,
``models``, ``kernels``, ``losses``, ``metrics``, ``engine``, ``data``,
``apps``).  The package imports torch and never jax; of the JAX package it
reads only ``dynaboa_tpu.constants``, ``dynaboa_tpu.config`` and the GMM
asset file.  Every tensor lives on the device the entry point names.
"""

__version__ = "0.1.0"
