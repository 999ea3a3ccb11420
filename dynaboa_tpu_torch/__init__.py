"""dynaboa_tpu_torch: the PyTorch / CUDA port of dynaboa_tpu for an NVIDIA
H100.

The sub-packages mirror ``dynaboa_tpu`` module for module (``ops``,
``models``, ``kernels``, ``losses``, ``metrics``, ``engine``, ``data``,
``apps``).  The package imports torch and never jax, and nothing of the JAX
package: it keeps its own ``constants``, ``config`` and GMM asset
(``assets/gmm_08.npz``).  Every tensor lives on the device the entry point
names.
"""

__version__ = "0.1.0"
