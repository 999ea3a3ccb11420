"""Counterpart of ``dynaboa_tpu.kernels``; import the modules directly."""
