"""Counterpart of ``dynaboa_tpu.data``; import the modules directly."""
