"""Counterpart of ``dynaboa_tpu.models``; import the modules directly."""
