"""Counterpart of ``dynaboa_tpu.engine``; import the modules directly."""
