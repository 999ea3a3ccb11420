"""Counterpart of ``dynaboa_tpu.metrics``; import the modules directly."""
