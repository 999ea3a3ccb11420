"""Counterpart of ``dynaboa_tpu.losses``; import the modules directly."""
