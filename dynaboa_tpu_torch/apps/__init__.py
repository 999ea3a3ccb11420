"""Counterpart of ``dynaboa_tpu.apps``; import the modules directly."""
