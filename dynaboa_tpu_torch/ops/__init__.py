"""Counterpart of ``dynaboa_tpu.ops``; import the modules directly."""
