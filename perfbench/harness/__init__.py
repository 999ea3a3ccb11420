"""The benchmark harness: inputs, traffic, entries, trace, check."""
