"""Tools of the port: SMPL pickle conversion, the retrieval store builder,
the full-width parity harness, and the counterparts of the root drivers
(the headline benchmark, the soak, the cold-start timer and the sweep)."""
