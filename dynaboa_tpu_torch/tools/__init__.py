"""Offline tools of the port: SMPL pickle conversion and the retrieval
store builder."""
