"""Segment-sum SpMM: GNN message passing, ``out[dst] += x[src]``."""
