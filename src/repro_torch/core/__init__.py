"""Core DFR math: types, masking, reservoir, DPRR, backprop, ridge, online,
and the offline classifier (dfr)."""
