"""Core DFR math: types, masking, reservoir, DPRR, backprop, ridge, online."""
