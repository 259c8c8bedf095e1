"""Placement of the serving state over the port's slot mesh: the logical-axis
rules of ``repro.distributed``."""
