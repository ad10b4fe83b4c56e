"""Distributed layout of the FSA step (``repro/dist``): the data axis."""
