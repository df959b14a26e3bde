"""Parallel context, virtual mesh and TP collectives of the port."""
