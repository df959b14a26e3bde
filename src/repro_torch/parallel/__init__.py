"""Tensor-parallel sharding and step builders over the virtual mesh."""
