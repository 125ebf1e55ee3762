"""Nearest-neighbour graphs built from point clouds and features."""
