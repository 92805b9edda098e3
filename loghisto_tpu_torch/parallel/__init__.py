"""Aggregation engines of the port (the mesh comes in a later slice)."""
