"""Tensor operations of the port: beam, distances, the gather-and-score kernel."""
