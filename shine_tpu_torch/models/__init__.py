"""Index models of the port."""
