"""Multi-device placement of the port. Only the k-means that the routed
build's spatial cluster order needs is ported so far."""
