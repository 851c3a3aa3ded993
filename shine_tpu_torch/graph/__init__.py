from shine_tpu_torch.graph.soa import GraphSoA, build_graph, host_search

__all__ = ["GraphSoA", "build_graph", "host_search"]
