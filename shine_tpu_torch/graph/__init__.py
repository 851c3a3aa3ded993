from shine_tpu_torch.graph.soa import GraphSoA, build_graph

__all__ = ["GraphSoA", "build_graph"]
