from dragonfly2_torch.topology.engine import TopologyConfig, TopologyEngine

__all__ = ["TopologyConfig", "TopologyEngine"]
