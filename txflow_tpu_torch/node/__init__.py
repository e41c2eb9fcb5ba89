"""Node assembly and in-process validator networks (counterpart of
``txflow_tpu/node/``): ``Node`` wires pools, reactors and the fast-path
engine; ``LocalNet`` connects N nodes over in-memory pipes. The
multi-process ``ProcNet`` waits for the node services."""

from .localnet import LocalNet
from .node import Node, NodeConfig

__all__ = ["Node", "NodeConfig", "LocalNet"]
