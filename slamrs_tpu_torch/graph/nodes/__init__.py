"""The node types of the host graph, one module per family."""

from slamrs_tpu_torch.graph.nodes.robot import (  # noqa: F401
    FileLoaderNodeConfig,
    RobotConnectionNodeConfig,
)
from slamrs_tpu_torch.graph.nodes.sim import SimulatorNodeConfig  # noqa: F401
from slamrs_tpu_torch.graph.nodes.slam import (  # noqa: F401
    EKFLandmarkSlamNodeConfig,
    GridMapSlamNodeConfig,
    IcpPointMapperNodeConfig,
)
from slamrs_tpu_torch.graph.nodes.util import (  # noqa: F401
    ControlsNodeConfig,
    GamepadNodeConfig,
    GaussianTestNodeConfig,
    MousePositionNodeConfig,
    ShapeTestNodeConfig,
    SplitterNodeConfig,
)
from slamrs_tpu_torch.graph.nodes.viz import VisualizerNodeConfig  # noqa: F401
