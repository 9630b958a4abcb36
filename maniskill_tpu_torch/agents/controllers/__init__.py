from .base_controller import (
    BaseController,
    CombinedController,
    ControllerConfig,
    DictController,
)
from .pd_joint_pos import (
    PDJointPosController,
    PDJointPosControllerConfig,
    PDJointPosMimicController,
    PDJointPosMimicControllerConfig,
)
from .passive_controller import PassiveController, PassiveControllerConfig

__all__ = [
    "BaseController", "CombinedController", "ControllerConfig", "DictController",
    "PDJointPosController", "PDJointPosControllerConfig",
    "PDJointPosMimicController", "PDJointPosMimicControllerConfig",
    "PassiveController", "PassiveControllerConfig",
]
