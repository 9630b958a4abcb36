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
from .pd_ee_pose import (
    PDEEPosController,
    PDEEPosControllerConfig,
    PDEEPoseController,
    PDEEPoseControllerConfig,
)
from .pd_joint_vel import PDJointVelController, PDJointVelControllerConfig
from .pd_joint_pos_vel import PDJointPosVelController, PDJointPosVelControllerConfig
from .pd_base_vel import (
    PDBaseForwardVelController,
    PDBaseForwardVelControllerConfig,
    PDBaseVelController,
    PDBaseVelControllerConfig,
)

__all__ = [
    "BaseController", "CombinedController", "ControllerConfig", "DictController",
    "PDJointPosController", "PDJointPosControllerConfig",
    "PDJointPosMimicController", "PDJointPosMimicControllerConfig",
    "PassiveController", "PassiveControllerConfig",
    "PDEEPosController", "PDEEPosControllerConfig",
    "PDEEPoseController", "PDEEPoseControllerConfig",
    "PDJointVelController", "PDJointVelControllerConfig",
    "PDJointPosVelController", "PDJointPosVelControllerConfig",
    "PDBaseVelController", "PDBaseVelControllerConfig",
    "PDBaseForwardVelController", "PDBaseForwardVelControllerConfig",
]


def deepcopy_dict(d):
    import copy

    return copy.deepcopy(d)
