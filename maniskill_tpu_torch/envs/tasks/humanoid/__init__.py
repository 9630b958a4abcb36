from .humanoid_stand import HumanoidStandEnv, UnitreeG1StandEnv, UnitreeH1StandEnv
