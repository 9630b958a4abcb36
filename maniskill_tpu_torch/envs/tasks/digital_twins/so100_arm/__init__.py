from .grasp_cube import SO100GraspCubeEnv  # noqa: F401
