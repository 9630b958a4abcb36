from .scene_builder import TableSceneBuilder
