from .scene_builder import SceneBuilder
