from .scene_builder import LAYOUTS, RoboCasaSceneBuilder
