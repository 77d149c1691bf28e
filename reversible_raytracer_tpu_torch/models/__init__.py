from .configs import CONFIGS, perturb
from .scene import Camera, Lights, Materials, ParamSpec, Rects, Scene, Spheres

__all__ = ["CONFIGS", "Camera", "Lights", "Materials", "ParamSpec", "Rects", "Scene",
           "Spheres", "perturb"]
