from volq_torch.core.types import Camera, Light, Particles, SceneState
from volq_torch.core.camera import make_camera, view_z
from volq_torch.core.device import resolve_device

__all__ = ["Camera", "Light", "Particles", "SceneState", "make_camera",
           "view_z", "resolve_device"]
