from volq_torch.scene.config import (SceneConfig, VolumeConfig,
                                     EmitterConfig, ForcesConfig,
                                     CameraConfig, LightConfig, RenderConfig,
                                     PRESETS, to_json, from_json)
from volq_torch.scene.state import (init_scene, build_camera, build_light,
                                    bake_volumes)

__all__ = ["SceneConfig", "VolumeConfig", "EmitterConfig", "ForcesConfig",
           "CameraConfig", "LightConfig", "RenderConfig", "PRESETS",
           "to_json", "from_json", "init_scene", "build_camera",
           "build_light", "bake_volumes"]
