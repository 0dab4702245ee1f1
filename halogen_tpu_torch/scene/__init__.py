from halogen_tpu_torch.scene.material import Material
from halogen_tpu_torch.scene.scene import Scene
from halogen_tpu_torch.scene import cornell

__all__ = ["Material", "Scene", "cornell"]
