from halogen_tpu_torch.core import math  # noqa: F401
from halogen_tpu_torch.core.types import SceneData, MaterialTable  # noqa: F401
