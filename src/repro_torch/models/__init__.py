from repro_torch.models.config import ModelConfig  # noqa: F401
from repro_torch.models import transformer  # noqa: F401
