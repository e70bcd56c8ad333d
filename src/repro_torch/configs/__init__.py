"""Architecture configs. Each module registers a full config and a reduced
variant used by the CPU tests."""
from repro_torch.models.config import get_config, list_archs  # re-export

__all__ = ["get_config", "list_archs"]
