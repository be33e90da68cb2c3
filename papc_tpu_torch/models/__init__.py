"""Models of the port (counterpart of ``papc_tpu.models``)."""

from papc_tpu_torch.models.registry import ModelSpec, init_model, registry_combos

__all__ = ["ModelSpec", "init_model", "registry_combos"]
