from .io import load_checkpoint
from .pth_export import load_jax_params, params_to_state_dict

__all__ = ["load_checkpoint", "load_jax_params", "params_to_state_dict"]
