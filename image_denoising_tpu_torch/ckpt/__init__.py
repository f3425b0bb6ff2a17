from .io import checkpoint_path, load_checkpoint, save_checkpoint
from .pth_export import load_jax_params, params_to_state_dict

__all__ = ["checkpoint_path", "load_checkpoint", "load_jax_params",
           "params_to_state_dict", "save_checkpoint"]
