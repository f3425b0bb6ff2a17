from .io import (checkpoint_path, load_checkpoint, restore_train_state, save_checkpoint,
                 save_train_state)
from .pth_export import load_jax_params, params_to_state_dict

__all__ = ["checkpoint_path", "load_checkpoint", "load_jax_params",
           "params_to_state_dict", "restore_train_state", "save_checkpoint",
           "save_train_state"]
