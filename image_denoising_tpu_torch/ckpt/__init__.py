from .io import (checkpoint_path, load_checkpoint, load_params_tree, module_arch,
                 restore_train_state, save_checkpoint, save_train_state, to_params)
from .pth_export import load_jax_params, params_to_state_dict
from .pth_import import import_pth, load_state_dict, state_dict_to_params

__all__ = ["checkpoint_path", "import_pth", "load_checkpoint", "load_jax_params",
           "load_params_tree", "load_state_dict", "module_arch", "params_to_state_dict",
           "restore_train_state", "save_checkpoint", "save_train_state",
           "state_dict_to_params", "to_params"]
