from .finetune_steps import make_adapter_finetune_step, make_memory_finetune_step
from .schedule import hpo_milestones, multistep_lr, reference_milestones
from .state import TrainState, create_train_state, set_learning_rate
from .steps import (make_l1_train_step, make_n2n_train_step,
                    make_structure_train_step, to_nchw01)

__all__ = [
    "TrainState",
    "create_train_state",
    "hpo_milestones",
    "make_adapter_finetune_step",
    "make_l1_train_step",
    "make_memory_finetune_step",
    "make_n2n_train_step",
    "make_structure_train_step",
    "multistep_lr",
    "reference_milestones",
    "set_learning_rate",
    "to_nchw01",
]
