"""Training: the config, the train state, the supervised steps, the
unsupervised flow step, the inpainting steps (supervised, stage and GAN), the
two-stage steps and their gated optimizer, the joint flow+occlusion+inpainting
step, and the learning-rate range test (``python -m ocflow_torch.train`` is
the supervised trainer CLI)."""

from ocflow_torch.train.config import (LONGRUN_SYNTHETIC, Config, config_from_dict,
                                       load_config)
from ocflow_torch.train.state import TrainState, create_train_state
from ocflow_torch.train.lr_finder import lr_find
from ocflow_torch.train.steps import (make_supervised_flow_occ_step, make_supervised_flow_step,
                                     make_supervised_occ_step, make_unsupervised_flow_step)
from ocflow_torch.train.steps_inpainting import (make_gan_inpainting_step,
                                                 make_inpainting_stage_step,
                                                 make_supervised_inpainting_step)
from ocflow_torch.train.steps_joint import make_joint_step, masked_flow_l1
from ocflow_torch.train.steps_two_stage import (GatedAdam, make_two_stage_gc_optimizer,
                                                make_two_stage_gc_step, make_two_stage_step)

__all__ = [
    "LONGRUN_SYNTHETIC", "Config", "GatedAdam", "TrainState", "config_from_dict",
    "create_train_state", "load_config", "lr_find", "make_gan_inpainting_step",
    "make_inpainting_stage_step", "make_joint_step",
    "make_supervised_flow_occ_step", "make_supervised_flow_step",
    "make_supervised_inpainting_step", "make_supervised_occ_step",
    "make_two_stage_gc_optimizer", "make_two_stage_gc_step", "make_two_stage_step",
    "make_unsupervised_flow_step", "masked_flow_l1",
]
