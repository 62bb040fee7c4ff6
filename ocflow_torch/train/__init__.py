"""Training: the config, the train state and the unsupervised flow step."""

from ocflow_torch.train.config import (LONGRUN_SYNTHETIC, Config, config_from_dict,
                                       load_config)
from ocflow_torch.train.state import TrainState, create_train_state
from ocflow_torch.train.steps import make_unsupervised_flow_step

__all__ = [
    "LONGRUN_SYNTHETIC", "Config", "TrainState", "config_from_dict",
    "create_train_state", "load_config", "make_unsupervised_flow_step",
]
