"""Typed config (the port's own copy of ``ocflow_tpu/train/config.py``).

``Config`` carries the keys of the repository's ``configs/*.yaml``;
``as_hparams`` gives the dict the step factories read. ``load_config``
needs PyYAML and imports it only when called; ``LONGRUN_SYNTHETIC`` is
``configs/longrun_synthetic.yaml`` as a dict, for machines without it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class Config:
    # dispatch
    network_type: str = "flow"  # flow | occ | flow-occ | inpainting | twostage
    model: str = "simple"
    dataset_name: str = "SyntheticFlow"
    root: str = ""
    # shapes / batching
    image_size: Optional[Tuple[int, int]] = None
    batch_size: int = 16
    num_workers: int = 6
    overfit: bool = False
    dataset_size: Optional[int] = None
    cache_data: bool = False
    device_cache: bool = False
    device_cache_dtype: str = "bfloat16"
    # optimization
    learning_rate: float = 1e-3
    find_best_lr: bool = False
    max_epochs: int = 100
    patience: int = 60  # early stopping
    seed: int = 42
    # unsupervised flow weights
    photo_weight: float = 1.0
    smooth1_weight: float = 0.0
    smooth2_weight: float = 1.0
    with_occ: bool = False
    occ_aware: bool = False
    displacement: int = 4
    # inpainting / two-stage
    loss_type: str = "pixel-wise"  # pixel-wise | vgg
    reconst_weight: float = 1.0
    pixelwise_weight: float = 1.0
    smoothness_weight: float = 0.0
    occlusion_ratio: float = 0.3
    static_occ: bool = False
    adversarial_loss: bool = False
    org: bool = False
    remat: bool = False
    with_gt_flow: bool = True
    using_pretrained_inpainting: bool = False
    unfreeze_epoch: int = 23
    finetune_lr: float = 1e-5
    flow_root: str = ""
    inpainting_root: str = ""
    supervised_flow: bool = False
    vgg_weights: str = ""
    # logging / output
    log_every_n_steps: int = 20
    log_image_every_epoch: int = 10
    n_display_images: int = 1
    result_dir: str = "results"
    log_dir: str = "tensorboard_logs"
    checkpoint_dir: str = "checkpoints"
    metrics_csv: str = ""
    # parallelism
    mesh_shape: Optional[Tuple[int, ...]] = None
    # compute dtype of the network ('float32' | 'bfloat16')
    compute_dtype: str = "float32"
    # extra passthrough keys (step hparams such as occ_method)
    extra: dict = dataclasses.field(default_factory=dict)

    def get(self, key: str, default=None):
        """dict-style access for the step factories (hparams protocol)."""
        if hasattr(self, key):
            return getattr(self, key)
        return self.extra.get(key, default)

    def as_hparams(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(d.pop("extra"))
        return d


def load_config(path: str) -> Config:
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    return config_from_dict(raw)


def config_from_dict(raw: dict) -> Config:
    fields = {f.name for f in dataclasses.fields(Config)}
    known = {k: v for k, v in raw.items() if k in fields}
    extra = {k: v for k, v in raw.items() if k not in fields}
    if "image_size" in known and known["image_size"] is not None:
        known["image_size"] = tuple(known["image_size"])
    if "mesh_shape" in known and known["mesh_shape"] is not None:
        known["mesh_shape"] = tuple(known["mesh_shape"])
    return Config(**known, extra=extra)


# configs/longrun_synthetic.yaml: the flagship occlusion-aware training run
# (FlowNetCV at 448x1024, batch 8, bf16 compute, range-map occlusion)
LONGRUN_SYNTHETIC = {
    "network_type": "flow", "model": "pwc", "dataset_name": "SyntheticFlowWarp",
    "dataset_size": 160, "cache_data": False, "device_cache": True,
    "image_size": [448, 1024], "batch_size": 8, "num_workers": 1,
    "max_epochs": 70, "patience": 1000, "learning_rate": 1.0e-4,
    "photo_weight": 4.0, "smooth1_weight": 0.5, "smooth2_weight": 0.0,
    "occ_aware": True, "occ_method": "range_map", "occ_resolution": "full",
    "compute_dtype": "bfloat16", "fast_forward": "both",
    "log_every_n_steps": 4, "metrics_csv": "results/longrun/metrics.csv",
    "log_dir": "results/longrun/tb", "checkpoint_dir": "results/longrun/ckpt",
    "result_dir": "results/longrun",
}
