"""The joint flow + occlusion + inpainting training step (port of
``ocflow_tpu/train/steps_joint.py``; BASELINE's configuration #5, KITTI-2015
in bf16 at batch 16).

One optimizer over ``nn.ModuleDict({'flow_occ': FlowOccNetCV, 'inpaint':
InpaintingNet})`` (its ``state_dict`` the JAX ``params`` tree
``{'flow_occ', 'inpaint'}``). The flow+occlusion net predicts both, the
inpainter completes the warp masked by the hardened occlusion, and the loss
adds the valid-masked flow L1 (KITTI's ground truth is sparse), the
occlusion BCE where the batch has ``occ``, the photometric error off the
soft occlusion and ``recon_loss`` of the completed frame.

``hparams['dtype']`` ``'bfloat16'`` runs both nets under the policy of
``models.precision.apply_mixed`` (bf16 bodies over fp32 master weights,
fp32 outputs and losses). FlowOccNetCV's five d=4 cost volumes then run
the hand-written kernels in bf16 on the card, forward and backward.
"""

from __future__ import annotations

import torch

from ocflow_torch import losses
from ocflow_torch.models.precision import apply_mixed, resolve_dtype
from ocflow_torch.ops.ste import hard_threshold_ste
from ocflow_torch.train.steps import _shares, _step_mesh
from ocflow_torch.train.steps_inpainting import _build_steps
from ocflow_torch.train.steps_two_stage import _warp_nhwc


def masked_flow_l1(flow_pred: torch.Tensor, flow_gt: torch.Tensor,
                   valid: torch.Tensor | None = None, reduce=None) -> torch.Tensor:
    """The L1 of the flow over the valid pixels, ``sum(|d| valid) / (2
    sum(valid) + 1e-8)``; the plain mean without ``valid``. ``reduce``
    (data parallelism, as in ``losses.photometric``): a function that sums
    a tensor over the ranks, without gradient; with ``valid`` this rank's
    share of the global-batch value comes back (its numerator over the
    summed denominator), without it the plain mean of the block."""
    diff = (flow_pred - flow_gt).abs()
    if valid is None:
        return diff.mean()
    den = valid.sum()
    if reduce is not None:
        den = reduce(den)
    return (diff * valid).sum() / (2.0 * den + 1e-8)


def make_joint_step(hparams: dict):
    """``(train_step, eval_step)`` over ``state.model =
    nn.ModuleDict({'flow_occ', 'inpaint'})`` on batches ``{'images' [B, H,
    W, 6], 'flow' [B, H, W, 2]}`` with optional ``valid`` [B, H, W, 1] and
    ``occ``. Both nets run in train mode in the train step (the inpainter's
    BatchNorm statistics kept), eval mode in the eval step. Frame 2 is
    warped by the predicted flow (``align_corners=True``). Weights
    ``flow_weight``, ``occ_bce_weight``, ``photo_weight``,
    ``reconst_weight`` (1 each). Metrics ``loss``, ``flow_l1``,
    ``occ_bce`` (0 without ``occ``), ``photometric``, ``reconst`` and
    ``epe`` (the end-point error over the valid pixels). Over several ranks
    (``hparams['_fast_mesh']``, ``train.steps_inpainting``'s module
    docstring) the valid-masked ratios take their denominators summed over
    the ranks, every other term is the block's mean over the world size,
    and the inpainter's BatchNorms (``_mixed`` under bf16 too) take the
    global batch's statistics."""
    flow_w = hparams.get("flow_weight", 1.0)
    occ_w = hparams.get("occ_bce_weight", 1.0)
    photo_w = hparams.get("photo_weight", 1.0)
    reconst_w = hparams.get("reconst_weight", 1.0)
    dtype = resolve_dtype(hparams.get("dtype"))
    mesh = _step_mesh(hparams)
    mean, red = _shares(mesh)

    def loss_fn(model, batch):
        imgs = batch["images"]
        img1, img2 = imgs[..., :3], imgs[..., 3:]
        flow, occ = apply_mixed(model["flow_occ"], imgs, dtype=dtype)
        valid = batch.get("valid")
        flow_loss = masked_flow_l1(flow, batch["flow"], valid, **red)
        if valid is None:
            flow_loss = mean(flow_loss)
        occ_loss = (mean(losses.binary_cross_entropy(occ, batch["occ"])) if "occ" in batch
                    else torch.zeros((), device=imgs.device))
        img_warped = _warp_nhwc(img2, flow)
        occ_hard = hard_threshold_ste(occ)
        completed = apply_mixed(model["inpaint"], img_warped * (1.0 - occ_hard), occ_hard,
                                dtype=dtype)
        if isinstance(completed, tuple):
            completed = completed[1]  # a gated generator's (coarse, refined)
        photo = mean(losses.photometric_error(img_warped * (1.0 - occ), img1 * (1.0 - occ)))
        reconst = mean(losses.recon_loss(completed, img1, occ)[0])
        loss = flow_w * flow_loss + occ_w * occ_loss + photo_w * photo + reconst_w * reconst
        epe = torch.linalg.vector_norm(flow - batch["flow"], dim=-1, keepdim=True)
        if valid is None:
            epe = mean(epe.mean())
        else:
            den = valid.sum() if mesh is None else mesh.sum(valid.sum())
            epe = (epe * valid).sum() / (den + 1e-8)
        return loss, {"loss": loss, "flow_l1": flow_loss, "occ_bce": occ_loss,
                      "photometric": photo, "reconst": reconst, "epe": epe}

    return _build_steps(loss_fn, mesh)

