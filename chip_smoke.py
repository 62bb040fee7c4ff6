#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (``ocflow_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the kernels from ``ocflow_torch/csrc`` with nvcc (sm_90a), one
   nvcc per source, all started together;
3. record every kernel call of the FlowNetCV serving forward
   (``fast_apply``, 448x1024, B=8) in fp32 and in bf16, replay each through
   the kernel and its plain PyTorch version, and hold them together;
4. calibrate W8A8 scales on a held-out batch (seed 1), record every kernel
   call of the W8A8 forward and of the opt-in forward (encoder and context
   chain int8 too), and replay each against its plain version: int8 codes
   and the bf16 outputs of int8-read convs bit for bit, bf16-read convs and
   the bf16 conv groups within 2^-6, cost volumes as in phase 3; and every
   int8 conv on the int8 TMA kernel ``csrc/conv_group_q8_tma.cu`` (in both
   forwards) once more alone, on the blocks its group's replay filled, its
   own block poisoned first, bit for bit;
5. drive each path once with every launch counter zeroed just before and
   read just after: the bf16 forward (5 cost volumes, one bf16 conv launch
   per conv, 59, of which 53 of stride 1 ("staged": all but the six
   stride-2 encoder convs), all 53 on the TMA kernel
   ``csrc/conv_group_tma.cu``), the W8A8 forward (5, 24 bf16 of which 18
   staged, all on the TMA kernel, 35 int8 launches, all 35 on the int8 TMA
   kernel), the opt-in W8A8
   forward (as ``launch_counts()`` reckons: the decoders' 35 int8 convs on
   the int8 TMA kernel, its six stride-2 encoder convs and four dilated
   context convs on the int8 gather kernel, the encoder's and context
   chain's other 14 on the staged int8 kernel; the int8 TMA count at
   8x320x1216 printed beside) and the GEMM
   probe ``ocflow_torch.tools.spike_int8`` (2048^3, int8 exact, bf16 within
   1e-2; timed with its calls queued behind a spin kernel);
6. hold fp32 ``fast_apply`` against the eager fp32 ``FlowNetCV`` (cuDNN,
   TF32 off), also with PyTorch's default TF32 flags, bf16 against fp32,
   W8A8 against the eager fp32 forward;
7. time every kernel at the path's shapes against its plain version, its
   bound and a library yardstick (conv groups with their TFLOP/s or TOP/s
   and share of the bound, and the staged kernel of PR 5 on the same
   groups); every conv the TMA kernel takes, replayed alone against its
   plain version and timed queued behind a spin beside the staged kernel,
   cuDNN and its bound; every int8 conv of the W8A8 forward timed alone on
   the int8 TMA kernel, queued, beside the staged int8 kernel, the bf16 TMA
   kernel and bf16 cuDNN on the same convs and its bound; the int8 kernel
   of ``csrc/conv_group_q8.cu`` on the opt-in forward's encoder and context
   groups; the bf16 and W8A8 forwards end to end (pairs/s) in turns;
8. training (``longrun_synthetic.yaml`` hparams, seeded FlowNetCV and
   smooth seeded frames, 448x1024, B=8): record every kernel call of one
   fp32 and one bf16 step (pair + loss + backward) and replay each against
   its plain version (cost-volume forward and backward, serving conv
   groups, ``conv_group_diff`` forwards, and every launch of the bf16
   step's ``conv_group_diff`` backward: each dX launch on
   ``csrc/conv_group_tma.cu``'s adjoint epilogue and each dW launch on
   ``csrc/conv_group_dw.cu``, at 2^-6 of max|plain| and replayed bit for
   bit); hold the fused fp32 step against
   the eager fp32 step (loss, metrics, per-tensor gradients, parameters
   after Adam) beside what the gap is made of (each step's run-to-run
   spread, the eager step with deterministic cuDNN, the eager step with
   the fused run's occlusion mask held); bf16 vs fp32
   gradients; launches of one bf16 step (10 cost volumes, 5 backward, 31
   ``conv_group_diff`` conv launches, 72 conv launches in all, every one
   of stride 1 on the TMA kernel; the backward's 30 dX and 31 dW launches,
   no cuDNN VJP) and of one with a W8A8 backward decode
   (37 staged, all on the TMA kernel, 35 int8, all on the int8 TMA
   kernel);
   five bf16 Adam steps;
   the bf16 step end to end, and the new kernels' calls against plain,
   bound and cuDNN; each ``conv_group_diff`` group's backward on the
   host's clock and its device time queued behind a spin, beside the VJP
   route, cuDNN's autograd over the concat, its dX and dW launches alone,
   their plain versions and the bound;
9. FlowNetC family serving (FlowNetC, OcclusionNetC, FlowOccNetC, seeded,
   their BatchNorm statistics perturbed from the seed, since the seeded
   init starts BatchNorm at the identity, B=8, 448x1024, fp32, eval mode):
   per net, the
   launches of one forward (one d=10 cost volume, no other kernel), the
   d=10 call replayed against its plain version in fp32 and cast to bf16,
   the forward against the same forward on the plain cost volume (also
   with PyTorch's default TF32 flags), the d=10 call's time against its
   plain version and bound, the forward end to end; FlowNetC's fp32 input
   gradient under a seeded cotangent (one d=10 forward and one d=10
   backward launch) against the gradient with the plain backward on the
   same forward (cuDNN's deterministic algorithms in both), its d=10
   backward call replayed against its plain version in fp32 and cast to
   bf16, and timed beside its bound;
10. the training system on ``configs/longrun_synthetic.yaml`` at full width
   (448x1024, B=8), cut to 44 samples (35 / 4 / 5), 2 epochs, every step
   logged and panels every epoch, outputs in a temporary directory:
   ``SyntheticFlowWarp`` generated on the card against the same samples on
   the CPU (1e-4) and its ms per sample; the device cache's bytes and
   dtypes; ``make_loaders`` + ``fit`` with the launches of one train step
   counted (10 cost volumes, 5 backward, 72 conv launches of which 31
   ``conv_group_diff``, all staged, no int8; the backward's 30 dX and 31
   dW launches) and of one eval step; the
   CSV's rows and finite losses; the PNG panels decoded with zlib and
   equal to the panels; the best checkpoint restored into a fresh model
   and Adam, bit for bit, and ``evaluate`` on it against the in-memory
   state (1e-6 relative); the loop's ms per step (CUDA events) beside
   ``bench.measure_train``'s on a batch of the loader.

11. the file-backed data path and both CLIs at real sizes, from the seed,
   in a temporary directory: a Sintel tree (2 scenes of 5 frames, 436x1024,
   ``.flo`` flows, 0/255 occlusion PNGs), a KITTI 2015 tree (3 pairs,
   375x1242, sparse 16-bit flow PNGs) and a FlyingChairs2 tree (24 pairs,
   384x512), every PNG written by the port's writer with a seeded mix of
   the five row filters; frames, masks, ``.flo`` and 16-bit flows read back
   bit for bit; the host decode's ms per pair (one thread, the loader's 6);
   ``python -m ocflow_torch.evaluate --task flow --model pwc`` on
   ``MpiSintelClean`` (384x1024, B=8) and ``KITTI2015`` (320x1216: level 6
   is 19 wide) and ``--task flow_occ --model flowoccnetc`` on
   ``MpiSintelFlowOccClean``: each batch's launches (5 cost volumes, or 1
   at d=10), every cost-volume call replayed against its plain version
   (fp32, 1e-4 of max|plain|), the EPE and F1 against the same evaluation
   on the plain cost volume (1e-4 relative); ``evaluate``'s steady pairs/s
   over 12 batches of 8 (a 96-pair tree of links to the Sintel frames),
   timed from the second batch on, beside the decode and the warm forward,
   and the card's busy share there from a ``torch.profiler`` trace;
   ``python -m ocflow_torch.infer --q8 --save_flo`` on 16 pairs of Sintel
   frames (links, as above) and on the KITTI frames, pair by pair: each
   ``.flo`` equal to ``fast_apply``'s flow bit for bit, launches per pair
   5 / 0 / 24 / 0 / 35, every kernel call of the first pair replayed
   against its plain version, the W8A8 quarter flow against the eager fp32
   forward (0.1 of max|flow_quarter|), pairs/s after the first pair; one epoch of ``fit`` on the
   FlyingChairs2 tree through ``make_loaders`` with ``root`` and the device
   cache, the first train step's kernel calls replayed (bf16), the second's
   launches (10 / 5 / 72 / 31 / 0), the test metrics finite.

12. the cost-volume kernels at every d the tuned 4 and 10 leave (1, 2, 3,
   5, 6, 7, 8, 9) at 8x64x112x256 and 8x196x7x16, forward and backward, fp32
   and bf16, each call against its plain version and timed beside its
   bound; ``python -m ocflow_torch.train --config configs/supervised.yaml``
   cut to 2 epochs (a process of its own: exit 0, CSV rows, the best
   checkpoint, BatchNorm statistics that moved), then with
   ``find_best_lr`` (its suggestion printed; no kernel runs there); one
   supervised train step at 448x1024, B=8, fp32, seeded weights, of
   ``pwoc``, ``pwoc2``, ``flowoccnet``, ``flowoccnetc`` (flow-occ, on phase
   11's Sintel tree resized to 448x1024), ``flownet``, ``pwc`` (flow, on
   ``SyntheticFlow``) and ``occnetc`` (occ, Sintel): its launches (5 cost
   volumes and 5 backward at d=4; 1 and 1 at d=10; no conv-group kernel),
   every cost-volume call forward and backward replayed against its plain
   version, the step's loss, per-tensor gradients and updated BatchNorm
   statistics against the same step on the plain cost volume and the
   gradients against the same step with the plain backward on the kernel's
   forward (deterministic algorithms, TF32 off in all), pwoc's gradient
   into its occlusion
   gate through ``warped * occ``, the warm step's ms (median of 5); the
   same step of ``pwc`` under ``compute_dtype: bfloat16`` (autocast: its
   launches, loss and ms); ``evaluate --task flow_occ --model pwoc`` and ``--model flowoccnet`` on
   the Sintel tree and ``--task flow --model flownet``, as phase 11 runs
   ``evaluate`` (launches per batch, every cost-volume call replayed, the
   metrics against the plain cost volume).

13. the unsupervised zoo, at 448x1024, B=8, seeded, on
   ``SyntheticFlowWarp``: one occlusion-aware unsupervised train step of
   ``flownetc``, ``flownet`` and ``pwcnet`` with
   ``configs/longrun_synthetic.yaml``'s hparams (``compute_dtype:
   bfloat16`` casts the loss tail only): its launches (2 cost volumes and 1
   backward at d=10; 10 and 5 at d=4), every cost-volume call forward and
   backward replayed against its plain version, the loss, metrics and
   BatchNorm statistics after both train-mode passes against the same step
   on the plain cost volume, the gradients against the plain backward on
   the kernel forward (deterministic algorithms, biases printed both ways),
   ``cudnn.allow_tf32`` read inside the step (off), the warm step's ms;
   ``python -m ocflow_torch.train_unsupervised`` on the longrun config with
   ``model: flownetc`` cut to 44 samples and 1 epoch (exit 0, CSV rows,
   BatchNorm statistics moved in the best checkpoint, a finite test EPE,
   its wall time); the eval forward of the seven nets that launch no kernel
   of this repository (``flownets``, ``eflownet``, ``eflownet2``,
   ``occ/simple``, ``occnets``, ``flow_occ/simple``, ``flowoccnets``):
   no launches, the card against the CPU at 2x64x128 (1e-4 of max|out|),
   ms per forward.

14. the cost volume past d = 10 on the general kernels
   (``csrc/cost_volume_any.cu``) at d = 11, 12, 16 and 20, at 8x64x112x256 and
   8x196x7x16, forward and backward, fp32 and bf16, each call against its
   plain version (fp32 1e-4 of max|plain|, bf16 2^-6) and timed beside its
   bound (bytes at 3.35 TB/s or operations at 67 TFLOP/s) and the plain
   version; a FlowNetC built with displacement 12 (B=8, 448x1024, fp32,
   eval): the launches of its forward and input gradient (one general
   forward, one general backward), its 8x256x56x128 call replayed and
   timed; a FlowNetCV with displacement 12 built as the supervised CLI
   builds it (``model: pwc``), one fp32 flow train step at B=8 448x1024:
   its launches (five general forward, five general backward, nothing
   else), each of the ten calls replayed against its plain version, the
   warm step's ms and the general kernels' share of it. Then the
   inpainting slice at full width (448x1024, B=8, fp32, TF32 off):
   ``SyntheticInpainting`` made on the card against the CPU (frames
   1e-4, masks bit for bit) and its ms per sample; the three file-backed
   inpainting datasets on phase 11's trees (keys, shapes, coverage, zeroed
   holes); InpaintingNet's eval forward (card vs CPU at 2x64x128, 1e-4; ms),
   one supervised step on phase 11's Sintel tree resized to 448x1024 and one
   stage step on ``SyntheticInpainting`` (each: card vs CPU at 2x64x128,
   loss 1e-5 and statistics 1e-5 in fp32, gradients 1e-4 of max|grad| in
   fp64; at full size the launches (none), both TF32 flags read inside the
   step (off), the loss, the statistics moved, the warm step's ms and its
   kernel time by kind); OCFlowNet's forward (card vs CPU, the hard mask
   where the soft value is clear of 0.5; ms); ``python -m
   ocflow_torch.train`` on the inpainting net (a process of its own) and
   ``python -m ocflow_torch.train_unsupervised`` on
   ``configs/inpainting_gan_fullres.yaml`` cut to ``model: simple``, no GAN,
   B=8, 44 samples, 2 epochs (its panels decoded and equal to the drawn
   ones); ``python -m ocflow_torch.evaluate --task inpainting`` on
   ``SyntheticInpainting`` (24 samples) and the Sintel tree: PSNR and SSIM
   against float64 on the CPU from the same completed images (1e-5
   relative), SSIM at most 1, the metric pass's pairs/s.

15. the gated-conv GAN (``configs/inpainting_gan_fullres.yaml``: 448x1024,
   B=2, fp32, TF32 off; seeded nets, ``gamma`` 0.5): the blockwise
   attention against the dense one at 2x28672 tokens (the refine branch's,
   d=16, c=128; output and q, k, v gradients within 1e-4 of max|dense|;
   each path's ms and peak memory); InpaintSANet (remat off and on) and
   InpaintSANetOrg eval forwards on the card against the CPU (1e-4 of
   max|CPU|; the attention's token count; ms); one GAN step card vs CPU
   (``d_loss``, ``g_loss`` 1e-4 relative; the largest gradient gap
   printed); the flagship step with remat on and off: its launches (none),
   both TF32 flags read inside every forward (off), the median step ms, the
   peak memory, a ``torch.profiler`` split into the attention, convolutions,
   BatchNorm and the rest; ``python -m ocflow_torch.train_unsupervised`` on
   the config cut to 10 samples and 1 epoch (a process of its own: CSV
   rows with the GAN metrics, the pair checkpoint, the exported generator,
   finite test metrics, wall time, peak memory); ``python -m
   ocflow_torch.evaluate --task inpainting --model gated`` on the exported
   generator (pairs/s).

16. the two-stage and joint pipelines, the VGG loss and FID:
   ``configs/two_stage_gc_fullres.yaml`` as shipped (SimpleOcclusionNet +
   InpaintSANet with remat, B=2, 448x1024) cut to 12 samples, 2 epochs and
   ``unfreeze_epoch: 1`` through ``train_unsupervised``'s ``main``: the
   inpainter equal to the seeded one bit for bit after epoch 0 and moved
   after epoch 1, the pair checkpoint, wall time, ms a step, peak memory;
   one GC step card vs CPU at 2x64x128 (metrics 1e-4 relative); the GC
   step at 448x1024 with ``pixel-wise`` and ``vgg`` (the seeded VGG16):
   launches (none), TF32 read inside (off), ms, peak memory, the kernel
   time split into the attention, convolutions, BatchNorm and the rest;
   the joint flow+occlusion+inpainting step (BASELINE's configuration #5:
   FlowOccNetCV + InpaintingNet, B=16, 320x1216, ~30% of the pixels valid)
   in bf16: its launches (5 cost volumes, 5 backward, nothing else), every
   call replayed against its plain version (2^-6) and timed beside its
   bound; in fp32 (deterministic algorithms): every call replayed (1e-4),
   the loss against the plain cost volume (1e-5), the gradients against
   the plain backward on the kernel forward (1e-4 of each net's
   max|grad|); the bf16 gradient against the fp32 one, relative L2 by part
   (``JOINT_BF16_L2``), and the same reading without the occlusion head's
   scale, printed; each step's ms and peak memory; ``configs/unsupervised.yaml`` as
   shipped and its ``with_gt_flow: false`` copy, 1 epoch each, through
   the CLI (processes of their own); ``evaluate --task inpainting --model
   gated --with_fid --allow_random_fid`` on phase 15's exported generator,
   card against CPU on the same 8 images (the pool features 1e-4 of
   max|CPU|, the FIDs 1e-4 relative), then on 16 pairs at 448x1024 with
   InceptionV3's ms a batch.

17. trained weights from outside the port and the user's own frames:
   seeded checkpoints in the original code's layouts (a Lightning
   FlowNetCV under ``model.`` with the original's dead ``deconv2``; a
   combined Lightning GAN, ``generator.`` InpaintSANet + ``discriminator.``
   with torch's ``weight_orig`` / ``weight_u`` / ``weight_v``) through
   ``python -m ocflow_torch.tools.import_weights`` (a process of its own:
   its wall time, the manifest, every sha256, the imported tensors equal to
   the seeded nets' bit for bit); the imported FlowNetCV served by
   ``fast_apply`` at B=8 448x1024, bf16 and W8A8 (scales from the seed-1
   batch): every kernel call replayed against its plain version at phase
   3's and 4's tolerances, the launches (5 / 59 bf16, 5 / 24 / 35 W8A8,
   staged 53, 18, 35), fp32 ``fast_apply`` against the eager fp32 forward
   (1e-4 of max), both forwards' ms in turns; the imported generator loaded
   by ``load_model`` on the card against the CPU at 1x256x512 (1e-4);
   ``python -m ocflow_torch.infer --iext jpg --save_flo --checkpoint
   <imported>`` on the committed 436x1024 JPEG frames
   (``tests/data/jpeg_frames.json``): each frame's decode against its
   recorded sha256 of the JAX ``read_gen`` decode, each ``.flo`` within
   1e-4 of max|flow| of the eager forward on the decoded pair, launches per
   pair; the same ``infer`` run on the committed progressive copies of those
   frames (``infer_jpg_progressive``: their decodes against the baseline
   frames' sha256, the ``.flo`` files against the eager forward, launches
   per pair, and the largest difference to the baseline run's ``.flo``
   files, 0 expected); the committed 436x1024 CMYK frame against its
   sha256; the first frame written as 16-bit P6 and as ASCII P3 and read
   back bit for bit; a FlyingChairs-layout pair of 16-bit P6 frames through
   ``build_dataset`` and the ``DataLoader`` (the fused pair path gives None,
   the samples equal the generic path's of the 8-bit frames bit for bit);
   the host decode ms of a 436x1024 frame as JPEG, as an Adam7 PNG
   (written by this file's writer), as a plain PNG, as progressive and CMYK
   JPEG, as 16-bit P6 and ASCII P3, on 1 and 6 threads; the wall time the
   progressive and PNM checks added.

18. data parallelism (``ocflow_torch.parallel``) over two gloo ranks that
   share cuda:0 (NCCL refuses two ranks on one GPU), spawned with a
   ``file://`` store: gloo's collectives on CUDA tensors (all_reduce and
   broadcast direct, all_gather and the halo's point-to-point through the
   host; gloo's own all_gather on CUDA probed and printed); bf16 and W8A8
   ``fast_apply_sharded`` at B=8 448x1024 (a block of 4 a rank): each
   rank's launches (5 / 59, 53 staged; 5 / 24 / 35, 18 and 35 staged), its
   block against the single-process ``fast_apply`` on it and the gathered
   batch against the blocks' forwards (bit for bit expected, held at 2^-6
   of max|flow|); the fp32 training step on each rank's block against the
   single-process per-block oracle (``_blocks``: the forward per block, the
   losses on the whole batch; deterministic algorithms in both): metrics
   1e-5 relative, gradients 1e-4 of max|grad|; every kernel call of one
   fp32 step (rank 0) and one bf16 step (rank 1) replayed against its plain
   version; each rank's launches of one bf16 step (10 / 5 / 72 / 31 / 0);
   three bf16 Adam steps and the ranks' parameters equal bit for bit (and
   their checksums); the single-process B=8 bf16 step (rank 0 alone) and
   the sharded step on both ranks at once timed; ``spatial_cost_volume``
   at d=4 (8x32x112x256) and d=10 (8x256x56x128), fp32, forward and
   backward against the single-device kernel (1e-4 of max, bit for bit
   printed; 1 forward and 1 backward launch a rank); then ``torchrun
   --standalone --nproc_per_node 2 -m ocflow_torch.train_unsupervised
   --dist_backend gloo`` on the longrun config cut to 20 samples and 1
   epoch (rank 0 alone prints, writes the CSV, the events and the
   checkpoint; ``fit`` checks the replicas equal at its end), and
   ``python -m ocflow_torch.tools.dryrun_multigpu --nproc 2 --backend
   gloo``. A failure in any rank fails the phase.

19. global batch statistics (synced BatchNorm, the eager FlowNetCV's
   feature moments: ``parallel.synced_stats``) in phase 18's two ranks,
   deterministic algorithms, every regime's step on each rank's block
   against the single-process step on the whole batch from the same seeded
   weights: the supervised ``pwc`` step (C7), ``flowoccnetc`` (d=10) and
   ``flownet`` and the unsupervised ``flownetc`` at 448x1024 B=8 (4 a rank);
   the GAN step on ``configs/inpainting_gan_fullres.yaml`` as shipped (B=2,
   1 a rank, remat; SGD at its rates); the GC step on
   ``configs/two_stage_gc_fullres.yaml`` (B=2) before and after the
   inpainter unfreezes; the joint step at BASELINE's configuration #5 (B=16
   320x1216, 8 a rank) in fp32 and bf16. fp32: metrics 1e-4 relative,
   running statistics 1e-5 of their max, the zoo's gradients 1e-3 of the
   net's max|grad|; the GAN's, GC's and joint step's gradients against the
   single-process fp64 step (the joint one on the plain cost volume), per
   net within 2x the single-process fp32 step's distance from it plus 1e-3
   (one process's own fp32 gradient lies ~1e-2 from fp64 there); the bf16
   joint loss 2e-2. Each rank's launches (pwc 5 / 5, flowoccnetc 1 / 1,
   flownet 5 / 5, flownetc 2 / 1, joint 5 / 5, GAN and GC none), every
   kernel call of the fp32 steps replayed against its plain version on rank
   0 and of the bf16 step on rank 1, the replicas bit for bit after a second
   step (parameters and buffers), the collectives of a step counted
   (``Mesh.psum``, every ``all_reduce``), each rank's step ms beside the
   single-process step's (for the record: the ranks share one card); then
   ``torchrun --standalone --nproc_per_node 2 -m
   ocflow_torch.train_unsupervised --dist_backend gloo`` on
   ``configs/inpainting_gan_fullres.yaml`` cut to 8 samples and 1 epoch
   (rank 0 alone prints, writes the CSV and the events and exports the
   generator; ``fit`` checks both nets' replicas equal at its end).

Phases 6 and 8 hold their references (the eager fp32 forward, the eager
step) on the plain cost volume; phase 6 also holds the eager forward on the
cost-volume kernel (5 launches) against it.

Prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}
# kernel vs plain version, relative to max |plain|: fp32 differs only in
# summation order; bf16 may differ by a rounding step of the final store
# (and of intermediate stores inside a conv group): two bf16 ulps of the
# largest value. The int8 kernel is exact (integer sums, the same fp32
# epilogue operations in the same order): no tolerance.
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
TOL_REASON = {torch.float32: "1e-4 of max|plain|: summation order",
              torch.bfloat16: "2^-6 of max|plain|: two bf16 ulps of rounding"}
# fast_apply fp32 vs eager fp32 (cuDNN, TF32 off), relative to max |eager|:
# summation order through ~30 layers
E2E_FP32_TOL = 1e-4
# phase 9: FlowNetC's fp32 gradient with respect to its input (TF32 off),
# through the d=10 kernels, vs the same gradient with the plain backward in
# place of the backward kernel on the same forward, both with cuDNN's
# deterministic algorithms, max-abs over max|grad|: the two differ in the
# cost-volume backward's summation order only, carried back through
# conv3..conv1's VJPs, as the forward's 1e-4 (2.3e-7-2.9e-7 measured on
# the H100). The gradient moves further when anything else changes: with
# cuDNN's default algorithms it read 3.2e-4 from the reference, with the
# plain cost volume's forward 9.2e-4 (the forward's summation order flips
# a few LeakyReLU slopes), which is why the check holds the forward and
# cuDNN's algorithms fixed; both readings are printed beside it.
GRAD_FP32_TOL = 1e-4
# fast_apply bf16 vs fp32, relative L2 error: the random-weight network
# amplifies bf16 rounding (0.006-0.014 measured on the CPU plain path at
# 64x128)
E2E_BF16_REL_L2 = 0.05
# W8A8 fast_apply vs the eager fp32 forward, quarter-flow max-abs relative
# to max |flow_quarter|. The JAX package's bounds (0.05 decoders,
# tests/test_pwc_fast.py:546; 0.1 with the encoder and context chain, :673)
# hold its tests' small shape; this random-weight net at full size is
# noisier while every int8 call equals its plain version bit for bit. The
# plain path on the CPU at the largest shape it runs in a minute
# (`python -m ocflow_torch.tools.q8_error --batch 4 --dtype float32
# --device cpu`, 4x448x1024) measured 0.079 and 0.108 on the init's earlier
# draws; the bounds round those up by a quarter to a third. Re-measured on
# the H100 after the init came to draw from flax's distribution (this
# phase's line, B=8): 0.0538 and 0.1127; the bounds stand.
E2E_Q8_TOL = {"w8a8": 0.1, "w8a8_enc_ctx": 0.15}
# training, one Adam step at 448x1024 B=8 (TF32 off), the fused fp32 step vs
# the eager step (fast_forward='off') in fp64, same weights and batch. The
# fused step is not deterministic (the range-map splat's index_add_, the
# warps' scatter-add backward and cuDNN's backward add with atomics), and
# gradients are sums of many cancelling terms, so summation order moves them
# far more than it moves the activations. On the init's earlier draws the
# check held the fused step against the eager fp32 step; measured on the
# H100 (the witnesses this phase prints), max-abs over max|grad| in the
# worst tensor: the fused step run to run 3.4e-3-8.1e-3, the eager step run
# to run 1.6e-2-1.65e-2, the eager step against itself with cuDNN's
# deterministic algorithms 4.7e-3-1.47e-2, fused vs eager 2.6e-2-3.5e-2 over
# five runs, always on a bias (deconv5, conv6); the whole gradient's
# relative L2 up to 1.2e-3 (fused), 2.0e-3 (eager) and 1.6e-3-3.0e-3 between
# them; metrics 2e-7-2.0e-6. On the seeded init (flax's draws) fused vs
# eager fp32 read 6.27e-2 once (upfeat6.bias), past the bound: the eager
# fp32 step is no exact reference (on the CPU at 2x64x128 it reads 1.27e-3
# from its fp64 step where the fused step reads 2.3e-4,
# tests/test_torch_train.py), so the check holds the fused step against
# the fp64 one and prints the fp32 gaps beside it. The bounds are ~1.7x the
# largest fused-vs-eager fp32 reading on the earlier draws:
TRAIN_METRIC_REL = 1e-4      # loss and every metric, relative
TRAIN_GRAD_REL_L2 = 0.06     # per parameter tensor, relative L2
TRAIN_GRAD_MAX_REL = 0.06    # per parameter tensor, max-abs over max|grad|
TRAIN_GRAD_GLOBAL = 6e-3     # the whole gradient, relative L2
# a sanity check only (the step ran with the same lr on the same weights):
# Adam's first step moves each weight by about lr = 1e-4 whatever |grad|,
# so two runs differ by at most 2 lr, a sign flip of a near-zero gradient
TRAIN_PARAM_ATOL = 5e-4
# bf16 step vs fp32 step, relative L2 of the whole gradient: bf16 rounding
# through a random-weight network (0.122 measured on the H100; per tensor
# median 0.21, up to 0.93 on tensors whose gradient is near zero)
TRAIN_BF16_REL_L2 = 0.2

# phase 10: the fit loop's cuts of configs/longrun_synthetic.yaml (full
# width: 448x1024, B=8): 44 samples split 35 / 4 / 5, so 4 train steps per
# epoch, a ragged val batch of 4 and a ragged test batch of 5
FIT_CUTS = {"dataset_size": 44, "max_epochs": 2, "log_every_n_steps": 1,
            "log_image_every_epoch": 1}
# cuda samples vs the same samples generated on the CPU by the port: the
# blur's and the remap's summation order (the port vs OpenCV on the CPU
# reads <= 1e-5)
FIT_DATA_TOL = {"images": 1e-4, "flow": 1e-4}
# a train step's launches (PERF.md §3): cost volume 10, its backward 5, 72
# bf16 conv launches all staged (31 conv_group_diff + 41 of the backward
# decode), no int8; the conv_group_diff backward on the kernels: a dX
# launch for each of a group's five growth blocks and one for its inputs
# (5 groups: 30), a dW launch for each conv (31), no cuDNN VJP
FIT_STEP_LAUNCHES = {"cost_volume": 10, "cost_volume_bwd": 5, "conv_group": 72,
                     "conv_group_diff": 31, "conv_group_q8": 0, "gemm_probe": 0,
                     "conv_group_staged": 72, "conv_group_q8_staged": 0,
                     "conv_group_q8_tma": 0, "conv_group_diff_dx": 30,
                     "conv_group_diff_dw": 31, "conv_group_diff_vjp": 0}
BWD_STEP_LAUNCHES = {k: FIT_STEP_LAUNCHES[k] for k in (
    "conv_group_diff_dx", "conv_group_diff_dw", "conv_group_diff_vjp")}
# evaluate on the restored state vs the in-memory state, per metric,
# relative: the same weights; the range map's index_add_ adds with atomics
FIT_EVAL_REL = 1e-6


# kernels with no single PyTorch call computing the same function
NO_LIBRARY = {
    "cost_volume": "no single PyTorch call computes a local correlation",
    "cost_volume_bwd": "no single PyTorch call computes its adjoint",
    "conv_group_q8": "PyTorch has no int8 convolution (bf16 cuDNN of the same "
                     "convs is printed beside its time)",
    "conv_group_q8_tma": "PyTorch has no int8 convolution (bf16 cuDNN and the bf16 TMA "
                         "kernel on the same convs are printed beside its time)",
}


def _detach(a):
    if isinstance(a, torch.Tensor):
        return a.detach()
    if isinstance(a, (list, tuple)):
        return type(a)(_detach(x) for x in a)
    return a


def _record(targets, run):
    """Call ``run()`` and return the (name, args) of every call of the
    functions ``targets`` (``(module, name)`` pairs) meanwhile, in order,
    args detached from any graph."""
    calls = []
    saved = {t: getattr(*t) for t in targets}

    def recorder(t):
        def rec(*args):
            calls.append((t[1], _detach(args)))
            return saved[t](*args)
        # shares the wrapped function's attributes: a wrapper that counts
        # its launches through its own module-level name keeps counting
        rec.__dict__ = saved[t].__dict__
        return rec

    for t in targets:
        setattr(*t, recorder(t))
    try:
        run()
    finally:
        for t in targets:
            setattr(*t, saved[t])
    torch.cuda.synchronize()
    return calls


def _timed_once(fn):
    """``fn()`` and its device ms, one call (no warm-up, no loop)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _cv_cost(f1, d=4):
    """Bytes (f1, f2 read once, the (2d+1)^2 maps written once) and
    operations (a multiply and an add per shift, channel and pixel) of a
    cost-volume forward."""
    b, c, h, w = f1.shape
    k = (2 * d + 1) ** 2
    nbytes = (2 * b * c * h * w + k * b * h * w) * f1.element_size()
    return nbytes, 2 * k * b * c * h * w


def _cg_cost(inputs, group, outs):
    b = inputs[0].shape[0]
    ho, wo = outs[0].shape[2:]
    item = inputs[0].element_size()
    nbytes = sum(t.numel() for t in inputs) * item
    nbytes += sum(w.numel() for w in group.weights) * item
    nbytes += sum(o.numel() for o in outs) * item
    flops = sum(2 * w.numel() * b * ho * wo for w in group.weights)
    return nbytes, flops


def _cg_bwd_cost(inputs, group, outs):
    """Bytes and operations of a conv group's backward, whatever route runs
    it (the dX and dW kernels of ``csrc/conv_group_tma.cu`` and
    ``csrc/conv_group_dw.cu``, or the retained VJP route's cuDNN conv
    VJPs): every conv's dX and dW, each as many multiply-adds as its
    forward; the output cotangents, inputs and weights read once, dX and
    dW written once."""
    nbytes, flops = _cg_cost(inputs, group, outs)
    item = inputs[0].element_size()
    nbytes += (sum(t.numel() for t in inputs) + sum(w.numel() for w in group.weights)) * item
    return nbytes, 2 * flops


def _q8_cost(inputs, group, outs):
    """Bytes and int8 operations of a W8A8 group's int8 launches: the int8
    input codes, int8 weights and fp32 epilogue vectors read once, the
    emitted blocks written once."""
    b = inputs[0].shape[0]
    ho, wo = outs[0].shape[2:]
    int8 = [j for j, r in enumerate(group.int8_read) if r]
    nbytes = sum(t.numel() for t in inputs)
    nbytes += sum(group.weights[j].numel() + 8 * group.specs[j].cout for j in int8)
    nbytes += sum(o.numel() * o.element_size() for o in outs)
    ops = sum(2 * group.weights[j].numel() * b * ho * wo for j in int8)
    return nbytes, ops


def _emit_all(group):
    """The same group returning every block (for block-by-block checks)."""
    return dataclasses.replace(group, specs=tuple(
        dataclasses.replace(s, emit=True) for s in group.specs))


def _library_conv(inputs, group, stripe_outs):
    """Per spec, F.conv2d over the materialized concat of its reads (the
    blocks taken from a plain run), summed: the cuDNN yardstick."""
    import torch.nn.functional as F

    from ocflow_torch.kernels.conv_chain import conv_group_plain

    blocks = list(inputs) + conv_group_plain(inputs, _emit_all(group))
    calls = []
    for s, w, b in zip(group.specs, group.weights, group.biases):
        xcat = torch.cat([blocks[r] for r in s.reads], 1).contiguous()
        bias = b.to(group.dtype)
        calls.append((xcat, w, bias, s))

    def run():
        for xcat, w, bias, s in calls:
            F.conv2d(xcat, w, bias, stride=s.stride, padding=s.dilation,
                     dilation=s.dilation)

    return run


def _bf16_conv_like_q8(inputs, group, blocks):
    """bf16 ``F.conv2d`` (cuDNN) of the same shapes as a W8A8 group's
    int8-read convs, on the codes as bf16: context for the int8 kernel's
    time (PyTorch has no int8 convolution)."""
    import torch.nn.functional as F

    blocks = list(inputs) + list(blocks)
    calls = []
    for j, s in enumerate(group.specs):
        if group.int8_read[j]:
            xcat = torch.cat([blocks[r] for r in s.reads], 1).bfloat16().contiguous()
            calls.append((xcat, group.weights[j].bfloat16(), s))

    def run():
        for xcat, w, s in calls:
            F.conv2d(xcat, w, None, stride=s.stride, padding=s.dilation,
                     dilation=s.dilation)

    return run


def _check_float(kind, args, dtype, max_err, label=""):
    """Replay one cost-volume (forward or backward) or bf16/fp32 conv-group
    call through the kernel and the plain version; hold them within
    KERNEL_TOL. A ``conv_group_diff`` call replays its forward: the conv
    group with every block emitted."""
    from ocflow_torch.kernels import conv_chain, cost_volume as cv_mod

    if kind == "cost_volume":
        got = [cv_mod.cost_volume(*args)]
        ref = [cv_mod.cost_volume_plain(*args)]
        shape = tuple(args[0].shape)
    elif kind == "cost_volume_bwd":
        got = cv_mod.cost_volume_backward(*args)
        ref = cv_mod.cost_volume_backward_plain(*args)
        shape = tuple(args[0].shape)
    elif kind == "conv_group_diff":
        inputs = args[0]
        group = _diff_group(*args)
        got = conv_chain.conv_group(inputs, group)
        ref = conv_chain.conv_group_plain(inputs, group)
        shape = tuple(inputs[0].shape)
    else:
        # bf16: every block (each conv's launch, the TMA kernel's included)
        inputs, group = args
        group = _emit_all(group) if dtype == torch.bfloat16 else group
        got = conv_chain.conv_group(inputs, group)
        ref = conv_chain.conv_group_plain(inputs, group)
        shape = tuple(inputs[0].shape)
    torch.cuda.synchronize()
    if kind.startswith("conv_group") and dtype == torch.bfloat16:
        # each block within 2^-6 of its own max|plain|
        for j, (g, r) in enumerate(zip(got, ref)):
            e, sc = (g.float() - r.float()).abs().max().item(), r.float().abs().max().item()
            if not e <= KERNEL_TOL[dtype] * max(sc, 1e-6):
                raise AssertionError(f"{kind} {shape} block {j}: {e} > 2^-6 of {sc}")
    err = max((g.float() - r.float()).abs().max().item() for g, r in zip(got, ref))
    scale = max(r.float().abs().max().item() for r in ref)
    # gradients of a mean over millions of pixels are ~1e-6: no floor there
    tol = KERNEL_TOL[dtype] * max(scale, 1e-30 if kind == "cost_volume_bwd" else 1e-6)
    print(f"check {label}{kind} {str(dtype)[6:]} {shape}: max_abs_err "
          f"{err:.3e} rel {err / max(scale, 1e-30):.3e} max|plain| "
          f"{scale:.3e} tol {tol:.3e} ({TOL_REASON[dtype]})")
    if not err <= tol:
        raise AssertionError(f"{kind} {shape} {dtype}: {err} > {tol}")
    max_err[kind] = max(max_err[kind], err)


def _bwd_launch(kind, args):
    """A recorded launch of ``conv_group_diff``'s backward kernels as
    ``(run the kernel, run its plain version)`` on the same inputs, each
    returning its outputs as a tuple (a dX launch into a new tensor)."""
    from ocflow_torch.kernels import conv_chain

    if kind == "conv_adjoint":
        parts, gout, act, out, tma = args
        return (lambda: (conv_chain.conv_adjoint(parts, gout, act, torch.empty_like(out), tma),),
                lambda: (conv_chain.adjoint_plain(parts, gout, act, out.dtype),))
    return lambda: conv_chain.conv_dw(*args), lambda: conv_chain.dw_plain(*args)


def _check_bwd(kind, args, max_err, label=""):
    """Replay one launch of ``conv_group_diff``'s backward kernels (bf16)
    twice and its plain version once: a dX launch (``conv_adjoint``,
    ``csrc/conv_group_tma.cu``'s adjoint epilogue) bit for bit the block the
    step stored, a dW launch (``conv_dw``, ``csrc/conv_group_dw.cu``) its
    own replay bit for bit; every output within 2^-6 of its max|plain|."""
    run, plain = _bwd_launch(kind, args)
    got, again, refs = run(), run(), plain()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    if kind == "conv_adjoint":
        same = same and torch.equal(got[0], args[3])
        what = f"dX over {sum(t.shape[1] for t in args[0][0][0])} channels"
        shape = tuple(args[3].shape)
    else:
        what = f"dW, db over {sum(t.shape[1] for t in args[0])} read channels"
        shape = tuple(args[1].shape)
    err, scale = 0.0, 0.0
    for gt, r in zip(got, refs):
        e, sc = (gt.float() - r.float()).abs().max().item(), r.float().abs().max().item()
        if not e <= KERNEL_TOL[torch.bfloat16] * max(sc, 1e-30):
            raise AssertionError(f"conv_group_diff backward {what} {shape}: {e} > 2^-6 of {sc}")
        err, scale = max(err, e), max(scale, sc)
    print(f"check {label}conv_group_diff_bwd {what} {shape}: max_abs_err {err:.3e} max|plain| "
          f"{scale:.3e} (2^-6 of max|plain| each); replayed bit for bit: {same}")
    if not same:
        raise AssertionError(f"conv_group_diff backward {what} {shape}: replay differs")
    max_err["conv_group_diff_bwd"] = max(max_err["conv_group_diff_bwd"], err)


def _check_q8(args, max_err, label=""):
    """Replay one W8A8 group call, every block emitted, through the kernels
    (on new stripes) and the plain version. int8-read convs: codes and bf16
    values equal; the bf16-read conv (bf16 kernel): within 2^-6 of
    max|plain|. In a channels-innermost group each int8 conv is then run
    again alone on the blocks the replay filled (:func:`_check_q8_tma_convs`).
    Returns the plain version's device ms (one call)."""
    from ocflow_torch.kernels import conv_chain_q8

    inputs, group = args
    every = _emit_all(group)
    st = conv_chain_q8.stripes_q8(inputs, every)
    got = conv_chain_q8.run_group_q8(st, every)
    ref, plain_ms = _timed_once(lambda: conv_chain_q8.conv_group_q8_plain(inputs, every))
    shape = tuple(inputs[0].shape)
    kernel = "conv_group_q8_tma" if group.nhwc else "conv_group_q8"
    ndiff = ncodes = 0
    err8 = err16 = 0.0
    for j, (g, r) in enumerate(zip(got, ref)):
        if g.dtype != r.dtype or g.shape != r.shape:
            raise AssertionError(f"q8 block {j}: {g.dtype} {g.shape} vs {r.dtype} {r.shape}")
        d = (g.float() - r.float()).abs()
        if group.int8_read[j]:
            ndiff += int((g != r).sum().item())
            ncodes += g.numel() if g.dtype == torch.int8 else 0
            err8 = max(err8, d.max().item())
        else:
            scale = r.float().abs().max().item()
            tol = KERNEL_TOL[torch.bfloat16] * max(scale, 1e-6)
            if not d.max().item() <= tol:
                raise AssertionError(f"q8 bf16-read block {j} {shape}: {d.max().item()} > {tol}")
            err16 = max(err16, d.max().item())
    print(f"check {label}{kernel} {shape} ({len(group.specs)} convs, "
          f"{group.n_int8} int8): differing int8-read outputs {ndiff} "
          f"({ncodes} codes), int8-read max_abs_err {err8:.3e} (exact "
          f"required); bf16-read max_abs_err {err16:.3e} (2^-6 of max|plain|); "
          f"plain {plain_ms:.2f} ms")
    if ndiff:
        raise AssertionError(f"{kernel} {shape}: {ndiff} outputs differ")
    max_err[kernel] = max(max_err[kernel], err8)
    max_err["conv_group"] = max(max_err["conv_group"], err16)
    if group.nhwc:
        _check_q8_tma_convs(st, every, max_err, label)
    return plain_ms


def _check_q8_tma_convs(st, group, max_err, label=""):
    """Every int8 conv of a channels-innermost W8A8 group (on
    ``csrc/conv_group_q8_tma.cu``), run alone on the stripes ``st`` a run of
    the group filled: its block poisoned (int8 -128, no code's value; bf16
    NaN), the kernel run into it, then held against the plain version on
    the same reads, bit for bit."""
    from ocflow_torch.tools.conv_ablation import q8_conv_checks

    t0, ndiff, err = time.perf_counter(), 0, 0.0
    cases = q8_conv_checks(st, group)
    for c in cases:
        c["out"].fill_(-128 if c["out"].dtype == torch.int8 else float("nan"))
        c["run"]()
        ref = c["plain"]()
        torch.cuda.synchronize()
        if not torch.equal(c["out"], ref):
            ndiff += int((c["out"] != ref).sum().item())
        err = max(err, (c["out"].float() - ref.float()).abs().max().item())
    shape = tuple(st.inputs[0].shape)
    print(f"check {label}conv_group_q8_tma {shape}: {len(cases)} int8 convs run alone on "
          f"the blocks the replay filled, differing outputs {ndiff}, max_abs_err {err:.3e} "
          f"(exact required; {time.perf_counter() - t0:.1f} s)")
    if ndiff or not err == 0.0:
        raise AssertionError(f"conv_group_q8_tma {shape}: {ndiff} differ, {err}")
    max_err["conv_group_q8_tma"] = max(max_err["conv_group_q8_tma"], err)


def _tma_conv_timing(card, calls, max_err, per):
    """Every conv of the bf16 forward's ``conv_group`` calls that the TMA
    kernel (``csrc/conv_group_tma.cu``) takes, replayed alone on the blocks
    a kernel run filled: held against its plain version (one fp32 conv, one
    bf16 rounding) within 2^-6 of max|plain|, and timed queued behind a spin
    (``spike_int8.queued_ms``: the card's time, not the host's) beside the
    staged kernel of PR 5 on the same conv, one cuDNN call (bf16
    ``F.conv2d`` over the concat of its reads, with its bias) and its bound
    (reads, weights and output moved once; 2 x MACs at the bf16 peak)."""
    import torch.nn.functional as F

    from ocflow_torch.bench import cuda_ms
    from ocflow_torch.kernels import conv_chain
    from ocflow_torch.tools.spike_int8 import queued_ms

    p, n_all = per["conv_group_tma"], 0
    for kind, args in calls:
        if kind != "conv_group":
            continue
        inputs, group = args
        blocks = list(inputs) + conv_chain.conv_group(inputs, _emit_all(group))
        b, (ho, wo) = inputs[0].shape[0], blocks[-1].shape[2:]
        g = dict.fromkeys(("ms", "staged_ms", "library_ms", "plain_ms", "bound_ms"), 0.0)
        n = 0
        for j, s in enumerate(group.specs):
            reads = [blocks[r] for r in s.reads]
            segs = conv_chain.merge_segments(reads)
            if not (conv_chain.is_tma(group.dtype, s, (ho, wo)) and conv_chain._tma_aligned(segs)):
                continue
            out = torch.empty((b, s.cout, ho, wo), dtype=group.dtype, device=inputs[0].device)
            out_s = torch.empty_like(out)
            w, bias = group.weights[j], group.biases[j]
            xcat = torch.cat(reads, 1)

            def run():
                conv_chain.launch_tma(segs, group.packed[j], bias, out, s,  # noqa: B023
                                      "chip_smoke conv_group_tma", group.tma[j])  # noqa: B023

            def plain():
                y = F.conv2d(xcat.float(), w.float(), bias, padding=1)  # noqa: B023
                return (F.leaky_relu(y, 0.1) if s.act else y).to(group.dtype)  # noqa: B023

            run()
            ref = plain()
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            if not err <= KERNEL_TOL[torch.bfloat16] * max(scale, 1e-6):
                raise AssertionError(f"conv_group_tma {tuple(inputs[0].shape)} conv {j}: "
                                     f"{err} > 2^-6 of {scale}")
            max_err["conv_group_tma"] = max(max_err["conv_group_tma"], err)
            g["ms"] += queued_ms(run, 20)[0]
            g["staged_ms"] += queued_ms(lambda: conv_chain.launch_conv(  # noqa: B023
                reads, group.packed[j], bias, out_s, s, "chip_smoke staged",  # noqa: B023
                staged=True), 20)[0]
            b16 = bias.to(group.dtype)
            g["library_ms"] += queued_ms(lambda: F.conv2d(  # noqa: B023
                xcat, w, b16, padding=1), 20)[0]  # noqa: B023
            g["plain_ms"] += cuda_ms(plain, 3)
            nbytes = (sum(t.numel() for t in reads) + w.numel() + out.numel()) * 2
            flops = 2 * w.numel() * b * ho * wo
            b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[torch.bfloat16] * 1e3
            g["bound_ms"] += max(b_ms, o_ms)
            p["bytes_ms"] += b_ms
            p["ops_ms"] += o_ms
            n += 1
        if not n:
            continue
        n_all += n
        for k, v in g.items():
            p[k] += v
        print(f"time conv_group_tma bf16 {tuple(inputs[0].shape)} ({n} of {len(group.specs)} "
              f"convs, device time queued): kernel {g['ms']:.4f} ms, staged kernel (PR 5) "
              f"{g['staged_ms']:.4f} ms, cuDNN {g['library_ms']:.4f} ms, plain "
              f"{g['plain_ms']:.4f} ms, bound {g['bound_ms']:.4f} ms "
              f"({100 * g['bound_ms'] / g['ms']:.2f}% of bound) [{card}]")
    print(f"time conv_group_tma sum over the bf16 forward's {n_all} TMA convs (device time "
          f"queued): kernel {p['ms']:.4f} ms, staged kernel (PR 5) {p['staged_ms']:.4f} ms, "
          f"cuDNN {p['library_ms']:.4f} ms, bound {p['bound_ms']:.4f} ms "
          f"({100 * p['bound_ms'] / p['ms']:.2f}% of bound); max_abs_err "
          f"{max_err['conv_group_tma']:.3e} [{card}]")


def _q8_tma_conv_timing(card, calls, max_err, per):
    """Every int8 conv of the W8A8 forward's ``conv_group_q8`` calls (all on
    ``csrc/conv_group_q8_tma.cu``), timed queued behind a spin
    (``spike_int8.queued_ms``: the card's time, not the host's) beside, on
    the same convs, the staged int8 kernel (an NCHW copy of the stripe),
    the bf16 TMA kernel and one bf16 cuDNN call (the codes and int8 weights
    as bf16: the yardsticks W8A8 has to beat) and its bound (reads,
    weights, the epilogue's vectors and the output moved once; 2 x MACs at
    the int8 peak)."""
    from ocflow_torch.bench import cuda_ms
    from ocflow_torch.tools.conv_ablation import q8_conv_cases
    from ocflow_torch.tools.spike_int8 import queued_ms

    p, n_all, slower, t0 = per["conv_group_q8_tma"], 0, [], time.perf_counter()
    for inputs, group in calls:
        cases = q8_conv_cases(inputs, group)
        g = dict.fromkeys(("ms", "staged_ms", "bf16_tma_ms", "cudnn_ms", "plain_ms",
                           "bound_ms", "bytes_ms", "ops_ms"), 0.0)
        for c in cases:
            for key, fn in (("ms", c["run"]), ("staged_ms", c["staged"]),
                            ("bf16_tma_ms", c["bf16_tma"]), ("cudnn_ms", c["cudnn"])):
                g[key] += queued_ms(fn, 20)[0]
            g["plain_ms"] += cuda_ms(c["plain"], 1)
            for key in ("bound_ms", "bytes_ms", "ops_ms"):
                g[key] += c[key]
        n_all += len(cases)
        for k, v in g.items():
            p[k] += v
        shape = tuple(inputs[0].shape)
        if g["ms"] > g["bf16_tma_ms"]:
            slower.append(shape)
        print(f"time conv_group_q8_tma w8a8 {shape} ({len(cases)} int8 convs, device time "
              f"queued): kernel {g['ms']:.4f} ms ({100 * g['bound_ms'] / g['ms']:.2f}% of "
              f"bound), staged int8 kernel {g['staged_ms']:.4f} ms, bf16 TMA kernel "
              f"{g['bf16_tma_ms']:.4f} ms, bf16 cuDNN {g['cudnn_ms']:.4f} ms, plain "
              f"{g['plain_ms']:.4f} ms, bound {g['bound_ms']:.4f} ms [{card}]")
    print(f"time conv_group_q8_tma sum over the w8a8 forward's {n_all} int8 convs (device "
          f"time queued): kernel {p['ms']:.4f} ms, staged int8 kernel {p['staged_ms']:.4f} "
          f"ms, bf16 TMA kernel {p['bf16_tma_ms']:.4f} ms, bf16 cuDNN "
          f"{p['cudnn_ms']:.4f} ms, bound {p['bound_ms']:.4f} ms "
          f"({100 * p['bound_ms'] / p['ms']:.2f}% of bound); groups slower than the bf16 TMA "
          f"kernel: {slower or 'none'}; max_abs_err {max_err['conv_group_q8_tma']:.3e} "
          f"({time.perf_counter() - t0:.1f} s) [{card}]")


def _diff_group(inputs, weights, biases, specs):
    """The conv group a ``conv_group_diff`` call runs: every block emitted."""
    from ocflow_torch.kernels import conv_chain

    specs = [dataclasses.replace(s, emit=True) for s in specs]
    return conv_chain.prepare_group(weights, biases, specs, len(inputs),
                                    inputs[0].dtype, inputs[0].device)


def _eager_chain(inputs, weights, biases, specs):
    """The same chain as cuDNN convs over the materialized concat of each
    conv's reads: the library yardstick of ``conv_group_diff``."""
    import torch.nn.functional as F

    blocks, outs = list(inputs), []
    for s, w, b in zip(specs, weights, biases):
        y = F.conv2d(torch.cat([blocks[r] for r in s.reads], 1), w, b,
                     stride=s.stride, padding=s.dilation, dilation=s.dilation)
        y = F.leaky_relu(y, 0.1) if s.act else y
        blocks.append(y)
        outs.append(y)
    return outs


def _held_occlusion(run, mask=None):
    """``run()`` with the training step's range-map occlusion recorded
    (``mask`` None) or replaced by ``mask``; returns ``run()``'s result and
    the mask the step used."""
    from ocflow_torch.train import steps

    orig, box = steps.occlusion_from_back_flow, {}

    def occlusion(back_flow):
        box["mask"] = orig(back_flow) if mask is None else mask
        return box["mask"]

    steps.occlusion_from_back_flow = occlusion
    try:
        out = run()
    finally:
        steps.occlusion_from_back_flow = orig
    return out, box["mask"]


def _cv_bwd_cost(f1, d=4):
    """Bytes (g, f1, f2 read once; df1, df2 written once) and operations
    (a multiply and an add per shift, channel and pixel, for df1 and df2)
    of a cost-volume backward with (2d+1)^2 shifts."""
    b, c, h, w = f1.shape
    k = (2 * d + 1) ** 2
    nbytes = (k * b * h * w + 4 * b * c * h * w) * f1.element_size()
    return nbytes, 4 * k * b * c * h * w


class _PlainBackward(torch.autograd.Function):
    """A cost volume whose forward is ``forward_fn`` and whose backward is
    the plain version: the references of phase 9's input gradient."""

    @staticmethod
    def forward(ctx, f1, f2, d, forward_fn):
        ctx.save_for_backward(f1, f2)
        ctx.d = d
        return forward_fn(f1, f2, d)

    @staticmethod
    def backward(ctx, g):
        from ocflow_torch.kernels.cost_volume import cost_volume_backward_plain

        df1, df2 = cost_volume_backward_plain(*ctx.saved_tensors, g.contiguous(), ctx.d)
        return df1, df2, None, None


@contextlib.contextmanager
def _plain_eager_cost_volume(active: bool = True):
    """The eager FlowNetCV on the plain cost volume while inside (a
    reference that does not run the kernel it is held against)."""
    from ocflow_torch.kernels.cost_volume import cost_volume_plain
    from ocflow_torch.models import pwc_net

    saved = pwc_net.cost_volume
    if active:
        pwc_net.cost_volume = cost_volume_plain
    try:
        yield
    finally:
        pwc_net.cost_volume = saved


def _no_grad(model, x):
    with torch.no_grad():
        return model(x)


def _counters():
    from ocflow_torch.kernels import conv_chain, conv_chain_q8, cost_volume, gemm

    return {"cost_volume": cost_volume.cost_volume,
            "cost_volume_bwd": cost_volume.cost_volume_backward,
            "conv_group": conv_chain.conv_group,
            "conv_group_diff": conv_chain.conv_group_diff,
            "conv_group_q8": conv_chain_q8.conv_group_q8, "gemm_probe": gemm.gemm}


STAGED = ("conv_group", "conv_group_q8")  # wrappers that count staged launches too


# conv_group_diff's backward: its counters, by the names the train paths'
# launch dicts give them
BWD_COUNTERS = {"conv_group_diff_dx": "dx_launches", "conv_group_diff_dw": "dw_launches",
                "conv_group_diff_vjp": "vjp_calls"}


def _zero_counts():
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    for k in STAGED:
        counters[k].staged_launches = 0
        counters[k].tma_launches = 0
    for attr in BWD_COUNTERS.values():
        setattr(counters["conv_group_diff"], attr, 0)


def _read_counts(bwd=False):
    """Every launch counter now, with ``conv_group_staged`` (the bf16 conv
    launches of stride 1 and dilation 1: the staged or TMA kernel),
    ``conv_group_q8_staged`` (those of ``conv_group_q8``, the launches of
    ``csrc/conv_group_q8.cu``, on its staged kernel) and
    ``conv_group_q8_tma`` (the int8 launches on
    ``csrc/conv_group_q8_tma.cu``); ``bwd``: also ``conv_group_diff``'s
    backward (:data:`BWD_COUNTERS`: its dX launches on
    ``csrc/conv_group_tma.cu``, its dW launches on ``csrc/conv_group_dw.cu``,
    the VJP route's cuDNN VJPs)."""
    counters = _counters()
    counts = {k: fn.launches for k, fn in counters.items()}
    counts.update({f"{k}_staged": counters[k].staged_launches for k in STAGED})
    counts["conv_group_q8_tma"] = counters["conv_group_q8"].tma_launches
    if bwd:
        counts.update({k: getattr(counters["conv_group_diff"], attr)
                       for k, attr in BWD_COUNTERS.items()})
    return counts


def _count_launches(run, bwd=False):
    """``run()`` with every launch counter zeroed just before; the counts
    just after (``bwd``: :func:`_read_counts`'), and ``run()``'s result."""
    _zero_counts()
    out = run()
    torch.cuda.synchronize()
    return _read_counts(bwd), out


def _count_launches_tma(run, bwd=False):
    """:func:`_count_launches` with ``conv_group_tma`` too: the conv
    launches on the TMA kernel (``csrc/conv_group_tma.cu``), a part of
    ``conv_group_staged``."""
    counts, out = _count_launches(run, bwd)
    counts["conv_group_tma"] = _counters()["conv_group"].tma_launches
    return counts, out


def _rate(flops, ms, bound_ms):
    """Achieved TFLOP/s and share of the bound of one timed call."""
    return f"{flops / ms / 1e9:.1f} TFLOP/s, {100 * bound_ms / ms:.2f}% of bound"


def _grad_errors(got, ref):
    """Per parameter: relative L2 and max-abs over max|ref|; and the
    relative L2 of the whole gradient."""
    rel_l2 = {n: ((got[n] - r).norm() / r.norm().clamp_min(1e-30)).item()
              for n, r in ref.items()}
    max_rel = {n: ((got[n] - r).abs().max() / r.abs().max().clamp_min(1e-30)).item()
               for n, r in ref.items()}
    num = sum(((got[n] - r) ** 2).sum().item() for n, r in ref.items())
    den = sum((r ** 2).sum().item() for r in ref.values())
    return rel_l2, max_rel, (num / den) ** 0.5


def _worst(d):
    k = max(d, key=d.get)
    return f"{d[k]:.3e} ({k})"


def _train_phase(card, max_err, per, add, failures):
    """The training slice at 448x1024, B=8 (longrun_synthetic.yaml hparams,
    a seeded FlowNetCV and smooth seeded frames, seed 0): kernel calls vs
    plain, the fused fp32 step vs the eager fp64 step, bf16 vs fp32, launch
    counts, five bf16 Adam steps, timings. Returns the launch counts of one
    bf16 step and of one with a W8A8 backward decode."""
    from ocflow_torch.bench import (BATCH, HEIGHT, SEED, WIDTH, calibration_batch,
                                    cuda_ms, make_train_inputs, measure_train,
                                    train_hparams)
    from ocflow_torch.kernels import conv_chain, cost_volume as cv_mod
    from ocflow_torch.models import pwc_fast
    from ocflow_torch.models.pwc_net import DECODER_LEVELS, GROWTH
    from ocflow_torch.tools import train_profile
    from ocflow_torch.tools.spike_int8 import queued_ms
    from ocflow_torch.train import (TrainState, create_train_state,
                                    make_unsupervised_flow_step)

    dev = torch.device("cuda")
    hp_b = train_hparams()
    hp_f = {**hp_b, "compute_dtype": "float32"}
    state0, _, batch = make_train_inputs(BATCH, HEIGHT, WIDTH, dev, SEED, hp_b)
    model0, lr = state0.model, hp_b["learning_rate"]
    targets = [(pwc_fast, "cost_volume"), (pwc_fast, "conv_group"),
               (pwc_fast, "conv_group_diff"), (cv_mod, "cost_volume_backward"),
               (conv_chain, "conv_adjoint"), (conv_chain, "conv_dw")]
    names = {"cost_volume_backward": "cost_volume_bwd"}
    bwd_kinds = ("conv_adjoint", "conv_dw")

    def one_step(hp, record=False, mask=None, dtype=torch.float32):
        """One Adam step on a copy of the seed model: metrics, gradients,
        parameters after the step, (``record``) the kernel calls, and the
        step's range-map occlusion mask (``mask``: held at that mask);
        ``dtype=torch.float64`` on an fp64 copy of the weights and batch
        (eager only: the kernels take bf16 and fp32)."""
        m = copy.deepcopy(model0)
        if dtype == torch.float32:
            state = create_train_state(m, lr, device=dev)
        else:
            m = m.to(dtype)
            state = TrainState(m, torch.optim.Adam(m.parameters(), lr=lr))
        step, _ = make_unsupervised_flow_step(hp)
        box = {}

        def run():
            # the eager step (the fused step's reference) on the plain cost
            # volume, as before the eager FlowNetCV took the kernel
            with _plain_eager_cost_volume(hp.get("fast_forward") == "off"):
                box["metrics"] = step(state, {k: v.to(dtype) for k, v in batch.items()})[1]

        calls, occ = _held_occlusion(
            lambda: _record(targets, run) if record else run(), mask)
        torch.cuda.synchronize()
        grads = {n: p.grad.detach().clone() for n, p in m.named_parameters()}
        params = {n: p.detach().clone() for n, p in m.named_parameters()}
        metrics = {k: float(v) for k, v in box["metrics"].items()}
        return metrics, grads, params, calls, occ

    # 1. every kernel call of one fp32 step (pair + loss + backward) and of
    # one bf16 step, kernel vs plain
    torch.cuda.reset_peak_memory_stats()
    m32, g32, p32, calls32, occ32 = one_step(hp_f, record=True)
    if any(kind in bwd_kinds for kind, _ in calls32):
        raise AssertionError("the fp32 step's conv_group_diff backward left the VJP route")
    for kind, args in calls32:
        _check_float(names.get(kind, kind), args, torch.float32, max_err, "train ")
    mb, gb, _, calls_b, _ = one_step(hp_b, record=True)
    for kind, args in calls_b:
        if kind in bwd_kinds:
            _check_bwd(kind, args, max_err, "train ")
        else:
            _check_float(names.get(kind, kind), args, torch.bfloat16, max_err, "train ")
    calls_b = [(kind, args) for kind, args in calls_b if kind not in bwd_kinds]
    del calls32
    print(f"train: peak device memory over the fp32 and bf16 steps "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # 2. fused fp32 step vs the eager step in fp64, beside what the gap
    # between the fused and the eager fp32 step is made of: each step's
    # run-to-run spread (atomic adds), the eager step against itself with
    # cuDNN's deterministic algorithms (summation order alone), fused vs
    # eager with the fused run's occlusion mask held (the mask's share), and
    # the eager fp32 step's own distance from fp64
    eager = {**hp_f, "fast_forward": "off"}
    m64, g64, p64, _, occ64 = one_step(eager, dtype=torch.float64)
    me, ge, _, _, occ_e = one_step(eager)
    docc = (occ64 - occ32).abs()
    gaps = {"fused run to run": (g32, one_step(hp_f)[1]),
            "eager run to run": (ge, one_step(eager)[1])}
    torch.backends.cudnn.deterministic = True
    try:
        gaps["eager vs eager, deterministic cuDNN"] = (ge, one_step(eager)[1])
    finally:
        torch.backends.cudnn.deterministic = False
    gaps["fused vs eager, mask held"] = (g32, one_step(eager, mask=occ32)[1])
    gaps["fused vs eager"] = (g32, ge)
    gaps["eager vs eager fp64"] = (ge, g64)
    gaps["fused vs eager fp64"] = (g32, g64)
    errs = {what: _grad_errors(a, b) for what, (a, b) in gaps.items()}
    del gaps, ge
    for what, (rel_l2, max_rel, glob) in errs.items():
        print(f"train fp32 grads, {what}: rel_l2 {_worst(rel_l2)}, max-abs/max "
              f"{_worst(max_rel)}, global rel_l2 {glob:.3e}")
    rel_l2, max_rel, glob = errs["fused vs eager fp64"]
    print(f"train fp32 occlusion mask (soft, in [0, 1]), fused vs eager fp64: max-abs "
          f"{docc.max().item():.3e}, mean-abs {docc.mean().item():.3e}; eager fp32 vs "
          f"fp64 max-abs {(occ_e - occ64).abs().max().item():.3e}")
    metric_rel = {k: abs(m32[k] - m64[k]) / max(abs(m64[k]), 1e-30) for k in m64}
    init = dict(model0.named_parameters())
    dp = max((p32[n] - p64[n]).abs().max().item() for n in p64)
    moved = min((p32[n] - init[n]).abs().max().item() for n in p32)
    n_flip = sum(int(((p32[n] - p64[n]).abs() > lr).sum().item()) for n in p64)
    print(f"train fp32 fused vs eager fp64: metrics {m32} vs {m64} (eager fp32 {me}); "
          f"max rel {_worst(metric_rel)} (tol {TRAIN_METRIC_REL}); grad rel_l2 "
          f"{_worst(rel_l2)} (tol {TRAIN_GRAD_REL_L2}), max-abs/max "
          f"{_worst(max_rel)} (tol {TRAIN_GRAD_MAX_REL}), global rel_l2 "
          f"{glob:.3e} (tol {TRAIN_GRAD_GLOBAL}); params after Adam max-abs {dp:.3e} "
          f"(sanity tol {TRAIN_PARAM_ATOL}; {n_flip} weights' updates differ by more "
          f"than lr; every tensor moved by >= {moved:.3e})")
    if set(m32) != set(m64) or max(metric_rel.values()) > TRAIN_METRIC_REL:
        failures.append(f"train fused vs eager fp64 metrics {metric_rel}")
    if (max(rel_l2.values()) > TRAIN_GRAD_REL_L2 or glob > TRAIN_GRAD_GLOBAL
            or max(max_rel.values()) > TRAIN_GRAD_MAX_REL):
        failures.append(f"train fused vs eager fp64 grads {_worst(rel_l2)} "
                        f"{_worst(max_rel)} {glob}")
    if dp > TRAIN_PARAM_ATOL or not moved > 0:
        failures.append(f"train params after Adam {dp} (moved {moved})")
    for k, v in {**m32, **mb}.items():
        if v != v or abs(v) == float("inf"):
            failures.append(f"train metric {k} not finite")
    del g64, p64, p32, occ32, occ_e, occ64, docc

    # 3. bf16 step vs fp32 step
    rel_l2, max_rel, glob = _grad_errors(gb, g32)
    print(f"train bf16 vs fp32: loss {mb['loss']:.6f} vs {m32['loss']:.6f}; grad "
          f"global rel_l2 {glob:.4f} (tol {TRAIN_BF16_REL_L2}), per tensor rel_l2 "
          f"{_worst(rel_l2)}, median {sorted(rel_l2.values())[len(rel_l2) // 2]:.4f}")
    if not glob <= TRAIN_BF16_REL_L2:
        failures.append(f"train bf16 vs fp32 grad rel_l2 {glob}")
    del gb, g32

    # 4. launches of one bf16 step, and of one with a W8A8 backward decode
    scales = pwc_fast.calibrate_q8(copy.deepcopy(model0).bfloat16(),
                                   calibration_batch(batch["images"].bfloat16()))
    n_diff = (len(DECODER_LEVELS) - 1) * (len(GROWTH) + 1) + len(GROWTH) + 2
    launches = {}
    for path, q8 in (("train", None), ("train_q8", scales)):
        state = create_train_state(copy.deepcopy(model0), lr, device=dev)
        step, _ = make_unsupervised_flow_step({**hp_b, "q8_backward": q8})
        step(state, batch)  # packs the weights
        # the pair runs the serving decode only: no encoder groups
        fw = pwc_fast.prepare(state.model, torch.bfloat16, dev, q8)
        size = (BATCH, HEIGHT, WIDTH)
        n_enc = sum(len(g.specs) for g in fw.encoder)
        n_enc_staged = sum(conv_chain.is_staged(g.dtype, s)
                           for g in fw.encoder for s in g.specs)
        n_enc_tma = sum(conv_chain.is_tma(g.dtype, s, shape[1:])
                        for g, shape in zip(fw.encoder, fw.group_shapes(size)) for s in g.specs)
        launches[path], _ = _count_launches_tma(lambda: step(state, batch), bwd=True)
        want = fw.launch_counts(size)
        # every conv_group_diff conv reads the cost volume: all on the TMA kernel
        expect = {"cost_volume": 10, "cost_volume_bwd": 5,
                  "conv_group": n_diff + want["conv_group"] - n_enc,
                  "conv_group_staged": n_diff + want["conv_group_staged"] - n_enc_staged,
                  "conv_group_tma": n_diff + want["conv_group_tma"] - n_enc_tma,
                  "conv_group_diff": n_diff,
                  "conv_group_q8": want["conv_group_q8"],
                  "conv_group_q8_staged": want["conv_group_q8_staged"],
                  "conv_group_q8_tma": want["conv_group_q8_tma"], "gemm_probe": 0,
                  **BWD_STEP_LAUNCHES}
        print(f"main path {path} (one bf16 step) launches: {launches[path]} "
              f"(expected {expect})")
        if launches[path] != expect:
            raise AssertionError(f"{path} launch counts {launches[path]}")
        del state
    # every conv of the step is stride 1, dilation 1: all on the TMA
    # kernels (the W8A8 backward decode's 35 int8 convs on the int8 one,
    # none on csrc/conv_group_q8.cu)
    if [launches[p][k] for p in ("train", "train_q8")
            for k in ("conv_group_staged", "conv_group_tma", "conv_group_q8",
                      "conv_group_q8_tma")] != [72, 72, 0, 0, 37, 37, 0, 35]:
        raise AssertionError(f"staged launches per step {launches}, want 72 / 72 / 0 / 0, "
                             "37 / 37 / 0 / 35")

    # 5. five bf16 Adam steps
    state = create_train_state(copy.deepcopy(model0), lr, device=dev)
    step, _ = make_unsupervised_flow_step(hp_b)
    start = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    losses = [float(step(state, batch)[1]["loss"]) for _ in range(5)]
    moved = min((p.detach() - start[n]).abs().max().item()
                for n, p in state.model.named_parameters())
    print(f"train bf16 5 Adam steps: loss {losses}; every tensor moved by >= {moved:.3e}")
    if not all(v == v and abs(v) != float("inf") for v in losses) or not moved > 0:
        failures.append(f"train bf16 steps: loss {losses}, moved {moved}")
    del state, start

    # 6. timing: the bf16 step end to end, then its new kernels' calls
    state, step, _ = make_train_inputs(BATCH, HEIGHT, WIDTH, dev, SEED, hp_b)
    res = measure_train(state, step, batch)
    print(f"e2e train step bf16 B={BATCH} {HEIGHT}x{WIDTH}: {res['ms_per_step']:.3f} "
          f"ms/step, {res['pairs_per_sec']:.2f} pairs/s [{card}]")
    del state, step

    # where the bf16 step's time goes: CUDA events at the step's marks
    runs = 5
    parts = train_profile.step_parts(runs)[0]
    total = sum(parts.values())
    print(f"train step bf16 breakdown (device ms between the step's marks, mean of "
          f"{runs}; {total:.3f} ms in all): " + ", ".join(
              f"{k} {v:.3f} ({100 * v / total:.1f}%)" for k, v in parts.items())
          + f" [{card}]")

    for kind, args in calls_b:
        if kind == "cost_volume_backward":
            k_ms = cuda_ms(lambda: cv_mod.cost_volume_backward(*args), 20)
            p_ms = cuda_ms(lambda: cv_mod.cost_volume_backward_plain(*args), 3)
            nbytes, ops = _cv_bwd_cost(args[0], args[3])
            bound, by = add("cost_volume_bwd", k_ms, p_ms, nbytes, ops,
                            PEAK_FLOPS[torch.bfloat16], None)
            print(f"time cost_volume_bwd bf16 {tuple(args[0].shape)}: kernel {k_ms:.4f} ms, "
                  f"plain {p_ms:.4f} ms, library none, bound {bound:.4f} ms ({by}; "
                  f"{nbytes} B, {ops} flop) [{card}]")
        elif kind == "conv_group_diff":
            inputs, weights, biases, specs = args
            group = _diff_group(*args)
            with torch.no_grad():
                outs = conv_chain.conv_group(inputs, group)
                k_ms = cuda_ms(lambda: conv_chain.conv_group_diff(*args), 5)
                # the forward's kernels alone (weights packed), the PR 5
                # staged kernel in their place, and what packing for the TMA
                # kernel adds to each call's prepare_group
                t_ms = cuda_ms(lambda: conv_chain.conv_group(inputs, group), 5)
                s_ms = cuda_ms(lambda: conv_chain.conv_group(inputs, group, staged=True), 5)
                in_ch = [x.shape[1] for x in inputs]
                prep = [cuda_ms(lambda: conv_chain.prepare_group(  # noqa: B023
                    weights, biases, group.specs, len(inputs), inputs[0].dtype,  # noqa: B023
                    inputs[0].device, ch), 5) for ch in (None, in_ch)]  # noqa: B023
                p_ms = cuda_ms(lambda: conv_chain.conv_group_plain(inputs, group), 3)
                lib_ms = cuda_ms(lambda: _eager_chain(*args), 5)
            per["conv_group_diff"]["tma_ms"] += t_ms
            per["conv_group_diff"]["staged_ms"] += s_ms
            per["conv_group_diff"]["pack_ms"] += prep[1] - prep[0]
            gouts = [torch.randn_like(o) for o in outs]
            leaves = [t.clone().requires_grad_() for t in (*inputs, *weights, *biases)]
            n_in, n = len(inputs), len(specs)
            split = (leaves[:n_in], leaves[n_in:n_in + n], leaves[n_in + n:])

            def grad(outputs):
                return torch.autograd.grad(outputs, leaves, gouts, retain_graph=True)

            # the backward on the kernels: the host's clock (events around
            # calls issued back to back: host-paced), and its device time
            # queued behind a spin; the VJP route and cuDNN's autograd over
            # the concat on the host's clock
            acts = conv_chain.conv_group_diff(*split, specs)
            bwd_ms = cuda_ms(lambda: grad(acts), 3)
            bwd_q, bwd_us = queued_ms(lambda: grad(acts), 3)
            vjp_acts = conv_chain.conv_group_diff(*split, specs, vjp=True)
            vjp_ms = cuda_ms(lambda: grad(vjp_acts), 3)
            ref = _eager_chain(*split, specs)
            lib_bwd_ms = cuda_ms(lambda: grad(ref), 3)
            # its dX and dW launches alone (device time queued) and their
            # plain versions; the adjoint packing its forward adds
            bcalls = _record([(conv_chain, "conv_adjoint"), (conv_chain, "conv_dw")],
                             lambda: grad(acts))
            b_k = {"conv_adjoint": 0.0, "conv_dw": 0.0}
            b_n = {k: sum(bk == k for bk, _ in bcalls) for k in b_k}
            b_p = 0.0
            for bkind, bargs in bcalls:
                run, plain = _bwd_launch(bkind, bargs)
                b_k[bkind] += queued_ms(run, 10)[0]
                b_p += cuda_ms(plain, 1)
            chans = [x.shape[1] for x in inputs] + [s.cout for s in group.specs]
            adj_ms = cuda_ms(lambda: conv_chain.adjoint_plan(  # noqa: B023
                group, chans, [True] * n_in, True), 5)  # noqa: B023
            del acts, vjp_acts, ref, leaves, gouts, bcalls
            nbytes, flops = _cg_cost(inputs, group, outs)
            bound, by = add("conv_group_diff", k_ms, p_ms, nbytes, flops,
                            PEAK_FLOPS[torch.bfloat16], lib_ms)
            b_bytes, b_ops = _cg_bwd_cost(inputs, group, outs)
            b_bytes_ms = b_bytes / HBM_BYTES_PER_S * 1e3
            b_ops_ms = b_ops / PEAK_FLOPS[torch.bfloat16] * 1e3
            b_bound = max(b_bytes_ms, b_ops_ms)
            per["conv_group_diff"]["bwd_ms"] += bwd_ms
            per["conv_group_diff"]["library_bwd_ms"] += lib_bwd_ms
            per["conv_group_diff"]["bwd_bound_ms"] += b_bound
            q = per["conv_group_diff_bwd"]
            for key, v in (("ms", b_k["conv_adjoint"] + b_k["conv_dw"]),
                           ("dx_ms", b_k["conv_adjoint"]), ("dw_ms", b_k["conv_dw"]),
                           ("plain_ms", b_p), ("bytes_ms", b_bytes_ms), ("ops_ms", b_ops_ms),
                           ("bound_ms", b_bound), ("library_ms", lib_bwd_ms),
                           ("host_ms", bwd_ms), ("queued_ms", bwd_q), ("vjp_ms", vjp_ms),
                           ("adjoint_pack_ms", adj_ms)):
                q[key] = q.get(key, 0.0) + v
            print(f"time conv_group_diff bf16 {tuple(inputs[0].shape)} ({n} convs): "
                  f"forward kernel {k_ms:.4f} ms ({_rate(flops, k_ms, bound)}; the kernels "
                  f"alone {t_ms:.4f} ms, staged kernel (PR 5) {s_ms:.4f} ms, TMA packing "
                  f"{prep[1] - prep[0]:.4f} ms of its prepare_group {prep[1]:.4f} ms), "
                  f"plain {p_ms:.4f} ms, library "
                  f"(cuDNN over the concat) {lib_ms:.4f} ms, bound {bound:.4f} ms ({by}; "
                  f"{nbytes} B, {flops} flop) [{card}]")
            print(f"time conv_group_diff_bwd bf16 {tuple(inputs[0].shape)} ({n} convs): "
                  f"backward on the kernels {bwd_ms:.4f} ms on the host's clock, "
                  f"{bwd_q:.4f} ms of device time queued ({bwd_us / 1e3:.4f} ms to issue); "
                  f"its {b_n['conv_adjoint']} dX launches alone {b_k['conv_adjoint']:.4f} ms, "
                  f"{b_n['conv_dw']} dW launches alone {b_k['conv_dw']:.4f} ms (queued; "
                  f"{100 * b_bound / max(b_k['conv_adjoint'] + b_k['conv_dw'], 1e-9):.2f}% of "
                  f"bound), their plain versions {b_p:.4f} ms; adjoint packing in the forward "
                  f"{adj_ms:.4f} ms; VJP route (cuDNN conv VJPs) {vjp_ms:.4f} ms, library "
                  f"autograd (cuDNN over the concat) {lib_bwd_ms:.4f} ms; bound "
                  f"{b_bound:.4f} ms ({b_bytes} B, {b_ops} flop: dX and dW) [{card}]")
    p = per["conv_group_diff"]
    print(f"time conv_group_diff sum over the bf16 step's groups: forward kernel "
          f"{p['ms']:.4f} ms (the kernels alone {p['tma_ms']:.4f} ms, "
          f"{100 * p['bound_ms'] / p['tma_ms']:.2f}% of bound; staged kernel (PR 5) "
          f"{p['staged_ms']:.4f} ms; TMA packing {p['pack_ms']:.4f} ms a step), cuDNN over "
          f"the concat {p['library_ms']:.4f} ms, "
          f"bound {p['bound_ms']:.4f} ms [{card}]")
    q = per["conv_group_diff_bwd"]
    print(f"time conv_group_diff_bwd sum over the bf16 step's groups: backward on the "
          f"kernels {q['host_ms']:.4f} ms on the host's clock, {q['queued_ms']:.4f} ms of "
          f"device time queued ({100 * q['bound_ms'] / q['queued_ms']:.2f}% of bound); dX "
          f"launches alone {q['dx_ms']:.4f} ms, dW launches alone {q['dw_ms']:.4f} ms; "
          f"plain versions {q['plain_ms']:.4f} ms; adjoint packing {q['adjoint_pack_ms']:.4f} "
          f"ms a step; VJP route {q['vjp_ms']:.4f} ms; library autograd "
          f"{q['library_ms']:.4f} ms; bound {q['bound_ms']:.4f} ms [{card}]")
    return launches


def _flownetc_grad(model, x, card):
    """FlowNetC's input gradient under a seeded cotangent on the flow (fp32,
    eval): its launches (one d=10 forward, one d=10 backward); with cuDNN's
    deterministic algorithms, against the gradient with the plain backward
    on the same forward (beside it a second run, the plain cost volume's
    gradient, and the counted run with cuDNN's default algorithms); the
    d=10 backward call against its plain version (fp32, and cast to bf16)
    and its time beside its bound. Returns the launch counts and the
    backward's numbers."""
    from ocflow_torch.bench import cuda_ms
    from ocflow_torch.kernels import cost_volume as cv_mod
    from ocflow_torch.models import flow_net_s as fns

    def flow_of(inp):
        out = model(inp)
        return out[0] if isinstance(out, tuple) else out

    with torch.no_grad():
        shape = flow_of(x).shape
    gen = torch.Generator(device=x.device).manual_seed(1)
    cot = torch.randn(shape, device=x.device, generator=gen)

    def grad():
        xg = x.detach().requires_grad_()
        return torch.autograd.grad(flow_of(xg), xg, cot)[0]

    launches, got = _count_launches(grad)
    expect = {k: 0 for k in launches}
    expect.update(cost_volume=1, cost_volume_bwd=1)
    print(f"main path flownetc input gradient (one fp32 eval forward and backward) "
          f"launches: {launches} (expected {expect})")
    if launches != expect:
        raise AssertionError(f"flownetc gradient launch counts {launches}")

    def through(forward_fn):
        """The gradient with the cost volume's forward ``forward_fn`` and the
        plain backward."""
        saved = fns.cost_volume
        fns.cost_volume = lambda a, b, d: _PlainBackward.apply(a, b, d, forward_fn)
        try:
            return grad()
        finally:
            fns.cost_volume = saved

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        det = grad()
        ref = through(cv_mod.cost_volume)
        others = {"the kernels again": grad(),
                  "the plain forward and backward": through(cv_mod.cost_volume_plain),
                  "the kernels with cuDNN's default algorithms": got}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    torch.cuda.synchronize()
    scale = ref.abs().max().item()
    rel = (det - ref).abs().max().item() / scale
    print(f"e2e flownetc input gradient (cuDNN deterministic), kernels vs the plain "
          f"backward on the same forward: {rel:.3e} of max|grad| {scale:.3e} (tol "
          f"{GRAD_FP32_TOL}); beside it, vs " + "; ".join(
              f"{k} {(r - ref).abs().max().item() / scale:.3e}" for k, r in others.items())
          + f"; finite {bool(torch.isfinite(det).all())}")
    if det.shape != x.shape or not torch.isfinite(det).all() or not rel <= GRAD_FP32_TOL:
        raise AssertionError(f"flownetc input gradient: {rel} > {GRAD_FP32_TOL}")
    del got, det, ref, others

    calls = _record([(cv_mod, "cost_volume_backward")], grad)
    if [(k, a[3]) for k, a in calls] != [("cost_volume_backward", 10)]:
        raise AssertionError(f"backward calls {[(k, a[3]) for k, a in calls]}")
    args = calls[0][1]
    err = {"cost_volume_bwd": 0.0}
    _check_float("cost_volume_bwd", args, torch.float32, err, "flownetc d=10 ")
    bf = tuple(a.bfloat16() for a in args[:3]) + (10,)
    _check_float("cost_volume_bwd", bf, torch.bfloat16, err, "flownetc d=10 ")
    res = {"max_abs_err": err["cost_volume_bwd"]}
    for dtype, a in ((torch.float32, args), (torch.bfloat16, bf)):
        k_ms = cuda_ms(lambda: cv_mod.cost_volume_backward(*a), 20)  # noqa: B023
        p_ms = cuda_ms(lambda: cv_mod.cost_volume_backward_plain(*a), 3)  # noqa: B023
        nbytes, ops = _cv_bwd_cost(a[0], 10)
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = ops / PEAK_FLOPS[dtype] * 1e3
        by = "bytes" if b_ms >= o_ms else "operations"
        if dtype == torch.float32:
            res.update(ms=k_ms, plain_ms=p_ms, bound_ms=max(b_ms, o_ms), bound_by=by)
        print(f"time cost_volume_bwd d=10 {str(dtype)[6:]} {tuple(a[0].shape)}: kernel "
              f"{k_ms:.4f} ms ({_rate(ops, k_ms, max(b_ms, o_ms))}), plain {p_ms:.4f} ms, "
              f"library none, bound {max(b_ms, o_ms):.4f} ms ({by}; bytes {b_ms:.4f} ms "
              f"at 3.35 TB/s, operations {o_ms:.4f} ms at {PEAK_FLOPS[dtype] / 1e12:.0f} "
              f"TFLOP/s; {nbytes} B, {ops} flop) [{card}]")
    return launches, res


def _flownetc_phase(card, tf32_defaults):
    """The FlowNetC family's serving forward (B=8, 448x1024, fp32, eval, a
    seeded net with BatchNorm statistics, seed 0): launches, the d=10 call
    against its plain version (fp32, and cast to bf16), the forward against
    the plain-cost-volume forward (also with PyTorch's default TF32 flags),
    timings. Returns the launch counts per net and the d=10 call's numbers
    (FlowNetC's call)."""
    from ocflow_torch.bench import BATCH, HEIGHT, SEED, WIDTH, cuda_ms, make_flownetc_inputs
    from ocflow_torch.kernels import cost_volume as cv_mod
    from ocflow_torch.models import FlowNetC, FlowOccNetC, OcclusionNetC
    from ocflow_torch.models import flow_net_s as fns

    launches, d10, d10_bwd = {}, {"max_abs_err": 0.0}, {}
    failures = []
    for key, cls in (("flownetc", FlowNetC), ("occnetc", OcclusionNetC),
                     ("flowoccnetc", FlowOccNetC)):
        model, x = make_flownetc_inputs(BATCH, HEIGHT, WIDTH, "cuda", SEED, cls)

        def forward():
            with torch.no_grad():
                out = model(x)  # noqa: B023
            return out if isinstance(out, tuple) else (out,)

        launches[key], out = _count_launches(forward)
        expect = {k: 0 for k in launches[key]}
        expect["cost_volume"] = 1
        print(f"main path {key} (one fp32 eval forward) launches: {launches[key]} "
              f"(expected {expect})")
        if launches[key] != expect:
            raise AssertionError(f"{key} launch counts {launches[key]}")

        calls = _record([(fns, "cost_volume")], forward)
        if [(k, a[2]) for k, a in calls] != [("cost_volume", 10)]:
            raise AssertionError(f"{key}: cost-volume calls {[(k, a[2]) for k, a in calls]}")
        f1, f2, _ = calls[0][1]
        err = {"cost_volume": 0.0}
        _check_float("cost_volume", (f1, f2, 10), torch.float32, err, f"{key} d=10 ")
        _check_float("cost_volume", (f1.bfloat16(), f2.bfloat16(), 10), torch.bfloat16,
                     err, f"{key} d=10 ")
        d10["max_abs_err"] = max(d10["max_abs_err"], err["cost_volume"])

        saved, fns.cost_volume = fns.cost_volume, cv_mod.cost_volume_plain
        try:
            ref = forward()
        finally:
            fns.cost_volume = saved
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32_defaults
        try:
            out_tf32 = forward()
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        for head, o, t, r in zip(cls.HEADS, out, out_tf32, ref):
            want = (BATCH, HEIGHT, WIDTH, 2 if head == "flow" else 1)
            for v in (o, t):
                if tuple(v.shape) != want or v.dtype != torch.float32 \
                        or not torch.isfinite(v).all():
                    raise AssertionError(f"{key} {head}: bad output {v.shape} {v.dtype}")
            if head == "occ" and not (0 <= o.min().item() and o.max().item() <= 1):
                failures.append(f"{key} occ outside [0, 1]")
            scale = r.abs().max().item()
            e, e_tf32 = (o - r).abs().max().item(), (t - r).abs().max().item()
            print(f"e2e {key} {head}: kernel forward vs plain-cost-volume forward "
                  f"max_abs_err {e:.3e} (tol {E2E_FP32_TOL * scale:.3e}, max|plain| "
                  f"{scale:.3e}); with PyTorch's default TF32 flags (cudnn "
                  f"{tf32_defaults[0]}, matmul {tf32_defaults[1]}) {e_tf32:.3e} "
                  f"({e_tf32 / scale:.3e} of max|plain|, same tol)")
            if not e <= E2E_FP32_TOL * scale:
                failures.append(f"{key} {head}: kernel vs plain forward {e}")
            if not e_tf32 <= E2E_FP32_TOL * scale:
                failures.append(f"{key} {head}: default TF32 flags {e_tf32}")
        del out, out_tf32, ref

        if key == "flownetc":
            launches["flownetc_grad"], d10_bwd = _flownetc_grad(model, x, card)
            k_ms = cuda_ms(lambda: cv_mod.cost_volume(f1, f2, 10), 20)  # noqa: B023
            p_ms = cuda_ms(lambda: cv_mod.cost_volume_plain(f1, f2, 10), 3)  # noqa: B023
            nbytes, ops = _cv_cost(f1, 10)
            b_ms = nbytes / HBM_BYTES_PER_S * 1e3
            o_ms = ops / PEAK_FLOPS[torch.float32] * 1e3
            d10.update(ms=k_ms, plain_ms=p_ms, bound_ms=max(b_ms, o_ms),
                       bound_by="bytes" if b_ms >= o_ms else "operations")
            print(f"time cost_volume d=10 fp32 {tuple(f1.shape)}: kernel {k_ms:.4f} ms "
                  f"({_rate(ops, k_ms, d10['bound_ms'])}), plain {p_ms:.4f} ms, library "
                  f"none, bound {d10['bound_ms']:.4f} ms ({d10['bound_by']}; bytes "
                  f"{b_ms:.4f} ms at 3.35 TB/s, operations {o_ms:.4f} ms at 67 TFLOP/s "
                  f"fp32; {nbytes} B, {ops} flop) [{card}]")
        e2e = cuda_ms(forward, 10)
        print(f"e2e {key} fp32 eval forward B={BATCH} {HEIGHT}x{WIDTH}: {e2e:.3f} "
              f"ms/batch, {BATCH * 1e3 / e2e:.2f} pairs/s [{card}]")
        del model, x, calls, f1, f2
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))
    return launches, d10, d10_bwd


def _png_pixels(path):
    """A PNG file of the port's writer (8-bit RGB, filter 0 on every row)
    decoded with zlib: uint8 ``[H, W, 3]``."""
    import struct
    import zlib

    import numpy as np

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if crc != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise AssertionError(f"{path}: bad CRC in {kind}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, colour = header[:4]
    if (depth, colour) != (8, 2):
        raise AssertionError(f"{path}: depth {depth}, colour type {colour}")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise AssertionError(f"{path}: a row filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


def _fit_phase(card):
    """The training system (``make_loaders`` + ``fit`` + ``evaluate`` and a
    checkpoint restore) on ``configs/longrun_synthetic.yaml`` at full width
    with ``FIT_CUTS``, outputs in a temporary directory: the dataset
    generated on the card against the CPU, the device cache's bytes, the
    launches of one train and one eval step of ``fit``, the CSV, the
    panels, the checkpoint round trip, the loop's ms per step beside
    ``bench.measure_train``'s. Returns the launch counts of that train step
    (``fit``) and eval step (``fit_eval``)."""
    import math
    import os
    import tempfile

    from ocflow_torch.bench import measure_train
    from ocflow_torch.data import SyntheticFlowWarp
    from ocflow_torch.models.pwc_net import FlowNetCV
    from ocflow_torch.train import (LONGRUN_SYNTHETIC, config_from_dict, create_train_state,
                                    loop, make_unsupervised_flow_step)
    from ocflow_torch.train_unsupervised import viz_fn
    from ocflow_torch.utils.checkpoint import CheckpointManager, load_state

    dev = torch.device("cuda")
    print("fit: configs/longrun_synthetic.yaml at full width, cut: " + ", ".join(
        f"{k} {v} (config {LONGRUN_SYNTHETIC.get(k, 'default 10')})"
        for k, v in FIT_CUTS.items()))
    with tempfile.TemporaryDirectory() as out:
        cfg = config_from_dict({
            **LONGRUN_SYNTHETIC, **FIT_CUTS, "metrics_csv": f"{out}/metrics.csv",
            "log_dir": f"{out}/tb", "checkpoint_dir": f"{out}/ckpt", "result_dir": out})
        h, w = cfg.image_size
        n = cfg.dataset_size
        split = (int(0.8 * n), int(0.1 * n), n - int(0.8 * n) - int(0.1 * n))

        # 1. data on the card vs the same samples on the CPU
        ds = SyntheticFlowWarp(size=n, image_size=(h, w), device=dev)
        ds_cpu = SyntheticFlowWarp(size=n, image_size=(h, w), device="cpu")
        for idx in (0, n - 1):
            got, ref = ds[idx], ds_cpu[idx]
            for k, tol in FIT_DATA_TOL.items():
                err = (got[k].cpu() - ref[k]).abs().max().item()
                print(f"fit data: SyntheticFlowWarp[{idx}] {k} {tuple(got[k].shape)} cuda "
                      f"vs cpu max_abs_err {err:.3e} (tol {tol})")
                if not err <= tol or got[k].device.type != "cuda":
                    raise AssertionError(f"SyntheticFlowWarp[{idx}] {k}: {err} on "
                                         f"{got[k].device}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for idx in range(8):
            ds[idx]
        torch.cuda.synchronize()
        gen_ms = (time.perf_counter() - t0) * 1e3 / 8
        t0 = time.perf_counter()
        ds_cpu[1]
        cpu_ms = (time.perf_counter() - t0) * 1e3
        print(f"fit data: SyntheticFlowWarp {h}x{w} generation on the card {gen_ms:.2f} "
              f"ms/sample (8 samples, host clock to a sync; the numpy draws included), on "
              f"this host's CPU {cpu_ms:.1f} ms [{card}]")
        del ds, ds_cpu, got, ref

        # 2. the loaders and the device cache
        train_loader, val_loader, test_loader = loop.make_loaders(cfg, dev)
        for name, ld, m in zip(("train", "val", "test"),
                               (train_loader, val_loader, test_loader), split):
            want = {"images": (m * h * w * 6 * 2, torch.bfloat16),
                    "flow": (m * h * w * 2 * 4, torch.float32)}
            got = {k: (v.numel() * v.element_size(), v.dtype)
                   for k, v in ld.cache().items()}
            print(f"fit device cache {name} ({m} samples): {got} (expected {want}; "
                  f"{sum(b for b, _ in got.values()) / 1e6:.1f} MB)")
            if got != want or any(v.device.type != "cuda"
                                  for v in ld.cache().values()):
                raise AssertionError(f"device cache {name}: {got}")

        # 3. fit, through wrappers of the step functions that count one train
        # and one eval step's launches, record a CUDA event after each train
        # step, and keep the state each epoch's checkpoint saves (validation
        # runs on the state fit then saves)
        model = FlowNetCV(displacement=cfg.displacement,
                          generator=torch.Generator().manual_seed(cfg.seed))
        state = create_train_state(model, cfg.learning_rate, device=dev)
        train_step, eval_step = make_unsupervised_flow_step(cfg.as_hparams())
        count_step = 2
        rec = {"ends": [], "snap": {}, "panels": {}, "epoch": -1}
        launches = {}

        def train_wrapped(st, batch):
            before = _read_counts(bwd=True) if st.step == count_step else None
            st, metrics = train_step(st, batch)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            rec["ends"].append(ev)
            if before is not None:  # the counters count on the host, at each launch
                after = _read_counts(bwd=True)
                launches["fit"] = {k: after[k] - before[k] for k in after}
            return st, metrics

        def eval_wrapped(st, batch):
            if st.step not in rec["snap"]:
                rec["epoch"] += 1
                rec["snap"][st.step] = (rec["epoch"], {
                    "step": st.step,
                    "params": {k: v.clone() for k, v in st.model.state_dict().items()},
                    "opt_state": copy.deepcopy(st.optimizer.state_dict())})
            if "fit_eval" in launches:
                return eval_step(st, batch)
            before = _read_counts()
            metrics = eval_step(st, batch)
            after = _read_counts()
            launches["fit_eval"] = {k: after[k] - before[k] for k in after}
            return metrics

        def viz_wrapped(st, batch):
            panels = viz_fn(st, batch)
            rec["panels"][rec["epoch"]] = panels
            return panels

        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = loop.fit(cfg, state, train_wrapped, eval_wrapped, train_loader, val_loader,
                         viz_fn=viz_wrapped)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        total = _read_counts()
        steps_per_epoch = split[0] // cfg.batch_size
        print(f"fit: {cfg.max_epochs} epochs of {steps_per_epoch} steps in {fit_s:.2f} s "
              f"wall (caches built before); launches over the whole fit {total}")
        for path, want in (("fit", FIT_STEP_LAUNCHES), ("fit_eval", None)):
            print(f"main path {path} (one {'train' if want else 'eval'} step of fit, B="
                  f"{cfg.batch_size if want else split[1]}) launches: {launches[path]}"
                  + (f" (expected {want})" if want else ""))
        if launches["fit"] != FIT_STEP_LAUNCHES:
            raise AssertionError(f"fit train step launches {launches['fit']}")
        for k in ("cost_volume", "cost_volume_bwd", "conv_group", "conv_group_diff"):
            if total[k] == 0:
                raise AssertionError(f"fit ran no {k} kernel")
        if launches["fit_eval"]["cost_volume"] == 0 or launches["fit_eval"]["conv_group"] == 0:
            raise AssertionError(f"eval step launches {launches['fit_eval']}")

        # 4. the run's records: CSV rows, finite losses, panels
        with open(cfg.metrics_csv) as f:
            lines = f.read().splitlines()
        keys = lines[0].split(",")
        rows = [dict(zip(keys, line.split(","))) for line in lines[1:]]
        n_train = sum(r["phase"] == "train" for r in rows)
        n_val = sum(r["phase"] == "val" for r in rows)
        want_rows = (cfg.max_epochs * steps_per_epoch, cfg.max_epochs)
        losses = [float(r["loss"]) for r in rows]
        print(f"fit CSV: {n_train} train rows, {n_val} val rows (expected {want_rows}); "
              f"losses {losses}")
        if (n_train, n_val) != want_rows or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"CSV rows {(n_train, n_val)}, losses {losses}")
        for epoch, panels in rec["panels"].items():
            for tag, img in panels.items():
                path = os.path.join(out, f"val_{epoch}", f"{tag}.png")
                pix = _png_pixels(path)
                print(f"fit panel val_{epoch}/{tag}.png: {pix.shape}, equal to the "
                      f"panel: {(pix == img).all()}")
                if pix.shape != (4 * h, w, 3) or not (pix == img).all():
                    raise AssertionError(f"{path}: {pix.shape}")
        if sorted(rec["panels"]) != list(range(cfg.max_epochs)) \
                or any(sorted(p) != ["flow", "warp"] for p in rec["panels"].values()):
            raise AssertionError(f"panels {[(e, sorted(p)) for e, p in rec['panels'].items()]}")

        # 5. the checkpoint: restore() into a fresh model and Adam, equal bit
        # for bit to the state fit saved; evaluate on both
        mgr = CheckpointManager(cfg.checkpoint_dir)
        best = mgr.best_step
        saved = {epoch: snap for epoch, snap in rec["snap"].values()}[best]
        restored = create_train_state(FlowNetCV(displacement=cfg.displacement),
                                      cfg.learning_rate, device=dev)
        load_state(restored, mgr.restore())
        same_params = all(torch.equal(v, saved["params"][k])
                          for k, v in restored.model.state_dict().items())
        opt_r = restored.optimizer.state_dict()
        same_opt = (opt_r["param_groups"] == saved["opt_state"]["param_groups"]
                    and all(torch.equal(v, saved["opt_state"]["state"][i][k])
                            for i, s in opt_r["state"].items() for k, v in s.items()))
        print(f"fit checkpoint: best epoch {best} of {cfg.max_epochs} (val losses "
              f"{[float(r['loss']) for r in rows if r['phase'] == 'val']}); restored "
              f"step {restored.step} (saved {saved['step']}), parameters bit for bit "
              f"{same_params}, Adam state bit for bit {same_opt}")
        if not (same_params and same_opt and restored.step == saved["step"]):
            raise AssertionError("the restored checkpoint differs from the saved state")
        if best == cfg.max_epochs - 1:
            in_memory, which = state, "the state fit returned"
        else:
            in_memory = create_train_state(FlowNetCV(displacement=cfg.displacement),
                                           cfg.learning_rate, device=dev)
            load_state(in_memory, saved)
            which = f"the state fit held at epoch {best}, kept in memory"
        t0 = time.perf_counter()
        m_restored = loop.evaluate(cfg, restored, eval_step, test_loader)
        eval_ms = (time.perf_counter() - t0) * 1e3
        m_memory = loop.evaluate(cfg, in_memory, eval_step, test_loader)
        rel = {k: abs(m_restored[k] - v) / max(abs(v), 1e-30) for k, v in m_memory.items()}
        print(f"fit evaluate (test split, {split[2]} pairs): restored {m_restored}; "
              f"{which} {m_memory}; relative difference {rel} (tol {FIT_EVAL_REL})")
        if set(m_restored) != set(m_memory) or not all(v <= FIT_EVAL_REL
                                                       for v in rel.values()):
            raise AssertionError(f"evaluate restored vs in memory: {rel}")

        # 6. timing: what fit does at each epoch's end (a checkpoint save, a
        # validation pass: here evaluate over the test split, one batch),
        # then the loop's ms per step from the CUDA events after each
        # train step (steps 3-8 of the run, leaving out each epoch's first
        # interval, which holds the validation, the panels and the save), and
        # bench.measure_train on a batch of the loader, in this process
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        CheckpointManager(f"{out}/timing").save(0, state, 0.0)
        save_ms = (time.perf_counter() - t0) * 1e3
        size = os.path.getsize(CheckpointManager(f"{out}/timing").path(0))
        print(f"fit epoch end: a checkpoint save {save_ms:.1f} ms ({size / 1e6:.1f} MB), "
              f"evaluate over {split[2]} pairs in one batch {eval_ms:.1f} ms (host clock) "
              f"[{card}]")
        ends = rec["ends"]
        firsts = set(range(0, len(ends), steps_per_epoch))
        gaps = [ends[i - 1].elapsed_time(ends[i]) for i in range(2, len(ends))
                if i not in firsts]
        loop_ms = sum(gaps) / len(gaps)
        batch = next(iter(train_loader))
        bench_state = create_train_state(copy.deepcopy(state.model), cfg.learning_rate,
                                         device=dev)
        bench = measure_train(bench_state, train_step, batch)
        print(f"fit timing: the loop {loop_ms:.3f} ms/step ({cfg.batch_size * 1e3 / loop_ms:.2f} "
              f"pairs/s; CUDA events between the ends of steps {[i + 1 for i in range(2, len(ends)) if i not in firsts]}, "
              f"intervals {[round(g, 3) for g in gaps]} ms; a metrics fetch every step), "
              f"bench.measure_train {bench['ms_per_step']:.3f} ms/step "
              f"({bench['pairs_per_sec']:.2f} pairs/s; no fetch), loop / bench "
              f"{loop_ms / bench['ms_per_step']:.3f} [{card}]")
        del state, bench_state, restored, in_memory, rec, train_loader, val_loader, test_loader
    torch.cuda.empty_cache()
    return launches


# phase 11: the file-backed data path and the serving and eval CLIs, at
# real sizes: Sintel (2 scenes of 5 frames, 436x1024, cropped to 384x1024 by
# the floor-64 rule), KITTI 2015 (3 pairs, 375x1242 -> 320x1216: level 6 is
# 19 wide) and FlyingChairs2 (24 pairs, 384x512), generated from the seed
FILES_SINTEL = (2, 5, 436, 1024)  # scenes, frames per scene, height, width
FILES_KITTI = (3, 375, 1242)      # pairs, height, width
FILES_CHAIRS2 = (24, 384, 512)    # pairs, height, width
FILES_SEED = 0
# the steady rates: evaluate over a Sintel tree of 49 frames a scene (96
# pairs, 12 batches of 8) and infer over a folder of 17 frames (16 pairs),
# both links to the generated frames, timed after the first batch / pair
FILES_STEADY_FRAMES = (49, 17)
# evaluate's EPE and occlusion F1 on the kernels vs on the plain cost
# volume, relative: the cost volume's summation order through an fp32
# forward (1e-4 of max|flow| per flow, phase 6), averaged over pixels
FILES_METRIC_REL = 1e-4


def _smooth(rng, h, w, c, lo, hi):
    """A smooth seeded field ``[h, w, c]`` in ``[lo, hi]``: uniform noise on
    a grid 16x coarser, bilinearly upsampled (float32)."""
    import numpy as np
    import torch.nn.functional as F

    coarse = torch.from_numpy(rng.uniform(lo, hi, (1, c, h // 16 + 2, w // 16 + 2))
                              .astype(np.float32))
    return F.interpolate(coarse, size=(h, w), mode="bilinear",
                         align_corners=False)[0].permute(1, 2, 0).numpy()


def _write_trees(root):
    """The three trees under ``root``, written by the port's own writers
    (every PNG with a seeded mix of the five row filters, so the decoder's
    unfiltering of each type runs). Returns ``{tree: path}`` and what was
    written of each file kind, to read back."""
    import os

    import numpy as np

    from ocflow_torch.data import write_flo
    from ocflow_torch.utils.png import write_png

    rng = np.random.default_rng(FILES_SEED)
    frame = lambda h, w: _smooth(rng, h, w, 3, 0, 255).round().astype(np.uint8)  # noqa: E731
    filters = lambda h: rng.integers(0, 5, h)  # noqa: E731
    written = {}
    sintel = os.path.join(root, "sintel")
    scenes, frames, h, w = FILES_SINTEL
    for s in range(scenes):
        for sub in ("clean", "flow", "occlusions"):
            os.makedirs(os.path.join(sintel, sub, f"scene_{s}"))
        for f in range(1, frames + 1):
            img = frame(h, w)
            path = os.path.join(sintel, "clean", f"scene_{s}", f"frame_{f:04d}.png")
            write_png(path, img, filters(h))
            written.setdefault("frame", (path, img))
            if f == frames:
                continue
            flow = _smooth(rng, h, w, 2, -20, 20)
            path = os.path.join(sintel, "flow", f"scene_{s}", f"frame_{f:04d}.flo")
            write_flo(path, flow)
            written.setdefault("flo", (path, flow))
            occ = (_smooth(rng, h, w, 1, 0, 1) > 0.7).astype(np.uint8) * 255
            path = os.path.join(sintel, "occlusions", f"scene_{s}", f"frame_{f:04d}.png")
            write_png(path, occ, filters(h))
            written.setdefault("occ", (path, occ))
    kitti = os.path.join(root, "kitti")
    n, h, w = FILES_KITTI
    for sub in ("image_2", "flow_occ"):
        os.makedirs(os.path.join(kitti, sub))
    for i in range(n):
        for suffix in ("10", "11"):
            write_png(os.path.join(kitti, "image_2", f"{i:06d}_{suffix}.png"), frame(h, w),
                      filters(h))
        flow = _smooth(rng, h, w, 2, -40, 40)
        raw = np.empty((h, w, 3), np.uint16)
        raw[..., :2] = np.clip(flow * 64.0 + 2 ** 15, 0, 65535).astype(np.uint16)
        raw[..., 2] = rng.uniform(size=(h, w)) > 0.3  # sparse: ~70% valid
        path = os.path.join(kitti, "flow_occ", f"{i:06d}_10.png")
        write_png(path, raw, filters(h))
        written.setdefault("kitti_flow", (path, raw))
    chairs2 = os.path.join(root, "chairs2")
    os.makedirs(chairs2)
    n, h, w = FILES_CHAIRS2
    for i in range(n):
        for k in (1, 2):
            write_png(os.path.join(chairs2, f"{i:05d}-img_{k}.png"), frame(h, w), filters(h))
        write_flo(os.path.join(chairs2, f"{i:05d}-flow_01.flo"), _smooth(rng, h, w, 2, -10, 10))
        write_png(os.path.join(chairs2, f"{i:05d}-occ_01.png"),
                  (_smooth(rng, h, w, 1, 0, 1) > 0.7).astype(np.uint8) * 255, filters(h))
    return {"sintel": sintel, "kitti": kitti, "chairs2": chairs2}, written


def _linked_sintel(sintel, dst, frames):
    """A Sintel tree of ``frames`` frames a scene, each file a link, in
    turn, to a frame or ``.flo`` of ``sintel``: the decode work of as many
    real files, written in no time."""
    import os

    scenes, n = FILES_SINTEL[:2]
    for s in range(scenes):
        for sub, ext, k, m in (("clean", "png", n, frames), ("flow", "flo", n - 1, frames - 1)):
            os.makedirs(os.path.join(dst, sub, f"scene_{s}"))
            for f in range(m):
                os.symlink(os.path.join(sintel, sub, f"scene_{s}", f"frame_{f % k + 1:04d}.{ext}"),
                           os.path.join(dst, sub, f"scene_{s}", f"frame_{f + 1:04d}.{ext}"))
    return dst


def _busy_share(prof, mark):
    """The card's busy share in a ``torch.profiler`` trace: the union of
    its kernels and copies from the start of the host's second ``mark``
    range to the last of them, over that window; and the window in ms.
    (The trace also holds each ``mark`` range on the device's timeline:
    not work, so left out of both.)"""
    on_card = lambda e: str(getattr(e, "device_type", "")).endswith("CUDA")  # noqa: E731
    evs = prof.events()
    starts = sorted(e.time_range.start for e in evs if e.name == mark and not on_card(e))
    dev = sorted((e.time_range.start, e.time_range.end) for e in evs
                 if on_card(e) and e.name != mark)
    if len(starts) < 2 or not dev:
        raise AssertionError(f"profiler trace: {len(starts)} {mark!r} ranges, "
                             f"{len(dev)} device events")
    t0, t1 = starts[1], max(end for _, end in dev)
    busy, at = 0.0, t0
    for a, b in dev:
        a, b = max(a, at), min(b, t1)
        if b > a:
            busy += b - a
            at = b
    return busy / (t1 - t0), (t1 - t0) / 1e3


class _Timed:
    """Wraps a module-level function: per call, the launch counts of that
    call (every counter zeroed at its start), CUDA events around it, its
    host start time and, with ``keep``, its arguments and result."""

    def __init__(self, module, name, fn=None, keep=False):
        self.module, self.name, self.keep = module, name, keep
        self.saved = getattr(module, name)
        self.fn = fn or self.saved
        self.counts, self.events, self.starts, self.calls = [], [], [], []

    def __call__(self, *args, **kwargs):
        self.starts.append(time.perf_counter())
        _zero_counts()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = self.fn(*args, **kwargs)
        end.record()
        self.counts.append(_read_counts())
        self.events.append((start, end))
        if self.keep:
            self.calls.append((args, kwargs, out))
        return out

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.saved)

    def span_ms(self, first: int = 0) -> float:
        """The CUDA-event spans of the calls from ``first`` on, summed: the
        card's work in them and its idle gaps inside them."""
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events[first:])


def _eval_path(card, max_err, path_name, name, root, task, model_key, fn_module):
    """``python -m ocflow_torch.evaluate --task <task> --model <model_key>``
    on the dataset ``name`` under ``root`` at B=8: once on the kernels
    (every cost-volume call recorded and replayed against its plain version
    in fp32, the launches of each batch counted: 5 cost volumes at d=4, 1 at
    d=10, no other kernel), once with ``fn_module.cost_volume`` swapped for
    the plain op; the metrics of the two within ``FILES_METRIC_REL``.
    Returns the launches of a batch and the warm forward's ms."""
    import math

    from ocflow_torch import evaluate
    from ocflow_torch.bench import cuda_ms
    from ocflow_torch.data import build_dataset
    from ocflow_torch.kernels import cost_volume as cv_mod

    def run_eval(argv, plain):
        """evaluate.main: its result, its cost-volume calls (the kernel
        run), its forwards' counts and events, its wall ms."""
        box = {}
        with _Timed(evaluate, "predict", keep=not plain) as timed:
            t0 = time.perf_counter()
            if plain:
                saved = fn_module.cost_volume
                fn_module.cost_volume = cv_mod.cost_volume_plain
                try:
                    box["res"] = evaluate.main(argv)
                finally:
                    fn_module.cost_volume = saved
                calls = None
            else:
                calls = _record([(fn_module, "cost_volume")], lambda: box.update(
                    res=evaluate.main(argv)))
            return box["res"], calls, timed, (time.perf_counter() - t0) * 1e3

    argv = ["--task", task, "--model", model_key, "--dataset", name, "--root", root,
            "--batch_size", "8"]
    got, calls, timed, wall = run_eval(argv, plain=False)
    ref, _, _, _ = run_eval(argv, plain=True)
    n = len(build_dataset(name, root=root))
    d = calls[0][1][2]
    # the first batch's forward again, warm: what the card needs per batch
    (model, x), _, _ = timed.calls[0]
    fwd_ms = cuda_ms(lambda: evaluate.predict(model, x), 3)
    del model, x, timed.calls[:]
    for k, (_, args) in enumerate(calls):
        _check_float("cost_volume", args, torch.float32, max_err,
                     f"{path_name} d={d} call {k} ")
    expect = {k: 0 for k in timed.counts[0]}
    expect["cost_volume"] = 1 if d == 10 else 5
    span = timed.span_ms()
    rel = {k: abs(got[k] - v) / max(abs(v), 1e-30) for k, v in ref.items()}
    shape = tuple(calls[0][1][0].shape) if calls else None
    print(f"main path {path_name} ({name}, {n} pairs, batches "
          f"{[c['cost_volume'] for c in timed.counts]} cost volumes each) launches "
          f"per batch: {timed.counts} (expected {expect} each)")
    print(f"e2e {path_name}: {got} on the kernels, {ref} on the plain cost volume, "
          f"relative {rel} (tol {FILES_METRIC_REL}); {n} pairs in {wall:.1f} ms wall "
          f"({n * 1e3 / wall:.2f} pairs/s end to end, the model's build and the cold "
          f"first forward included), the forwards' CUDA-event span {span:.1f} ms "
          f"({100 * span / wall:.1f}% of the wall; idle gaps inside counted); the "
          f"same forward warm {fwd_ms:.2f} ms per "
          f"batch of {len(calls and calls[0][1][0]) or 0}); the first cost volume "
          f"{shape} [{card}]")
    if any(c != expect for c in timed.counts) or len(calls) != len(timed.counts) * \
            expect["cost_volume"]:
        raise AssertionError(f"{path_name} launches {timed.counts}")
    if set(got) != set(ref) or not all(v <= FILES_METRIC_REL for v in rel.values()) \
            or not all(math.isfinite(v) for v in got.values()):
        raise AssertionError(f"{path_name}: {got} vs {ref}")
    if task == "flow_occ" and "occlusion_f1" not in got:
        raise AssertionError(f"{path_name}: no occlusion F1")
    # KITTI's crop 1216 wide: levels 19, 38, 76, 152, 304 wide
    tw = FILES_KITTI[2] // 64 * 64
    if model_key == "pwc" and name.startswith("KITTI") and sorted(
            {a[0].shape[-1] for _, a in calls}) != [tw >> k for k in (6, 5, 4, 3, 2)]:
        raise AssertionError(f"KITTI widths {[a[0].shape for _, a in calls]}")
    return timed.counts[0], fwd_ms


def _files_phase(card, max_err, then=None):
    """The file-backed data path and both CLIs on the card (see the module
    docstring, phase 11); then ``then(trees)`` while the trees exist.
    Returns the launch counts per evaluate batch, per infer pair and of one
    train step of ``fit`` on FlyingChairs2, with ``then``'s."""
    import math
    import os
    import tempfile

    import numpy as np

    from ocflow_torch import evaluate, infer
    from ocflow_torch.data import (DataLoader, build_dataset, native_io, read_flo, read_gen,
                                   read_kitti_png_flow, write_flo)
    from ocflow_torch.kernels import cost_volume as cv_mod
    from ocflow_torch.models import flow_net_s as fns
    from ocflow_torch.models import pwc_fast, pwc_net
    from ocflow_torch.models.pwc_net import FlowNetCV
    from ocflow_torch.tools.q8_error import flow_errors
    from ocflow_torch.train import (LONGRUN_SYNTHETIC, config_from_dict, create_train_state,
                                    loop, make_unsupervised_flow_step)
    from ocflow_torch.train_unsupervised import viz_fn
    from ocflow_torch.utils.png import encode_png
    from ocflow_torch.utils.viz import flow_to_image

    dev = torch.device("cuda")
    launches, warm_ms = {}, {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        # 1. the trees, 2. read back bit for bit
        t0 = time.perf_counter()
        trees, written = _write_trees(out)
        print(f"files: wrote the Sintel ({FILES_SINTEL}), KITTI ({FILES_KITTI}) and "
              f"FlyingChairs2 ({FILES_CHAIRS2}) trees in {time.perf_counter() - t0:.2f} s "
              f"(host)")
        path, img = written["frame"]
        path_o, occ = written["occ"]
        path_f, flow = written["flo"]
        path_k, raw = written["kitti_flow"]
        kflow = read_kitti_png_flow(path_k)
        checks = {
            "frame": np.array_equal(read_gen(path), img),
            "occlusion": np.array_equal(read_gen(path_o), occ),
            ".flo": np.array_equal(read_flo(path_f), flow),
            "kitti 16-bit": (np.array_equal(kflow[..., 0], (raw[..., 0] - 2.0 ** 15) / 64.0)
                             and np.array_equal(kflow[..., 1], (raw[..., 1] - 2.0 ** 15) / 64.0)
                             and np.array_equal(kflow[..., 2], raw[..., 2]))}
        print(f"files IO: read back bit for bit {checks}")
        if not all(checks.values()):
            raise AssertionError(f"file IO round trip {checks}")

        # host decode per pair: one thread, then the loader's 6
        ds = build_dataset("MpiSintelClean", root=trees["sintel"])
        pair = ds.image_list[0]
        th, tw = sintel_hw = ds.render_size
        t0 = time.perf_counter()
        for p in ds.image_list:
            native_io.read_pair_norm(*p, th, tw)
        dec_ms = (time.perf_counter() - t0) * 1e3 / len(ds)
        with ThreadPoolExecutor(6) as pool:
            list(pool.map(lambda p: native_io.read_pair_norm(*p, th, tw), ds.image_list))
            t0 = time.perf_counter()
            for _ in range(3):
                list(pool.map(lambda p: native_io.read_pair_norm(*p, th, tw), ds.image_list))
            dec6_ms = (time.perf_counter() - t0) * 1e3 / (3 * len(ds))
        t0 = time.perf_counter()
        for i in range(len(ds)):
            ds[i]
        sample_ms = (time.perf_counter() - t0) * 1e3 / len(ds)
        loader = DataLoader(ds, len(ds), num_workers=6, drop_last=False)
        t0 = time.perf_counter()
        batch = next(iter(loader))
        loader_ms = (time.perf_counter() - t0) * 1e3 / len(ds)
        print(f"files decode: Sintel {FILES_SINTEL[2]}x{FILES_SINTEL[3]} -> {th}x{tw}, "
              f"{len(ds)} pairs ({os.path.getsize(pair[0])} B a frame): the fused decode "
              f"of a PNG pair {dec_ms:.2f} ms on one thread, {dec6_ms:.2f} ms per pair on 6 "
              f"threads (warm pool, 3 passes); a sample with its .flo {sample_ms:.2f} ms "
              f"(one thread); a batch of all {len(ds)} through the loader's 6 threads, "
              f"stacked, {loader_ms:.2f} ms per pair (host clock; {os.cpu_count()} CPUs) "
              f"[{card}]")
        if tuple(batch["images"].shape) != (len(ds), th, tw, 6):
            raise AssertionError(f"Sintel batch {batch['images'].shape}")
        del batch, loader

        # 3. evaluate --task flow --model pwc on Sintel and KITTI: on the
        # kernels (calls recorded, launches counted per batch), then on the
        # plain cost volume
        runs = [("evaluate_sintel", "MpiSintelClean", trees["sintel"], "flow", "pwc", pwc_net),
                ("evaluate_kitti", "KITTI2015", trees["kitti"], "flow", "pwc", pwc_net),
                ("evaluate_flowoccnetc", "MpiSintelFlowOccClean", trees["sintel"],
                 "flow_occ", "flowoccnetc", fns)]
        for run in runs:
            launches[run[0]], warm_ms[run[0]] = _eval_path(card, max_err, *run)

        # evaluate's steady rate: 12 batches of 8 from a tree of links,
        # timed from the second batch's forward to the end (the model's
        # build and the cold first batch left out), then again under
        # torch.profiler for the card's busy share in that window
        from torch.profiler import ProfilerActivity, profile, record_function

        from ocflow_torch.models import predict

        def marked(model, x):
            with record_function("evaluate.predict"):
                return predict(model, x)

        root = _linked_sintel(trees["sintel"], os.path.join(out, "sintel_steady"),
                              FILES_STEADY_FRAMES[0])
        argv = ["--task", "flow", "--model", "pwc", "--dataset", "MpiSintelClean", "--root",
                root, "--batch_size", "8"]
        n = len(build_dataset("MpiSintelClean", root=root))
        rates = []
        for traced in (False, True):
            with _Timed(evaluate, "predict", fn=marked) as timed, (
                    profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                    if traced else contextlib.nullcontext()) as prof:
                res = evaluate.main(argv)
                t_end = time.perf_counter()
            window = (t_end - timed.starts[1]) * 1e3
            rates.append((n - 8) * 1e3 / window)
            if not traced:
                per_batch, span = window / (len(timed.starts) - 1), timed.span_ms(1)
                batches, first_ms = len(timed.starts), (timed.starts[1] - timed.starts[0]) * 1e3
        busy, traced_ms = _busy_share(prof, "evaluate.predict")
        print(f"e2e evaluate_steady (MpiSintelClean, {n} pairs of {sintel_hw}, {batches} "
              f"batches of 8): {rates[0]:.2f} pairs/s from the second batch's forward to "
              f"the end ({per_batch:.1f} ms a batch; the first batch {first_ms:.1f} ms); "
              f"beside it the decode of 8 pairs on 6 threads {8 * dec6_ms:.1f} ms and the "
              f"warm forward {warm_ms['evaluate_sintel']:.2f} ms a batch; the forwards' "
              f"CUDA-event span {100 * span / window:.1f}% of the window (idle gaps inside "
              f"counted); under torch.profiler {rates[1]:.2f} pairs/s, the card busy "
              f"{100 * busy:.1f}% of {traced_ms:.1f} ms (kernels and copies, union); epe "
              f"{res['epe']:.4f} [{card}]")
        if not (batches == n // 8 and all(math.isfinite(r) and r > 0 for r in rates)
                and 0 < busy <= 1 and math.isfinite(res["epe"])):
            raise AssertionError(f"evaluate_steady: {batches} batches, {rates}, busy {busy}")
        del prof, timed

        # 5. infer --q8 --save_flo pair by pair on Sintel and KITTI frames
        targets = [(pwc_fast, n) for n in ("cost_volume", "conv_group", "conv_group_q8")]
        linked = _linked_sintel(trees["sintel"], os.path.join(out, "sintel_infer"),
                                FILES_STEADY_FRAMES[1])
        for path_name, frames in (("infer_q8", os.path.join(linked, "clean", "scene_0")),
                                  ("infer_q8_kitti", os.path.join(trees["kitti"], "image_2"))):
            dst = os.path.join(out, path_name)
            first = {}

            def fast(model, x, q8=None, device=None):
                if not first:  # the first pair: every kernel call recorded
                    first["calls"] = _record(targets, lambda: first.update(
                        out=pwc_fast.fast_apply(model, x, q8=q8, device=device)))
                    first.update(model=model, x=x, q8=q8)
                    return first["out"]
                return pwc_fast.fast_apply(model, x, q8=q8, device=device)

            with _Timed(infer, "fast_apply", fn=fast, keep=True) as timed:
                t0 = time.perf_counter()
                paths = infer.main(["--input", frames, "--output", dst, "--save_flo", "--q8"])
                wall = (time.perf_counter() - t0) * 1e3
            n = len(timed.calls)
            for kind, args in first["calls"]:
                if kind == "conv_group_q8":
                    _check_q8(args, max_err, f"{path_name} ")
                else:
                    _check_float(kind, args, torch.float32, max_err, f"{path_name} ")
            same = [np.array_equal(read_flo(paths[2 * i + 1]), out_[0][0].cpu().numpy())
                    for i, (_, _, out_) in enumerate(timed.calls)]
            with torch.no_grad(), _plain_eager_cost_volume():
                ref = first["model"](first["x"])
            e = flow_errors(timed.calls[0][2][1], ref[1])
            want = pwc_fast.prepare(first["model"], torch.float32, dev,
                                    first["q8"]).launch_counts()
            expect = {"cost_volume": 5, "cost_volume_bwd": 0, "conv_group_diff": 0, **want,
                      "gemm_probe": 0}
            launches[path_name] = timed.counts[0]
            steady = np.diff(timed.starts) * 1e3  # ms from one pair's start to the next
            # the host's share of a pair: colouring, PNG encode, .flo write
            flow0 = timed.calls[-1][2][0][0].cpu().numpy()
            host = {}
            for what, fn in (("flow_to_image", lambda: flow_to_image(flow0)),  # noqa: B023
                             ("PNG encode", lambda: encode_png(flow_to_image(flow0))),  # noqa: B023
                             (".flo write", lambda: write_flo(  # noqa: B023
                                 os.path.join(out, "t.flo"), flow0))):
                t0 = time.perf_counter()
                fn()
                host[what] = (time.perf_counter() - t0) * 1e3
            host["PNG encode"] -= host["flow_to_image"]
            shape = tuple(first["x"].shape)
            print(f"main path {path_name} ({n} pairs of {shape}) launches per pair: "
                  f"{timed.counts[0]} (expected {expect}; all pairs equal: "
                  f"{all(c == expect for c in timed.counts)})")
            print(f"e2e {path_name}: .flo files equal to fast_apply's flow bit for bit "
                  f"{same}; the W8A8 quarter flow vs the eager fp32 forward (plain cost "
                  f"volume) max_abs_err {e['max_abs']:.3e} ({e['max_abs_rel']:.4f} of "
                  f"max|flow_quarter|, tol {E2E_Q8_TOL['w8a8']}); {n} pairs in {wall:.1f} ms "
                  f"wall ({n * 1e3 / wall:.2f} pairs/s end to end, the model's build and the "
                  f"calibration included; {1e3 / steady.mean():.2f} pairs/s between the "
                  f"pairs after the first, {steady.mean():.1f} ms per pair), fast_apply's "
                  f"CUDA-event span {timed.span_ms():.1f} ms (per pair "
                  f"{[round(a.elapsed_time(b), 2) for a, b in timed.events]} ms, idle gaps "
                  f"inside counted; the first with its calls recorded); host ms per pair "
                  f"{host} [{card}]")
            if any(c != expect for c in timed.counts) or (
                    want["conv_group"], want["conv_group_q8"], want["conv_group_q8_tma"]) \
                    != (24, 0, 35):
                raise AssertionError(f"{path_name} launches {timed.counts}")
            if not all(same) or len(paths) != 2 * n or not e["max_abs_rel"] <= E2E_Q8_TOL["w8a8"]:
                raise AssertionError(f"{path_name}: flo {same}, W8A8 {e}")
            del first, timed, ref

        # 6. one epoch of fit on FlyingChairs2 through make_loaders (root,
        # device cache), the longrun hparams, one train step's kernel calls
        # replayed and its launches counted
        cfg = config_from_dict({
            **LONGRUN_SYNTHETIC, "dataset_name": "FlyingChairs2", "root": trees["chairs2"],
            "image_size": None, "dataset_size": None, "max_epochs": 1,
            "log_every_n_steps": 1, "num_workers": 6, "metrics_csv": f"{out}/fit.csv",
            "log_dir": f"{out}/tb", "checkpoint_dir": f"{out}/ckpt",
            "result_dir": f"{out}/fit"})
        t0 = time.perf_counter()
        train_loader, val_loader, test_loader = loop.make_loaders(cfg, dev)
        cache = train_loader.cache()
        cache_s = time.perf_counter() - t0
        n, h, w = FILES_CHAIRS2
        n_train = int(0.8 * n)
        want = {"images": ((n_train, h, w, 6), torch.bfloat16),
                "flow": ((n_train, h, w, 2), torch.float32),
                "occ": ((n_train, h, w, 1), torch.bfloat16)}  # 0/1: exact in bf16
        got = {k: (tuple(v.shape), v.dtype) for k, v in cache.items()}
        print(f"fit files: FlyingChairs2 {h}x{w} through make_loaders (root, device cache): "
              f"train cache {got} (expected {want}), built in {cache_s:.2f} s [{card}]")
        if got != want or any(v.device.type != dev.type for v in cache.values()):
            raise AssertionError(f"FlyingChairs2 cache {got}")
        model = FlowNetCV(displacement=cfg.displacement,
                          generator=torch.Generator().manual_seed(cfg.seed))
        state = create_train_state(model, cfg.learning_rate, device=dev)
        train_step, eval_step = make_unsupervised_flow_step(cfg.as_hparams())
        names = {"cost_volume_backward": "cost_volume_bwd"}
        step_targets = [(pwc_fast, "cost_volume"), (pwc_fast, "conv_group"),
                        (pwc_fast, "conv_group_diff"), (cv_mod, "cost_volume_backward")]
        rec = {}

        def train_wrapped(st, batch):
            if st.step == 0:
                box = {}
                rec["calls"] = _record(step_targets, lambda: box.update(
                    r=train_step(st, batch)))
                return box["r"]
            before = _read_counts(bwd=True)
            r = train_step(st, batch)
            after = _read_counts(bwd=True)
            rec["launches"] = {k: after[k] - before[k] for k in after}
            return r

        t0 = time.perf_counter()
        state = loop.fit(cfg, state, train_wrapped, eval_step, train_loader, val_loader,
                         viz_fn=viz_fn)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        for kind, args in rec["calls"]:
            _check_float(names.get(kind, kind), args, torch.bfloat16, max_err, "fit files ")
        launches["fit_files"] = rec["launches"]
        test = loop.evaluate(cfg, state, eval_step, test_loader)
        print(f"main path fit_files (one bf16 train step of fit, B={cfg.batch_size}, "
              f"{h}x{w}) launches: {rec['launches']} (expected {FIT_STEP_LAUNCHES}); "
              f"{len(rec['calls'])} kernel calls of the first step replayed; one epoch of "
              f"{n_train // cfg.batch_size} steps in {fit_s:.2f} s wall; test {test} [{card}]")
        if rec["launches"] != FIT_STEP_LAUNCHES or state.step != n_train // cfg.batch_size \
                or not all(math.isfinite(v) for v in test.values()) or "occ_error" not in test:
            raise AssertionError(f"fit on FlyingChairs2: {rec['launches']}, step "
                                 f"{state.step}, test {test}")
        del state, rec, train_loader, val_loader, test_loader, cache
        torch.cuda.empty_cache()
        print(f"files: phase 11 took {time.perf_counter() - t_phase:.1f} s wall")
        if then is not None:
            launches.update(then(trees))
    return launches


# phase 12: the cost-volume kernels at the d values the tuned 4 and 10 leave
# (C2), at one FlowNetCV level-2 shape and at level 6, fp32 and bf16
CV_NEW_DISPLACEMENTS = (1, 2, 3, 5, 6, 7, 8, 9)
CV_NEW_SHAPES = ((8, 64, 112, 256), (8, 196, 7, 16))


def _displacement_phase(card, max_err):
    """Every d of ``CV_NEW_DISPLACEMENTS`` at each shape of
    ``CV_NEW_SHAPES``, fp32 and bf16, forward and backward (a seeded
    cotangent): each call against its plain version (``KERNEL_TOL``) and its
    time against its bound. Returns ``{kind: {d: {dtype: [ms, bound_ms,
    bound_by] per shape}}}``."""
    from ocflow_torch.bench import cuda_ms
    from ocflow_torch.kernels import cost_volume as cv_mod

    out = {"cost_volume": {}, "cost_volume_bwd": {}}
    gen = torch.Generator(device="cuda").manual_seed(12)
    for d in CV_NEW_DISPLACEMENTS:
        for kind in out:
            out[kind][d] = {"float32": [], "bfloat16": []}
        for shape in CV_NEW_SHAPES:
            f1, f2 = (torch.randn(*shape, device="cuda", generator=gen) for _ in range(2))
            b, _, h, w = shape
            g = torch.randn(b, (2 * d + 1) ** 2, h, w, device="cuda", generator=gen)
            for dtype in (torch.float32, torch.bfloat16):
                a1, a2, ag = f1.to(dtype), f2.to(dtype), g.to(dtype)
                for kind, args, run, cost in (
                        ("cost_volume", (a1, a2, d),
                         lambda: cv_mod.cost_volume(a1, a2, d), _cv_cost),  # noqa: B023
                        ("cost_volume_bwd", (a1, a2, ag, d),
                         lambda: cv_mod.cost_volume_backward(a1, a2, ag, d),  # noqa: B023
                         _cv_bwd_cost)):
                    _check_float(kind, args, dtype, max_err, f"d={d} ")
                    ms = cuda_ms(run, 10)
                    nbytes, ops = cost(a1, d)
                    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
                    o_ms = ops / PEAK_FLOPS[torch.float32] * 1e3
                    by = "bytes" if b_ms >= o_ms else "operations"
                    out[kind][d][str(dtype)[6:]].append([ms, max(b_ms, o_ms), by])
                    print(f"time {kind} d={d} {str(dtype)[6:]} {shape}: kernel {ms:.4f} ms, "
                          f"bound {max(b_ms, o_ms):.4f} ms ({by}; bytes {b_ms:.4f} ms at "
                          f"3.35 TB/s, fp32 operations {o_ms:.4f} ms at 67 TFLOP/s), "
                          f"{100 * max(b_ms, o_ms) / ms:.1f}% of bound [{card}]")
            del f1, f2, g
    return out


# phase 12: one supervised train step per net at full width (448x1024, B=8,
# fp32, seeded weights), deterministic algorithms and TF32 off throughout.
# The loss (relative) and the updated BatchNorm statistics (max-abs over
# max|ref|) against the same step on the plain cost volume, forward and
# backward; each parameter's gradient (max-abs over its max|grad|) against
# the same step with the kernel forward and the plain backward, as phase 9
# holds FlowNetC's input gradient: the two differ in the backward's
# summation order only. With the plain forward too, the forward's summation
# order flips a few LeakyReLU slopes and train-mode BatchNorm carries that
# far: 8e-4-3.4e-2 of max|grad| per tensor on the H100 (printed, not held).
# A bias that feeds a train-mode BatchNorm, whose gradient is zero but for
# rounding, is held over the net's largest max|grad|.
# A bias's gradient is a sum of its output's gradient over B*H*W = 3.7M
# pixels; where those terms cancel, summation order moves it by a few fp32
# eps of the terms' absolute sum: a bias is held to the larger of 1e-4 of
# its max|grad| and 1e-5 (~170 eps) of that sum. The phase prints each bias
# that rule raises, with its error over its own max|grad| and the bound that
# amounts to (on the H100 the largest: flowoccnet's one-channel
# occlusion_estimators.0.upconv2.bias, 1.13e-3 of its own max|grad| against
# a bound of 0.38; every other bias at most 9.3e-6). The witness, printed
# and not held: the same step in fp64 on the plain cost volume, from which
# the kernel step and the plain step lie equally far in every net (that
# bias: 0.90 and 1.12 of its max|grad|, below fp32's resolution of its sum).
SUP_LOSS_REL = 1e-5
SUP_GRAD_REL = 1e-4
SUP_BIAS_TERMS = 1e-5
SUP_STATS_REL = 1e-5
# (registry family, key, network_type, data): the Sintel flow+occlusion tree
# of phase 11 resized to 448x1024, or SyntheticFlow at 448x1024
SUP_NETS = (("flow_occ", "pwoc", "flow-occ", "sintel"),
            ("flow_occ", "pwoc2", "flow-occ", "sintel"),
            ("flow_occ", "flowoccnet", "flow-occ", "sintel"),
            ("flow_occ", "flowoccnetc", "flow-occ", "sintel"),
            ("flow", "flownet", "flow", "synthetic"),
            ("flow", "pwc", "flow", "synthetic"),
            ("occ", "occnetc", "occ", "sintel"))


def _net_module(key):
    """The module whose name ``cost_volume`` the net ``key`` calls."""
    from ocflow_torch.models import flow_net, flow_net_s, flow_occ_nets, pwc_net

    return {"pwoc": flow_occ_nets, "pwoc2": flow_occ_nets, "flowoccnet": flow_occ_nets,
            "flownet": flow_net, "pwc": pwc_net, "pwcnet": pwc_net}.get(key, flow_net_s)


def _bias_term_sums(model, sums):
    """Backward hooks adding, per conv or transposed conv with a bias, the
    largest over its channels of the sum of |d loss / d output| over batch
    and pixels into ``sums[module name]`` (the terms its bias's gradient
    sums); returns the handles."""
    from torch import nn

    def hook(name):
        def add(mod, grad_in, grad_out):
            sums[name] = sums.get(name, 0.0) + grad_out[0].detach().abs().sum(
                (0, 2, 3)).max().item()
        return add

    return [m.register_full_backward_hook(hook(n)) for n, m in model.named_modules()
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)) and m.bias is not None]


def _grad_scales(model, ref_grads, terms):
    """``(scale, bn_fed)``: ``scale(name, ref)`` is what a parameter's
    gradient error against ``ref`` is held over (see the phase-12 constants
    above): a bias fed to a train-mode BatchNorm (FPNUp's deconv; ``bn_fed``,
    its names) over the net's largest max|grad|, a bias over the larger of
    its max|grad| and SUP_BIAS_TERMS / SUP_GRAD_REL of its terms' absolute
    sum (``terms``, from :func:`_bias_term_sums`), any other tensor over its
    max|grad|."""
    from ocflow_torch.models.feature_pyramid import FPNUp

    top = max(g.abs().max() for g in ref_grads.values())
    bn_fed = {f"{m}.deconv.bias" for m, mod in model.named_modules()
              if isinstance(mod, FPNUp)}

    def scale(n, ref):
        if n in bn_fed:
            return top
        cond = terms.get(n[:-len(".bias")], 0.0) if n.endswith(".bias") else 0.0
        return torch.maximum(ref[n].abs().max(), torch.as_tensor(
            SUP_BIAS_TERMS / SUP_GRAD_REL * cond, device=ref[n].device)).clamp_min(1e-30)

    return scale, bn_fed


def _print_bias_terms(label, grads, ref_grads, gerr, scale, bn_fed):
    """Print each bias whose scale the term-sum rule raised above its own
    max|grad|: its error over its own max|grad|, over the term-sum scale,
    and the bound that amounts to over its own max|grad|."""
    held = []
    for n, r in ref_grads.items():
        own = r.abs().max().clamp_min(1e-30)
        ratio = (scale(n, ref_grads) / own).item()
        if n.endswith(".bias") and n not in bn_fed and ratio > 1:
            held.append((n, ((grads[n] - r).abs().max() / own).item(), gerr[n],
                         SUP_GRAD_REL * ratio))
    held.sort(key=lambda t: -t[1])
    print(f"e2e {label}: {len(held)} biases held by their terms' sum (name: error over "
          f"its own max|grad|, over the term-sum scale, effective bound over its own "
          f"max|grad|): " + ", ".join(f"{n} {e_own:.3e} {e_scaled:.3e} {bound:.3e}"
                                      for n, e_own, e_scaled, bound in held))


def _hold_train_step(card, max_err, label, desc, model, train_step, batch, module,
                     expect_cv, det, lr=1e-4, dev="cuda", around=contextlib.nullcontext,
                     witness=False):
    """One train step of ``model`` (``train_step`` from one of the step
    factories) on ``batch``, held as the phase-12 constants above say: the
    kernel step inside ``around()``, its launches against ``expect_cv``
    (cost-volume forward and backward; nothing else), every cost-volume call
    forward and backward replayed against its plain version, the loss,
    metrics and BatchNorm statistics against the same step on the plain cost
    volume, the gradients against the same step with the plain backward on
    the kernel forward (each bias by its terms' sum too, printed both ways),
    with ``witness`` an fp64 step on the plain cost volume printed; then the
    warm step's ms (median of 5) with the algorithms ``det`` names (the
    caller's deterministic ones are on until then). ``module`` is the module
    whose name ``cost_volume`` the net calls. Returns the launch counts, the
    step ms and the failures."""
    import math

    from ocflow_torch.bench import BATCH, HEIGHT, WIDTH
    from ocflow_torch.kernels import cost_volume as cv_mod
    from ocflow_torch.train import TrainState, create_train_state

    failures = []
    ref_model = copy.deepcopy(model)
    state = create_train_state(model, lr, device=dev)
    box = {}
    with around():
        _zero_counts()
        calls = _record([(module, "cost_volume"), (cv_mod, "cost_volume_backward")],
                        lambda: box.update(out=train_step(state, batch)))
        counts = _read_counts()
    metrics = box.pop("out")[1]
    grads = {n: p.grad.detach().clone() for n, p in state.model.named_parameters()}
    stats = {n: b.detach().clone() for n, b in state.model.named_buffers()
             if n.endswith(("running_mean", "running_var"))}

    # the references: the same step with the kernel forward and the plain
    # backward (gradients held), and with the plain cost volume forward and
    # backward (metrics and statistics held; its gradients printed: the
    # forward's summation order flips LeakyReLU slopes)
    refs, terms = {}, {}
    for name, fn in (("plain backward", lambda f1, f2, d: _PlainBackward.apply(
                         f1, f2, d, cv_mod.cost_volume)),
                     ("plain", cv_mod.cost_volume_plain)):
        ref_state = create_train_state(copy.deepcopy(ref_model), lr, device=dev)
        saved = module.cost_volume
        module.cost_volume = fn
        hooks = _bias_term_sums(ref_state.model, terms) if name != "plain" else []
        try:
            _, ref_metrics = train_step(ref_state, batch)
        finally:
            module.cost_volume = saved
            for h in hooks:
                h.remove()
        refs[name] = (ref_metrics,
                      {n: p.grad for n, p in ref_state.model.named_parameters()},
                      {n: b for n, b in ref_state.model.named_buffers() if n in stats})
        del ref_state
    ref_grads = refs["plain backward"][1]
    ref_metrics, plain_grads, ref_stats = refs["plain"]
    exact_grads = None
    if witness:
        # the same step in fp64 on the plain cost volume
        exact = copy.deepcopy(ref_model).to(dev, torch.float64)
        exact_state = TrainState(exact, torch.optim.Adam(exact.parameters(), lr=lr))
        saved = module.cost_volume
        module.cost_volume = cv_mod.cost_volume_plain
        try:
            train_step(exact_state, {k: v.double() if v.is_floating_point() else v
                                     for k, v in batch.items()})
        finally:
            module.cost_volume = saved
        exact_grads = {n: p.grad for n, p in exact.named_parameters()}
        del exact_state, exact

    n_fwd, n_bwd = expect_cv
    expect = {k: 0 for k in counts}
    expect.update(cost_volume=n_fwd, cost_volume_bwd=n_bwd)
    n_rec = sum(k == "cost_volume" for k, _ in calls)
    print(f"main path {label} ({desc}, B={BATCH} {HEIGHT}x{WIDTH}) launches: {counts} "
          f"(expected {expect})")
    if counts != expect or (n_rec, len(calls) - n_rec) != (n_fwd, n_bwd):
        failures.append(f"{label} launches {counts}")
    for k, (kind, args) in enumerate(calls):
        _check_float("cost_volume_bwd" if kind == "cost_volume_backward" else kind,
                     args, torch.float32, max_err, f"{label} d={args[-1]} call {k} ")
    del calls
    merr = {k: abs(metrics[k].item() - v.item()) / max(abs(v.item()), 1e-30)
            for k, v in ref_metrics.items()}
    scale, bn_fed = _grad_scales(ref_model, ref_grads, terms)

    def grad_errors(ref):
        return {n: ((g - ref[n]).abs().max() / scale(n, ref)).item()
                for n, g in grads.items()}

    gerr, gplain = grad_errors(ref_grads), grad_errors(plain_grads)
    _print_bias_terms(label, grads, ref_grads, gerr, scale, bn_fed)
    if exact_grads is not None:
        # each tensor over its own max|grad| (a bias fed to a train-mode
        # BatchNorm over the net's largest), not held
        top64 = max(g.abs().max() for g in exact_grads.values())
        wit = {}
        for what, got in (("kernel step", grads), ("plain cost volume step", plain_grads)):
            wit[what] = {n: ((got[n].double() - g).abs().max() / (
                top64 if n in bn_fed else g.abs().max().clamp_min(1e-300))).item()
                for n, g in exact_grads.items()}
        print(f"e2e {label}: gradients against the fp64 step on the plain cost volume "
              f"(not held), worst / median over {len(exact_grads)} tensors: "
              + "; ".join(f"{what} {_worst(e)} / {sorted(e.values())[len(e) // 2]:.3e}"
                          for what, e in wit.items()))
        del exact_grads
    serr = {n: ((b - ref_stats[n]).abs().max()
                / ref_stats[n].abs().max().clamp_min(1e-30)).item()
            for n, b in stats.items()}
    print(f"e2e {label}: loss {metrics['loss'].item():.6e}, on the plain cost volume "
          f"{ref_metrics['loss'].item():.6e}, metrics relative {_worst(merr)} (tol "
          f"{SUP_LOSS_REL}); gradients against the plain backward on the same forward, "
          f"worst max-abs over max|grad| (a bias: over the term-sum scale where that is "
          f"larger, listed above) {_worst(gerr)} over {len(gerr)} tensors (tol "
          f"{SUP_GRAD_REL}); against the plain forward and backward {_worst(gplain)} (not "
          f"held: the forward's summation order flips LeakyReLU slopes); BatchNorm "
          f"statistics worst {_worst(serr) if serr else 'none'} over {len(serr)} buffers "
          f"(tol {SUP_STATS_REL})")
    if max(merr.values()) > SUP_LOSS_REL or max(gerr.values()) > SUP_GRAD_REL or (
            serr and max(serr.values()) > SUP_STATS_REL) or not all(
            math.isfinite(v.item()) for v in metrics.values()):
        failures.append(f"{label}: metrics {_worst(merr)}, gradients {_worst(gerr)}, "
                        f"statistics {_worst(serr) if serr else None}")
    if serr:
        moved = max((b - 1.0 if n.endswith("var") else b).abs().max().item()
                    for n, b in stats.items())
        print(f"e2e {label}: BatchNorm statistics moved from the identity by up to "
              f"{moved:.3e}")
        if not moved > 0:
            failures.append(f"{label}: BatchNorm statistics did not move")
    del refs, ref_grads, plain_grads, ref_stats, grads, stats, ref_model

    # the warm step's time, median of 5, with the algorithms ``det`` names
    # (PyTorch's defaults: what a run of the CLI takes)
    torch.backends.cudnn.deterministic = det[0]
    torch.use_deterministic_algorithms(det[1], warn_only=det[2])
    train_step(state, batch)
    each = []
    for _ in range(5):
        _, ms = _timed_once(lambda: train_step(state, batch))
        each.append(ms)
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    step_ms = sorted(each)[2]
    print(f"time {label} train step B={BATCH} {HEIGHT}x{WIDTH} ({desc}): {step_ms:.3f} ms "
          f"(median of 5 warm steps, CUDA events, default algorithms; runs "
          f"{[round(e, 3) for e in each]}), {BATCH * 1e3 / step_ms:.2f} pairs/s [{card}]")
    del state
    torch.cuda.empty_cache()
    return counts, step_ms, failures


def _supervised_step_phase(card, max_err, sintel_root, dev="cuda"):
    """One supervised train step of each net of ``SUP_NETS`` (see the
    constants above, :func:`_hold_train_step`), pwoc's gradient into its
    occlusion gate through ``warped * occ``; then FlowNetCV's step under
    ``compute_dtype: bfloat16``. Returns the launch counts per net and the
    step ms per net."""
    import math

    import torch.nn.functional as F

    from ocflow_torch.bench import BATCH, HEIGHT, SEED, WIDTH
    from ocflow_torch.data import DataLoader, build_dataset
    from ocflow_torch.models import flow_occ_nets as fon
    from ocflow_torch.models import registry
    from ocflow_torch.models.pwc_net import FlowNetCV
    from ocflow_torch.train import create_train_state
    from ocflow_torch.train.__main__ import REGIMES

    data = {"sintel": build_dataset("MpiSintelFlowOccClean", root=sintel_root,
                                    image_size=(HEIGHT, WIDTH)),
            "synthetic": build_dataset("SyntheticFlow", size=BATCH,
                                       image_size=(HEIGHT, WIDTH), device=dev)}
    batches = {k: {n: t.to(dev) for n, t in next(iter(DataLoader(ds, BATCH))).items()}
               for k, ds in data.items()}
    launches, failures, step_ms = {}, [], {}
    det = (torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    # deterministic cuDNN algorithms, and the warps' scatter-add backward
    # (index_add_) in its deterministic form: two runs of a step agree but
    # for the cost volume's summation order
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for family, key, network_type, source in SUP_NETS:
            gen = torch.Generator().manual_seed(SEED)
            model = FlowNetCV(generator=gen) if key == "pwc" else registry.build(
                family, key, generator=gen)
            train_step, _ = REGIMES[network_type][1]({"model": key,
                                                      "compute_dtype": "float32"})
            gate = []

            @contextlib.contextmanager
            def gated_cost_volume():
                """pwoc's gradient into its occlusion gate, recorded."""
                saved_gate = fon.occlusion_gated_cost_volume

                def gated(f1, warped, occ, d):
                    prod = warped * occ
                    if prod.requires_grad:
                        prod.register_hook(lambda g, w=warped: gate.append(  # noqa: B023
                            (g * w).sum(1).abs().max().item()))
                    return F.leaky_relu(fon.cost_volume(f1, prod, d), 0.1)

                fon.occlusion_gated_cost_volume = gated
                try:
                    yield
                finally:
                    fon.occlusion_gated_cost_volume = saved_gate

            label = f"supervised_{key}"
            d10 = key in ("flowoccnetc", "occnetc")
            launches[label], step_ms[key], found = _hold_train_step(
                card, max_err, label, f"one {network_type} train step, fp32", model,
                train_step, batches[source], _net_module(key), (1, 1) if d10 else (5, 5),
                det, dev=dev, around=gated_cost_volume, witness=True)
            failures += found
            if key == "pwoc":
                print(f"e2e supervised_pwoc: gradient into the occlusion gate through "
                      f"warped * occ, max over the four gated levels "
                      f"{max(gate) if gate else 0.0:.3e} ({len(gate)} levels)")
                if len(gate) != 4 or not max(gate) > 0:
                    failures.append(f"pwoc gate gradient {gate}")
            del model
    finally:
        torch.backends.cudnn.deterministic = det[0]
        torch.use_deterministic_algorithms(det[1], warn_only=det[2])

    # FlowNetCV under compute_dtype bfloat16 (what `model: pwc` with the
    # longrun's compute_dtype trains: autocast over fp32 weights): launches,
    # the loss beside the fp32 step's, the warm step's ms
    train_step, _ = REGIMES["flow"][1]({"model": "pwc", "compute_dtype": "bfloat16"})
    state = create_train_state(FlowNetCV(generator=torch.Generator().manual_seed(SEED)), 1e-4,
                               device=dev)
    counts, (_, metrics) = _count_launches(lambda: train_step(state, batches["synthetic"]))
    expect = {k: 0 for k in counts}
    expect.update(cost_volume=5, cost_volume_bwd=5)
    launches["supervised_pwc_bf16"] = counts
    each = []
    for _ in range(6):
        _, ms = _timed_once(lambda: train_step(state, batches["synthetic"]))  # noqa: B023
        each.append(ms)
    step_ms["pwc_bf16"] = sorted(each[1:])[2]
    print(f"main path supervised_pwc_bf16 (one flow train step, compute_dtype bfloat16, "
          f"B={BATCH} {HEIGHT}x{WIDTH}) launches: {counts} (expected {expect}); loss "
          f"{metrics['loss'].item():.6e}")
    print(f"time supervised_pwc_bf16 train step B={BATCH} {HEIGHT}x{WIDTH} bf16 autocast: "
          f"{step_ms['pwc_bf16']:.3f} ms (median of 5 warm steps; runs "
          f"{[round(e, 3) for e in each[1:]]}), {BATCH * 1e3 / step_ms['pwc_bf16']:.2f} "
          f"pairs/s [{card}]")
    if counts != expect or not math.isfinite(metrics["loss"].item()):
        failures.append(f"supervised pwc bf16: {counts} {metrics}")
    del state
    if failures:
        raise AssertionError("; ".join(failures))
    return launches, step_ms


def _yaml_value(v) -> str:
    """``v`` as the flat YAML of ``configs/*.yaml`` writes it."""
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_yaml_value(e) for e in v) + "]"
    if isinstance(v, str):
        return v or '""'
    if isinstance(v, float) and "." not in repr(v):
        return f"{v:.17e}"
    return repr(v)


def _supervised_cli_phase(card):
    """``python -m ocflow_torch.train --config configs/supervised.yaml``
    (SimpleFlowNet, SyntheticFlow 64x128, B=16) cut to 2 epochs with its
    outputs in a temporary directory, as a process of its own: exit 0, the
    CSV's rows, the best checkpoint, BatchNorm statistics that moved;
    meanwhile in this process with ``find_best_lr: true`` and 1 epoch: its
    suggestion printed. SimpleFlowNet has no cost volume: no kernel of this
    repository runs (the second run's launches are counted)."""
    import csv
    import io
    import math
    import os
    import subprocess
    import tempfile

    from ocflow_torch.train import config as config_lib
    from ocflow_torch.train.__main__ import main as train_main
    from ocflow_torch.utils.checkpoint import CheckpointManager

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        with open("configs/supervised.yaml") as f:
            text = f.read()

        def config(name, **over):
            raw = config_lib.parse_flat_yaml(text)
            raw.update({"max_epochs": 2, "log_every_n_steps": 1,
                        "metrics_csv": os.path.join(out, name, "metrics.csv"),
                        "log_dir": os.path.join(out, name, "tb"),
                        "checkpoint_dir": os.path.join(out, name, "ckpt"), **over})
            path = os.path.join(out, f"{name}.yaml")
            with open(path, "w") as f:
                f.write("".join(f"{k}: {_yaml_value(v)}\n" for k, v in raw.items()))
            return path, raw

        path, raw = config("run")
        lr_path, _ = config("lr", max_epochs=1, find_best_lr=True)
        with subprocess.Popen([sys.executable, "-m", "ocflow_torch.train", "--config", path],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) as run:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                counts, results = _count_launches(lambda: train_main(["--config", lr_path]))
            stdout, stderr = run.communicate(timeout=600)
        proc = subprocess.CompletedProcess(run.args, run.returncode, stdout, stderr)
        test_line = [ln for ln in proc.stdout.splitlines() if ln.startswith("test:")]
        with open(raw["metrics_csv"]) as f:
            rows = list(csv.DictReader(f))
        tree = CheckpointManager(raw["checkpoint_dir"]).restore()
        var = [v for k, v in tree["params"].items() if k.endswith("running_var")]
        moved = max((v - 1.0).abs().max().item() for v in var) if var else 0.0
        phases = [r["phase"] for r in rows]
        print(f"supervised CLI (python -m ocflow_torch.train, configs/supervised.yaml, "
              f"{raw['model']}, {raw['dataset_name']} {raw['image_size']}, B="
              f"{raw['batch_size']}, 2 epochs): exit {proc.returncode}, {test_line}, CSV "
              f"{phases.count('train')} train and {phases.count('val')} val rows, best "
              f"checkpoint at step {tree['step']}, BatchNorm running variance moved from 1 by "
              f"up to {moved:.3e} over {len(var)} buffers; no kernel of this repository "
              f"runs here (SimpleFlowNet has no cost volume)")
        if proc.returncode != 0 or not test_line or phases.count("val") != 2 \
                or not phases.count("train") or not moved > 0:
            raise AssertionError(f"supervised CLI: {proc.returncode} {proc.stderr[-2000:]}")

        lines = [ln for ln in buf.getvalue().splitlines() if "find_best_lr" in ln]
        print(f"supervised CLI with find_best_lr: {lines}, test {results}; launches "
              f"{counts} (none expected: no kernel runs here)")
        if not lines or any(counts.values()) or not all(
                math.isfinite(v) for v in results.values()):
            raise AssertionError(f"find_best_lr run: {lines} {counts} {results}")
    print(f"supervised CLI: {time.perf_counter() - t0:.1f} s wall [{card}]")


def _phase12(card, max_err, trees):
    """Phase 12 (module docstring): the cost volume at every d, the
    supervised CLI, one supervised train step per net at full width, and
    the new nets served by ``evaluate``. Returns the launch counts by path,
    the per-d records and the step ms per net."""
    from ocflow_torch.models import flow_net, flow_occ_nets

    t0 = time.perf_counter()
    per_d = _displacement_phase(card, max_err)
    _supervised_cli_phase(card)
    launches, step_ms = _supervised_step_phase(card, max_err, trees["sintel"])
    runs = [("evaluate_pwoc", "MpiSintelFlowOccClean", trees["sintel"], "flow_occ", "pwoc",
             flow_occ_nets),
            ("evaluate_flowoccnet", "MpiSintelFlowOccClean", trees["sintel"], "flow_occ",
             "flowoccnet", flow_occ_nets),
            ("evaluate_flownet", "MpiSintelClean", trees["sintel"], "flow", "flownet",
             flow_net)]
    for run in runs:
        launches[run[0]], _ = _eval_path(card, max_err, *run)
    print(f"supervised: phase 12 took {time.perf_counter() - t0:.1f} s wall")
    return launches, per_d, step_ms


# phase 13: the unsupervised zoo. One occlusion-aware unsupervised train
# step of each flow net that launches a kernel of this repository, with
# configs/longrun_synthetic.yaml's hparams (range-map occlusion, photo 4.0,
# smooth1 0.5, compute_dtype bfloat16: the loss tail's images only, the net
# in fp32), at 448x1024, B=8, seeded weights, on SyntheticFlowWarp. Held as
# phase 12 holds the supervised steps (its constants): the metrics and every
# BatchNorm running statistic after the step (two train-mode passes: the
# forward and the stop-gradient backward-flow pass) within 1e-5 of the same
# step on the plain cost volume, each gradient within 1e-4 of its max|grad|
# of the same step with the plain backward on the kernel forward (a bias by
# its terms' sum too, printed both ways), deterministic algorithms; TF32 is
# switched on around the kernel step and read inside it (the forward, the
# backward-flow pass, the backward): it must read off. (registry key:
# cost-volume launches of one step, forward and backward)
UNSUP_NETS = {"flownetc": (2, 1), "flownet": (10, 5), "pwcnet": (10, 5)}
# the CLI run: configs/longrun_synthetic.yaml with these, its outputs in a
# temporary directory (44 samples: 35 / 4 / 5, 4 steps an epoch; one epoch,
# to leave phase 19 room in the time limit)
UNSUP_CLI_CUTS = {"model": "flownetc", "dataset_size": 44, "max_epochs": 1,
                  "log_every_n_steps": 1, "log_image_every_epoch": 1}
# the nets that launch no kernel of this repository, served (eval, fp32);
# each held against the same net on the CPU at ZOO_SMALL within ZOO_REL of
# max|out| (summation order; TF32 or a cuDNN algorithm would show)
ZOO_SERVED = (("flow", "flownets"), ("flow", "eflownet"), ("flow", "eflownet2"),
              ("occ", "simple"), ("occ", "occnets"), ("flow_occ", "simple"),
              ("flow_occ", "flowoccnets"))
ZOO_SMALL = (2, 64, 128)
ZOO_REL = 1e-4


def _unsup_step_phase(card, max_err, batch, dev="cuda"):
    """One unsupervised train step of each net of ``UNSUP_NETS`` (see the
    constants above, :func:`_hold_train_step`), PyTorch's default TF32 flag
    on around the kernel step and read inside it. Returns the launch counts
    by path and the step ms by net."""
    from torch import nn

    from ocflow_torch.bench import SEED
    from ocflow_torch.models import registry
    from ocflow_torch.train import config as config_lib
    from ocflow_torch.train import make_unsupervised_flow_step

    hp = config_lib.load_config("configs/longrun_synthetic.yaml").as_hparams()
    launches, failures, step_ms = {}, [], {}
    det = (torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for key, expect_cv in UNSUP_NETS.items():
            label = f"unsupervised_{key}"
            model = registry.build("flow", key, generator=torch.Generator().manual_seed(SEED))
            train_step, _ = make_unsupervised_flow_step({**hp, "model": key})
            first = next(m for m in model.modules() if isinstance(m, nn.Conv2d))
            tf32 = []

            @contextlib.contextmanager
            def tf32_read():
                """TF32 allowed around the step, the flag read inside it: in
                the forward, the backward-flow pass and the backward."""
                flag = lambda *a: tf32.append(torch.backends.cudnn.allow_tf32)  # noqa: E731,B023
                hooks = (first.register_forward_pre_hook(flag),  # noqa: B023
                         first.weight.register_hook(flag))  # noqa: B023
                torch.backends.cudnn.allow_tf32 = True
                try:
                    yield
                finally:
                    torch.backends.cudnn.allow_tf32 = False
                    for h in hooks:
                        h.remove()

            launches[label], step_ms[key], found = _hold_train_step(
                card, max_err, label,
                f"one occlusion-aware unsupervised train step, longrun_synthetic.yaml "
                f"hparams, the net fp32, the loss tail {hp['compute_dtype']}", model,
                train_step, batch, _net_module(key), expect_cv, det,
                lr=hp["learning_rate"], dev=dev, around=tf32_read)
            failures += found
            print(f"e2e {label}: cudnn.allow_tf32 read inside the step {sorted(set(tf32))} "
                  f"over {len(tf32)} reads (PyTorch's default flag on around it; must read "
                  f"False)")
            if len(tf32) < 3 or any(tf32):
                failures.append(f"{label}: allow_tf32 inside the step {tf32}")
            del model
    finally:
        torch.backends.cudnn.deterministic = det[0]
        torch.use_deterministic_algorithms(det[1], warn_only=det[2])
    if failures:
        raise AssertionError("; ".join(failures))
    return launches, step_ms


def _unsup_cli_phase(card, dev="cuda"):
    """``python -m ocflow_torch.train_unsupervised`` on
    ``configs/longrun_synthetic.yaml`` with ``UNSUP_CLI_CUTS`` (FlowNetC)
    and its outputs in a temporary directory, as a process of its own: exit
    0, the CSV's rows (one a train step, one a validation), the best
    checkpoint's BatchNorm running statistics moved from the identity, a
    ``test:`` line with a finite EPE; its wall time."""
    import ast
    import csv
    import math
    import os
    import subprocess
    import tempfile

    from ocflow_torch.train import config as config_lib
    from ocflow_torch.utils.checkpoint import CheckpointManager

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        with open("configs/longrun_synthetic.yaml") as f:
            raw = config_lib.parse_flat_yaml(f.read())
        raw.update(UNSUP_CLI_CUTS)
        raw.update({k: os.path.join(out, v) for k, v in (
            ("metrics_csv", "metrics.csv"), ("log_dir", "tb"), ("checkpoint_dir", "ckpt"),
            ("result_dir", "."))})
        path = os.path.join(out, "unsup.yaml")
        with open(path, "w") as f:
            f.write("".join(f"{k}: {_yaml_value(v)}\n" for k, v in raw.items()))
        proc = subprocess.run([sys.executable, "-m", "ocflow_torch.train_unsupervised",
                               "--config", path, "--device", dev],
                              capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        test_line = [ln for ln in proc.stdout.splitlines() if ln.startswith("test:")]
        results = ast.literal_eval(test_line[0][len("test:"):].strip()) if test_line else {}
        with open(raw["metrics_csv"]) as f:
            rows = list(csv.DictReader(f))
        tree = CheckpointManager(raw["checkpoint_dir"]).restore()
        stats = [(k, v) for k, v in tree["params"].items()
                 if k.endswith(("running_mean", "running_var"))]
        moved = max(((v - 1.0) if k.endswith("var") else v).abs().max().item()
                    for k, v in stats) if stats else 0.0
        phases = [r["phase"] for r in rows]
        print(f"unsupervised CLI (python -m ocflow_torch.train_unsupervised, "
              f"longrun_synthetic.yaml with {UNSUP_CLI_CUTS}, {raw['image_size']}, B="
              f"{raw['batch_size']}): exit {proc.returncode}, {test_line}, CSV "
              f"{phases.count('train')} train and {phases.count('val')} val rows, best "
              f"checkpoint at step {tree['step']}, BatchNorm running statistics moved from "
              f"the identity by up to {moved:.3e} over {len(stats)} buffers; {wall:.1f} s "
              f"wall (the process's start and TensorBoard included) [{card}]")
        n_train = int(0.8 * raw["dataset_size"]) // raw["batch_size"] * raw["max_epochs"]
        if proc.returncode != 0 or phases.count("val") != raw["max_epochs"] \
                or phases.count("train") != n_train or not moved > 0 \
                or not math.isfinite(results.get("epe", math.nan)):
            raise AssertionError(f"unsupervised CLI: {proc.returncode} {results} {phases} "
                                 f"{proc.stderr[-2000:]}")
    return wall


def _zoo_serving_phase(card, x, dev="cuda"):
    """The eval forward of each net of ``ZOO_SERVED`` through
    ``registry.load_model`` (seeded, its BatchNorm statistics perturbed from
    the seed: the seeded init starts BatchNorm at the identity) and
    ``predict``, fp32, on ``x`` (B=8, 448x1024): launches (none: these nets
    run no kernel of this repository), finite outputs of the input's size,
    the card's forward against the same net on the CPU at ``ZOO_SMALL``
    (SimpleFlowOccNet's occlusion before its straight-through hardening,
    which is checked to give 0 or 1), ms per forward. Returns the launch
    counts by path."""
    from ocflow_torch.bench import SEED, cuda_ms, perturb_batchnorm
    from ocflow_torch.models import flow_occ_nets, load_model, predict

    launches, failures = {}, []
    b, h, w = ZOO_SMALL
    small = x[:b, :h, :w].contiguous()
    for family, key in ZOO_SERVED:
        label = f"serve_{family}_{key}"
        model = load_model(family, key, device=dev)
        perturb_batchnorm(model, torch.Generator().manual_seed(SEED + 1))
        cpu = copy.deepcopy(model).cpu()
        saved = flow_occ_nets.hard_threshold_ste
        flow_occ_nets.hard_threshold_ste = lambda t: t
        try:
            got = [t for t in predict(model, small) if t is not None]
            ref = [t for t in predict(cpu, small.cpu()) if t is not None]
        finally:
            flow_occ_nets.hard_threshold_ste = saved
        errs = [((g.cpu() - r).abs().max() / r.abs().max().clamp_min(1e-30)).item()
                for g, r in zip(got, ref)]
        counts, out = _count_launches(lambda: predict(model, x))  # noqa: B023
        out = [t for t in out if t is not None]
        ms = cuda_ms(lambda: predict(model, x), 5)  # noqa: B023
        shapes = [tuple(t.shape) for t in out]
        hard = key == "simple" and family == "flow_occ"
        binary = not hard or bool(((out[1] == 0) | (out[1] == 1)).all())
        print(f"main path {label} (eval forward, fp32, B={x.shape[0]} "
              f"{x.shape[1]}x{x.shape[2]}) launches: {counts} (none expected: no kernel "
              f"of this repository); outputs {shapes}; card vs CPU at {b}x{h}x{w}: "
              f"{', '.join(f'{e:.3e}' for e in errs)} of max|CPU| (tol {ZOO_REL})"
              + (f"; occlusion in {{0, 1}}: {binary}" if hard else ""))
        print(f"time {label} forward B={x.shape[0]} {x.shape[1]}x{x.shape[2]} fp32 eval: "
              f"{ms:.3f} ms ({x.shape[0] * 1e3 / ms:.2f} pairs/s, CUDA events, mean of 5) "
              f"[{card}]")
        if any(counts.values()) or max(errs) > ZOO_REL or not binary or not all(
                torch.isfinite(t).all() for t in out) or any(
                s[:3] != tuple(x.shape[:3]) for s in shapes):
            failures.append(f"{label}: {counts} {errs} {shapes} {binary}")
        launches[label] = counts
        del model, cpu, out
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))
    return launches


def _phase13(card, max_err, dev="cuda"):
    """Phase 13 (module docstring): the unsupervised step of the zoo, the
    unsupervised CLI on FlowNetC, the nets without a kernel served. Returns
    the launch counts by path."""
    from ocflow_torch.bench import BATCH, HEIGHT, WIDTH
    from ocflow_torch.data import DataLoader, build_dataset

    t0 = time.perf_counter()
    ds = build_dataset("SyntheticFlowWarp", size=BATCH, image_size=(HEIGHT, WIDTH),
                       device=dev)
    batch = {k: t.to(dev) for k, t in next(iter(DataLoader(ds, BATCH))).items()}
    launches, step_ms = _unsup_step_phase(card, max_err, batch, dev)
    wall = _unsup_cli_phase(card, dev)
    launches.update(_zoo_serving_phase(card, batch["images"], dev))
    print(f"unsupervised zoo: step ms {step_ms}, CLI {wall:.1f} s wall; phase 13 took "
          f"{time.perf_counter() - t0:.1f} s wall [{card}]")
    return launches


# phase 14: the cost volume past d = 10 on the general kernels
# (csrc/cost_volume_any.cu), at one FlowNetCV level-2 shape and at level 6,
# fp32 and bf16; and a FlowNetC built with displacement 12 (its correlation
# 8x256x56x128 at B=8 448x1024), whose forward and input gradient launch
# them once each
CV_GENERAL_DISPLACEMENTS = (11, 12, 16, 20)
CV_FLOWNETC_D = 12
# and a FlowNetCV built as the supervised CLI builds it for `model: pwc` with
# this displacement (configs/supervised.yaml), one fp32 flow step at B=8
# 448x1024 on SyntheticFlow: its five levels' calls launch the general
# kernels forward and backward
PWC_GENERAL_D = 12
# phase 14: the inpainting slice at full width (B=8, 448x1024), fp32, TF32
# off; card against CPU at INPAINT_SMALL
INPAINT_SMALL = (2, 64, 128)
INPAINT_REL = 1e-4           # outputs, gradients: max-abs over max|CPU|
INPAINT_LOSS_REL = 1e-5      # loss: relative
INPAINT_STATS_REL = 1e-5     # BatchNorm statistics: max-abs over max|CPU|
INPAINT_METRIC_REL = 1e-5    # PSNR, SSIM against float64 on the CPU
INPAINT_SYNTH_TOL = 1e-4     # SyntheticInpainting's frames, card vs CPU
# the stage CLI: configs/inpainting_gan_fullres.yaml with these cuts
STAGE_CLI_CUTS = {"model": "simple", "adversarial_loss": False, "batch_size": 8,
                  "dataset_size": 44, "max_epochs": 2, "log_every_n_steps": 1,
                  "log_image_every_epoch": 1, "num_workers": 6}


def _hold_general(kind, args, max_err, label):
    """One general-kernel call (forward or backward) against its plain
    version within KERNEL_TOL; the general counter of the wrapper must count
    it. Returns the plain version's ms (one call, CUDA events)."""
    from ocflow_torch.kernels import cost_volume as cv_mod

    fwd = kind == "cost_volume_general"
    counter = cv_mod.cost_volume if fwd else cv_mod.cost_volume_backward
    before = counter.general_launches
    got = [cv_mod.cost_volume(*args)] if fwd else cv_mod.cost_volume_backward(*args)
    ref, plain_ms = _timed_once(lambda: [cv_mod.cost_volume_plain(*args)] if fwd
                                else cv_mod.cost_volume_backward_plain(*args))
    torch.cuda.synchronize()
    dtype = args[0].dtype
    err = max((g.float() - r.float()).abs().max().item() for g, r in zip(got, ref))
    scale = max(r.float().abs().max().item() for r in ref)
    tol = KERNEL_TOL[dtype] * max(scale, 1e-30)
    print(f"check {label}{kind} {str(dtype)[6:]} {tuple(args[0].shape)}: max_abs_err "
          f"{err:.3e} rel {err / max(scale, 1e-30):.3e} max|plain| {scale:.3e} tol "
          f"{tol:.3e} ({TOL_REASON[dtype]})")
    if not err <= tol or counter.general_launches != before + 1:
        raise AssertionError(f"{kind} {tuple(args[0].shape)} {dtype}: {err} > {tol}, "
                             f"general launches {before} -> {counter.general_launches}")
    max_err[kind] = max(max_err[kind], err)
    return plain_ms


def _time_general(card, kind, args, plain_ms):
    """The general kernel's ms at ``args`` beside its bound (the larger of
    bytes at 3.35 TB/s and operations at 67 TFLOP/s: fp32 CUDA cores for
    fp32 and bf16 inputs alike) and the plain version's ms."""
    from ocflow_torch.bench import cuda_ms
    from ocflow_torch.kernels import cost_volume as cv_mod

    fn = cv_mod.cost_volume if kind == "cost_volume_general" else cv_mod.cost_volume_backward
    ms = cuda_ms(lambda: fn(*args), 3)
    d = args[-1]
    nbytes, ops = (_cv_cost if kind == "cost_volume_general" else _cv_bwd_cost)(args[0], d)
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = ops / PEAK_FLOPS[torch.float32] * 1e3
    by = "bytes" if b_ms >= o_ms else "operations"
    print(f"time {kind} d={d} {str(args[0].dtype)[6:]} {tuple(args[0].shape)}: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library none, bound {max(b_ms, o_ms):.4f} ms "
          f"({by}; bytes {b_ms:.4f} ms at 3.35 TB/s, operations {o_ms:.4f} ms at 67 TFLOP/s "
          f"fp32), {100 * max(b_ms, o_ms) / ms:.2f}% of bound [{card}]")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(b_ms, o_ms), "bound_by": by}


def _general_d_phase(card, max_err):
    """Phase 14 (a): every d of ``CV_GENERAL_DISPLACEMENTS`` at each shape of
    ``CV_NEW_SHAPES``, fp32 and bf16, forward and backward (a seeded
    cotangent), each call against its plain version and timed beside its
    bound; then a FlowNetC with displacement ``CV_FLOWNETC_D`` (B=8,
    448x1024, fp32, eval, seeded): the launches of its forward and input
    gradient (one general forward, one general backward, nothing else), its
    correlation call (8x256x56x128) replayed forward and backward against
    the plain versions and timed. Returns ``(per_d, path_launches,
    path_records)``."""
    from ocflow_torch.bench import BATCH, HEIGHT, SEED, WIDTH, make_flownetc_inputs
    from ocflow_torch.kernels import cost_volume as cv_mod
    from ocflow_torch.models import FlowNetC
    from ocflow_torch.models import flow_net_s as fns

    kinds = ("cost_volume_general", "cost_volume_bwd_general")
    per_d = {k: {} for k in kinds}
    gen = torch.Generator(device="cuda").manual_seed(14)
    for d in CV_GENERAL_DISPLACEMENTS:
        for k in kinds:
            per_d[k][d] = {"float32": [], "bfloat16": []}
        for shape in CV_NEW_SHAPES:
            f1, f2 = (torch.randn(*shape, device="cuda", generator=gen) for _ in range(2))
            b, _, h, w = shape
            g = torch.randn(b, (2 * d + 1) ** 2, h, w, device="cuda", generator=gen)
            for dtype in (torch.float32, torch.bfloat16):
                a1, a2, ag = f1.to(dtype), f2.to(dtype), g.to(dtype)
                for kind, args in ((kinds[0], (a1, a2, d)), (kinds[1], (a1, a2, ag, d))):
                    plain_ms = _hold_general(kind, args, max_err, f"d={d} ")
                    rec = _time_general(card, kind, args, plain_ms)
                    per_d[kind][d][str(dtype)[6:]].append(
                        [rec["ms"], rec["plain_ms"], rec["bound_ms"], rec["bound_by"]])
            del f1, f2, g
            torch.cuda.empty_cache()

    cls = type("FlowNetC12", (FlowNetC,), {"DISPLACEMENT": CV_FLOWNETC_D})
    model, x = make_flownetc_inputs(BATCH, HEIGHT, WIDTH, "cuda", SEED, cls)
    with torch.no_grad():
        shape = model(x).shape
    cot = torch.randn(shape, device="cuda", generator=gen)

    def grad():
        xg = x.detach().requires_grad_()
        return torch.autograd.grad(model(xg), xg, cot)[0]

    def counted(run):
        cv_mod.cost_volume.general_launches = 0
        cv_mod.cost_volume_backward.general_launches = 0
        counts, out = _count_launches(run)
        counts.update(cost_volume_general=cv_mod.cost_volume.general_launches,
                      cost_volume_bwd_general=cv_mod.cost_volume_backward.general_launches)
        return counts, out

    launches, out = counted(grad)
    expect = {k: 0 for k in launches}
    expect.update(cost_volume=1, cost_volume_bwd=1, cost_volume_general=1,
                  cost_volume_bwd_general=1)
    print(f"main path flownetc_d{CV_FLOWNETC_D} (FlowNetC with displacement "
          f"{CV_FLOWNETC_D}, one fp32 eval forward and input gradient, B={BATCH} "
          f"{HEIGHT}x{WIDTH}) launches: {launches} (expected {expect}); gradient finite "
          f"{bool(torch.isfinite(out).all())}")
    if launches != expect or not torch.isfinite(out).all():
        raise AssertionError(f"flownetc d={CV_FLOWNETC_D} path: {launches}")
    calls = _record([(fns, "cost_volume"), (cv_mod, "cost_volume_backward")], grad)
    fwd_args = next(a for k, a in calls if k == "cost_volume")
    bwd_args = next(a for k, a in calls if k == "cost_volume_backward")
    records = {}
    for kind, args in ((kinds[0], fwd_args), (kinds[1], bwd_args)):
        if tuple(args[0].shape) != (BATCH, 256, HEIGHT // 8, WIDTH // 8):
            raise AssertionError(f"{kind} call {tuple(args[0].shape)}")
        plain_ms = _hold_general(kind, args, max_err, f"flownetc d={CV_FLOWNETC_D} ")
        records[kind] = _time_general(card, kind, args, plain_ms)
    del model, x, out, calls, fwd_args, bwd_args
    torch.cuda.empty_cache()
    return per_d, launches, records


def _pwc_general_step(card, max_err, dev="cuda"):
    """Phase 14 (b): a FlowNetCV built by ``train.__main__.build_net`` for
    ``configs/supervised.yaml`` with ``model: pwc`` and ``displacement:
    PWC_GENERAL_D`` (seeded), one supervised flow train step at B=8
    448x1024, fp32, on SyntheticFlow: its launches (5 general forward, 5
    general backward, no other kernel), each of its 10 cost-volume calls
    replayed against the plain version, the loss finite; then the warm
    step's ms (median of 5, CUDA events) and the general kernels' share of
    it (each call timed alone, summed). Returns the launch counts and the
    numbers."""
    import math

    from ocflow_torch.bench import BATCH, HEIGHT, WIDTH, cuda_ms
    from ocflow_torch.data import DataLoader, build_dataset
    from ocflow_torch.kernels import cost_volume as cv_mod
    from ocflow_torch.models import pwc_net
    from ocflow_torch.train import config as config_lib
    from ocflow_torch.train import create_train_state
    from ocflow_torch.train.__main__ import REGIMES, build_net

    cfg = config_lib.load_config("configs/supervised.yaml")
    cfg.network_type, cfg.model, cfg.displacement = "flow", "pwc", PWC_GENERAL_D
    model = build_net(cfg)
    data = build_dataset("SyntheticFlow", size=BATCH, image_size=(HEIGHT, WIDTH), device=dev)
    batch = {k: v.to(dev) for k, v in next(iter(DataLoader(data, BATCH))).items()}
    train_step, _ = REGIMES["flow"][1]({"model": "pwc", "compute_dtype": "float32"})
    state = create_train_state(model, cfg.learning_rate, device=dev)
    box = {}
    _zero_counts()
    cv_mod.cost_volume.general_launches = cv_mod.cost_volume_backward.general_launches = 0
    calls = _record([(pwc_net, "cost_volume"), (cv_mod, "cost_volume_backward")],
                    lambda: box.update(out=train_step(state, batch)))
    counts = _read_counts()
    counts.update(cost_volume_general=cv_mod.cost_volume.general_launches,
                  cost_volume_bwd_general=cv_mod.cost_volume_backward.general_launches)
    loss = box.pop("out")[1]["loss"].item()
    expect = {k: 0 for k in counts}
    expect.update(cost_volume=5, cost_volume_bwd=5, cost_volume_general=5,
                  cost_volume_bwd_general=5)
    label = f"supervised_pwc_d{PWC_GENERAL_D}"
    print(f"main path {label} (FlowNetCV displacement {PWC_GENERAL_D} as the supervised CLI "
          f"builds it, one fp32 flow train step, B={BATCH} {HEIGHT}x{WIDTH}) launches: "
          f"{counts} (expected {expect}); loss {loss:.6e}")
    if counts != expect or len(calls) != 10 or not math.isfinite(loss):
        raise AssertionError(f"{label}: launches {counts}, {len(calls)} calls, loss {loss}")
    general_ms = 0.0
    for k, (name, args) in enumerate(calls):
        kind = "cost_volume_general" if name == "cost_volume" else "cost_volume_bwd_general"
        if args[-1] != PWC_GENERAL_D:
            raise AssertionError(f"{label} call {k}: d={args[-1]}")
        _hold_general(kind, args, max_err, f"{label} call {k} ")
        fn = cv_mod.cost_volume if name == "cost_volume" else cv_mod.cost_volume_backward
        general_ms += cuda_ms(lambda: fn(*args), 3)  # noqa: B023
    del calls
    train_step(state, batch)
    each = [_timed_once(lambda: train_step(state, batch))[1] for _ in range(5)]
    step_ms = sorted(each)[2]
    print(f"time {label} train step B={BATCH} {HEIGHT}x{WIDTH} fp32: {step_ms:.3f} ms (median "
          f"of 5 warm steps, CUDA events; runs {[round(e, 3) for e in each]}), "
          f"{BATCH * 1e3 / step_ms:.2f} pairs/s; its 10 general-kernel calls timed alone "
          f"{general_ms:.3f} ms, {100 * general_ms / step_ms:.1f}% of the step [{card}]")
    del state, model, batch
    torch.cuda.empty_cache()
    return counts, {"step_ms": step_ms, "general_ms": general_ms,
                    "general_share": general_ms / step_ms}


def _inpaint_step(card, label, factory, model, batch):
    """One train step of ``factory``'s step on ``batch`` (B=8, 448x1024) with
    every counter zeroed and both TF32 flags set before it: its launches
    (none), the TF32 flags read inside it (both off), the loss, the
    BatchNorm statistics moved; then the warm step's ms (median of 5, CUDA
    events) and its kernel time by kind (``torch.profiler``). Returns
    ``(launches, ms, profile)``."""
    import math
    import statistics

    from ocflow_torch.tools.flownetc_profile import profile_fn
    from ocflow_torch.train import create_train_state

    state = create_train_state(model, 1e-4, device="cuda")
    train_step, _ = factory({"loss_type": "pixel-wise"})
    before = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    # both TF32 flags as the net's forward finds them
    seen = []
    hook = model.register_forward_pre_hook(lambda m, a: seen.append(
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)))
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        counts, (_, metrics) = _count_launches(lambda: train_step(state, batch))
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        hook.remove()
    moved = max((model.state_dict()[k] - v).abs().max().item() for k, v in before.items())
    loss = metrics["loss"].item()
    runs = []
    for _ in range(5):
        _, ms = _timed_once(lambda: train_step(state, batch))
        runs.append(ms)
    prof = profile_fn(lambda: train_step(state, batch), 8, 3)
    print(f"main path {label} (one fp32 train step, B=8 448x1024) launches: {counts} "
          f"(none expected: no kernel of this repository); TF32 read inside the step "
          f"(cudnn, matmul): {sorted(set(seen))} (the caller's flags True); loss {loss:.6f}; "
          f"BatchNorm running statistics moved by up to {moved:.3e}")
    print(f"time {label} step B=8 448x1024 fp32: {statistics.median(runs):.3f} ms (median "
          f"of 5, CUDA events; runs {', '.join(f'{r:.2f}' for r in runs)}), "
          f"{8e3 / statistics.median(runs):.2f} pairs/s; profile (3 steps): "
          f"{prof['ms_per_batch']:.3f} ms/step, kernels {prof['kernel_ms_per_batch']:.3f} ms "
          f"(busy {100 * prof['busy_share']:.1f}%), by kind "
          f"{ {k: round(v, 3) for k, v in prof['by_kind'].items()} } [{card}]")
    if any(counts.values()) or seen != [(False, False)] or not math.isfinite(loss) \
            or not moved > 0:
        raise AssertionError(f"{label}: {counts} {seen} {loss} {moved}")
    del state
    return counts, statistics.median(runs), prof


def _inpaint_small_step(label, factory, batch):
    """The step of ``factory`` on the card against the CPU at
    ``INPAINT_SMALL`` from the same seeded weights and batch: in fp32 the
    loss within 1e-5 and the statistics within 1e-5; in fp64 (the same step,
    cuDNN's fp64 convolutions) the gradients within 1e-4 of max|grad| per
    tensor. (In fp32 the net's train-mode BatchNorms over 4 values a channel
    at its 1x2 level carry rounding far: the fp32 gradient gap is printed.)"""
    from ocflow_torch.bench import perturb_batchnorm
    from ocflow_torch.models import InpaintingNet
    from ocflow_torch.train import TrainState

    res = {}
    for dtype in (torch.float32, torch.float64):
        for dev in ("cpu", "cuda"):
            model = InpaintingNet(generator=torch.Generator().manual_seed(2))
            perturb_batchnorm(model, torch.Generator().manual_seed(3))
            model = model.to(dev, dtype)
            state = TrainState(model, torch.optim.Adam(model.parameters(), lr=1e-4))
            train_step, _ = factory({"loss_type": "pixel-wise"})
            _, metrics = train_step(state, {k: v.to(dev, dtype) for k, v in batch.items()})
            res[(dtype, dev)] = (
                metrics["loss"].item(),
                {k: p.grad.detach().cpu().double() for k, p in model.named_parameters()},
                {k: v.cpu().double() for k, v in model.state_dict().items() if "running" in k})
    out = {}
    for dtype in (torch.float32, torch.float64):
        (lc, gc, sc), (lg, gg, sg) = res[(dtype, "cpu")], res[(dtype, "cuda")]
        grad = max(((gg[k] - v).abs().max() / v.abs().max().clamp_min(1e-30)).item()
                   for k, v in gc.items())
        stats = max(((sg[k] - v).abs().max() / v.abs().max()).item() for k, v in sc.items())
        out[str(dtype)[6:]] = {"loss": abs(lg - lc) / abs(lc), "grad": grad, "stats": stats}
    b, h, w = INPAINT_SMALL
    print(f"check {label} card vs CPU at {b}x{h}x{w}, seeded weights: fp32 loss "
          f"{out['float32']['loss']:.3e} (tol {INPAINT_LOSS_REL}) statistics "
          f"{out['float32']['stats']:.3e} (tol {INPAINT_STATS_REL}), gradients "
          f"{out['float32']['grad']:.3e} of max|grad| (printed, not held); fp64 loss "
          f"{out['float64']['loss']:.3e} statistics {out['float64']['stats']:.3e} gradients "
          f"{out['float64']['grad']:.3e} (tol {INPAINT_REL})")
    if not (out["float32"]["loss"] <= INPAINT_LOSS_REL
            and out["float32"]["stats"] <= INPAINT_STATS_REL
            and out["float64"]["loss"] <= INPAINT_LOSS_REL
            and out["float64"]["grad"] <= INPAINT_REL):
        raise AssertionError(f"{label} card vs CPU: {out}")


def _ocflownet_check(card):
    """Phase 14 (e): OCFlowNet (seeded, statistics perturbed) card vs CPU at
    ``INPAINT_SMALL`` (flow and completed frame within 1e-4 of max, the hard
    mask equal wherever the soft value is at least 1e-4 from 0.5), its
    launches (none) and ms per forward at B=8 448x1024."""
    from ocflow_torch.bench import BATCH, HEIGHT, SEED, WIDTH, cuda_ms, perturb_batchnorm
    from ocflow_torch.models import OCFlowNet
    from ocflow_torch.ops import resize_bilinear

    model = OCFlowNet(generator=torch.Generator().manual_seed(SEED))
    perturb_batchnorm(model, torch.Generator().manual_seed(SEED + 1))
    model.eval()
    b, h, w = INPAINT_SMALL
    x = torch.rand((b, h, w, 6), generator=torch.Generator().manual_seed(5)) * 2 - 1
    outs = {}
    for dev in ("cpu", "cuda"):
        m = copy.deepcopy(model).to(dev)
        seen = {}
        hook = m.flow_occ.predict_occ1.register_forward_hook(
            lambda mod, i, o: seen.setdefault("logit", o))  # noqa: B023
        with torch.no_grad():
            out = m(x.to(dev))
        hook.remove()
        soft = torch.sigmoid(10.0 * resize_bilinear(seen["logit"], h, w)).permute(0, 2, 3, 1)
        outs[dev] = [t.cpu() for t in out] + [soft.cpu()]
    (fc, oc, cc, sc), (fg, og, cg, _) = outs["cpu"], outs["cuda"]
    clear = (sc - 0.5).abs() >= 1e-4
    errs = [((g - c).abs().max() / c.abs().max()).item() for g, c in ((fg, fc), (cg, cc))]
    mask_ok = bool(torch.equal(og[clear], oc[clear]))
    model = model.cuda()
    xb = torch.rand((BATCH, HEIGHT, WIDTH, 6), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(6)) * 2 - 1

    def forward():
        with torch.no_grad():
            return model(xb)

    counts, out = _count_launches(forward)
    ms = cuda_ms(forward, 5)
    shapes = [tuple(t.shape) for t in out]
    print(f"main path ocflownet (eval forward, fp32, B={BATCH} {HEIGHT}x{WIDTH}) launches: "
          f"{counts} (none expected); outputs {shapes}; card vs CPU at {b}x{h}x{w}: flow "
          f"{errs[0]:.3e}, completed {errs[1]:.3e} of max (tol {INPAINT_REL}), hard mask "
          f"equal where the soft value is clear of 0.5 ({100 * clear.float().mean():.2f}% "
          f"of pixels): {mask_ok}")
    print(f"time ocflownet forward B={BATCH} {HEIGHT}x{WIDTH} fp32 eval: {ms:.3f} ms "
          f"({BATCH * 1e3 / ms:.2f} pairs/s, CUDA events, mean of 5) [{card}]")
    if any(counts.values()) or max(errs) > INPAINT_REL or not mask_ok \
            or not all(torch.isfinite(t).all() for t in out):
        raise AssertionError(f"ocflownet: {counts} {errs} {mask_ok}")
    return counts, ms


def _synthetic_inpainting_check(card):
    """Phase 14 (b): 8 ``SyntheticInpainting`` samples at 448x1024 made on
    the card against the same samples on the CPU (frames within 1e-4, masks
    and ``occluded`` bit for bit), and the card's ms per sample (wall: the
    texture on the card, the strokes on the host)."""
    from ocflow_torch.data import build_dataset

    kw = dict(size=8, image_size=(448, 1024), occlusion_ratio=0.4, seed=0)
    card_ds = build_dataset("SyntheticInpainting", device="cuda", **kw)
    cpu_ds = build_dataset("SyntheticInpainting", device="cpu", **kw)
    t0 = time.perf_counter()
    got = [card_ds[i] for i in range(8)]
    torch.cuda.synchronize()
    per = (time.perf_counter() - t0) * 1e3 / 8
    img_err, exact, cover = 0.0, True, []
    for i, g in enumerate(got):
        r = cpu_ds[i]
        img_err = max(img_err, (g["image"].cpu() - r["image"]).abs().max().item())
        exact &= bool(torch.equal(g["occ"].cpu(), r["occ"]))
        exact &= bool(torch.equal(g["occluded"].cpu(), torch.where(r["occ"] > 0, 0.0,
                                                                   g["image"].cpu())))
        cover.append(r["occ"].mean().item())
    print(f"data SyntheticInpainting 448x1024 (ratio 0.4), 8 samples: card vs CPU frames "
          f"{img_err:.3e} (tol {INPAINT_SYNTH_TOL}), masks and occluded frames bit for bit: "
          f"{exact}; coverage {min(cover):.3f}-{max(cover):.3f}; {per:.1f} ms per sample on "
          f"the card (wall: texture on the card, strokes on the host) [{card}]")
    if not img_err <= INPAINT_SYNTH_TOL or not exact:
        raise AssertionError(f"SyntheticInpainting card vs CPU: {img_err} {exact}")
    return per


def _inpainting_files_check(trees):
    """Phase 14 (c): the file-backed inpainting datasets on phase 11's trees:
    keys, shapes, each mask binary with its coverage, ``occluded`` zero under
    the mask and the frame elsewhere."""
    import numpy as np

    from ocflow_torch.data import build_dataset

    for name, root, size in (("MpiSintelCleanInpainting", trees["sintel"], (384, 1024)),
                             ("MpiSintelFinalInpainting", trees["sintel"], (384, 1024)),
                             ("FlyingChairsInpainting", trees["chairs2"], (384, 512))):
        t0 = time.perf_counter()
        ds = build_dataset(name, root=root, occlusion_ratio=0.4)
        n = min(len(ds), 10)
        cover, ok = [], len(ds) > 0
        for i in range(n):
            s = ds[i]
            ok &= set(s) == {"occluded", "image", "occ"}
            ok &= s["image"].shape == (*size, 3) and s["occ"].shape == (*size, 1)
            ok &= bool(np.isin(s["occ"], (0.0, 1.0)).all())
            ok &= bool((s["occluded"] == np.where(s["occ"] > 0, 0.0, s["image"])).all())
            cover.append(float(s["occ"].mean()))
        ms = (time.perf_counter() - t0) * 1e3 / n
        print(f"data {name}: {len(ds)} frames, {n} read at {size[0]}x{size[1]}: keys, shapes, "
              f"binary masks and zeroed holes {ok}; coverage {min(cover):.3f}-{max(cover):.3f} "
              f"(free-form strokes up to 0.9 x 0.4 or 100 rounds); {ms:.1f} ms per sample "
              f"(decode, crop, strokes; host)")
        if not ok:
            raise AssertionError(f"{name}: a sample breaks the inpainting contract")


def _inpainting_net_phase(card, trees):
    """Phase 14 (d): InpaintingNet's eval forward (card vs CPU, ms at full
    size), one supervised step on ``MpiSintelFlowOccClean`` resized to
    448x1024 and one stage step on ``SyntheticInpainting``, each held card
    vs CPU at ``INPAINT_SMALL`` and run at full size. Returns launches and
    records."""
    from ocflow_torch.bench import BATCH, HEIGHT, SEED, WIDTH, cuda_ms, perturb_batchnorm
    from ocflow_torch.data import DataLoader, build_dataset
    from ocflow_torch.models import InpaintingNet
    from ocflow_torch.train import make_inpainting_stage_step, make_supervised_inpainting_step

    gen = torch.Generator().manual_seed(SEED)
    model = InpaintingNet(generator=gen)
    perturb_batchnorm(model, gen)
    model.eval()
    b, h, w = INPAINT_SMALL
    imgs = torch.rand((b, h, w, 3), generator=gen) * 2 - 1
    masks = (torch.rand((b, h, w, 1), generator=gen) > 0.6).float()
    with torch.no_grad():
        ref = model(imgs, masks)
        cuda_model = copy.deepcopy(model).cuda()
        got = cuda_model(imgs.cuda(), masks.cuda()).cpu()
    err = ((got - ref).abs().max() / ref.abs().max()).item()
    big = torch.rand((BATCH, HEIGHT, WIDTH, 3), device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(7)) * 2 - 1
    big_m = (torch.rand((BATCH, HEIGHT, WIDTH, 1), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(8)) > 0.6).float()

    def forward():
        with torch.no_grad():
            return cuda_model(big, big_m)

    counts, out = _count_launches(forward)
    fwd_ms = cuda_ms(forward, 5)
    print(f"main path inpainting_forward (eval, fp32, B={BATCH} {HEIGHT}x{WIDTH}) launches: "
          f"{counts} (none expected); card vs CPU at {b}x{h}x{w}: {err:.3e} of max|out| (tol "
          f"{INPAINT_REL}); output {tuple(out.shape)} in [{out.min().item():.3f}, "
          f"{out.max().item():.3f}]")
    print(f"time inpainting_forward B={BATCH} {HEIGHT}x{WIDTH} fp32 eval: {fwd_ms:.3f} ms "
          f"({BATCH * 1e3 / fwd_ms:.2f} pairs/s, CUDA events, mean of 5) [{card}]")
    if any(counts.values()) or not err <= INPAINT_REL or not torch.isfinite(out).all():
        raise AssertionError(f"inpainting forward: {counts} {err}")
    launches = {"inpainting_forward": counts}
    del out, big, big_m, cuda_model
    torch.cuda.empty_cache()

    rng = torch.Generator().manual_seed(9)
    small_sup = {"images": torch.rand((b, h, w, 6), generator=rng) * 2 - 1,
                 "flow": torch.randn((b, h, w, 2), generator=rng) * 3,
                 "occ": (torch.rand((b, h, w, 1), generator=rng) > 0.7).float()}
    small_stage = {"image": small_sup["images"][..., :3], "occ": small_sup["occ"]}
    _inpaint_small_step("supervised_inpainting", make_supervised_inpainting_step, small_sup)
    _inpaint_small_step("stage_inpainting", make_inpainting_stage_step, small_stage)

    sintel = build_dataset("MpiSintelFlowOccClean", root=trees["sintel"],
                           image_size=(HEIGHT, WIDTH))
    sup_batch = {k: v.cuda() for k, v in next(iter(DataLoader(sintel, BATCH))).items()}
    synth = build_dataset("SyntheticInpainting", size=BATCH, image_size=(HEIGHT, WIDTH),
                          occlusion_ratio=0.4, device="cuda")
    stage_batch = next(iter(DataLoader(synth, BATCH, num_workers=0)))
    step_ms, profiles = {}, {}
    for label, factory, batch in (("supervised_inpainting", make_supervised_inpainting_step,
                                   sup_batch),
                                  ("stage_inpainting", make_inpainting_stage_step,
                                   stage_batch)):
        net = InpaintingNet(generator=torch.Generator().manual_seed(SEED))
        launches[label], step_ms[label], profiles[label] = _inpaint_step(
            card, label, factory, net, batch)
        del net
        torch.cuda.empty_cache()
    return launches, fwd_ms, step_ms, profiles


def _inpainting_cli_phase(card, trees):
    """Phase 14 (f): ``python -m ocflow_torch.train`` (``network_type:
    inpainting``, ``model: simple``, ``MpiSintelFlowOccClean`` at 448x1024,
    B=8, 2 epochs; phase 11's tree has 8 pairs, so ``overfit``: train, val
    and test are those 8) as a process of its own: exit 0, the CSV's rows,
    the best checkpoint, its wall time; ``python -m
    ocflow_torch.train_unsupervised`` on ``configs/inpainting_gan_fullres.yaml``
    with ``STAGE_CLI_CUTS`` in this process: finite losses, the CSV's rows,
    the ``inpaint`` panel PNGs decoded with zlib and equal to the panels
    the run drew, its wall time."""
    import csv
    import math
    import os
    import subprocess
    import tempfile

    import numpy as np

    from ocflow_torch import train_unsupervised
    from ocflow_torch.train import config as config_lib
    from ocflow_torch.utils.checkpoint import CheckpointManager

    walls = {}
    with tempfile.TemporaryDirectory() as out:
        def write(name, raw):
            raw = {**raw, **{k: os.path.join(out, name, v) for k, v in (
                ("metrics_csv", "metrics.csv"), ("log_dir", "tb"), ("checkpoint_dir", "ckpt"),
                ("result_dir", "."))}}
            path = os.path.join(out, f"{name}.yaml")
            with open(path, "w") as f:
                f.write("".join(f"{k}: {_yaml_value(v)}\n" for k, v in raw.items()))
            return path, raw

        path, raw = write("sup", {
            "network_type": "inpainting", "model": "simple",
            "dataset_name": "MpiSintelFlowOccClean", "root": trees["sintel"],
            "image_size": [448, 1024], "batch_size": 8, "max_epochs": 2, "overfit": True,
            "num_workers": 6, "log_every_n_steps": 1, "learning_rate": 1e-4, "seed": 0})
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "ocflow_torch.train", "--config", path],
                              capture_output=True, text=True, timeout=600)
        walls["supervised"] = time.perf_counter() - t0
        test_line = [ln for ln in proc.stdout.splitlines() if ln.startswith("test:")]
        rows = []
        if os.path.exists(raw["metrics_csv"]):
            with open(raw["metrics_csv"]) as f:
                rows = list(csv.DictReader(f))
        phases = [r["phase"] for r in rows]
        manager = CheckpointManager(raw["checkpoint_dir"])
        best = manager.best_step
        print(f"inpainting supervised CLI (python -m ocflow_torch.train, MpiSintelFlowOccClean "
              f"448x1024, B=8, 2 epochs, overfit): exit {proc.returncode}, {test_line}, CSV "
              f"{phases.count('train')} train and {phases.count('val')} val rows, best "
              f"checkpoint at epoch {best}; {walls['supervised']:.1f} s wall (the process's "
              f"start and TensorBoard included) [{card}]")
        if proc.returncode != 0 or not test_line or phases != ["train", "val"] * 2 \
                or best is None:
            raise AssertionError(f"inpainting supervised CLI: {proc.returncode} {phases} "
                                 f"{proc.stderr[-2000:]}")

        with open("configs/inpainting_gan_fullres.yaml") as f:
            stage = config_lib.parse_flat_yaml(f.read())
        stage.update(STAGE_CLI_CUTS)
        path, raw = write("stage", stage)
        drawn = []
        saved = train_unsupervised.inpaint_viz_fn

        def spy(state, batch):
            panels = saved(state, batch)
            drawn.append(panels["inpaint"])
            return panels

        train_unsupervised.inpaint_viz_fn = spy
        t0 = time.perf_counter()
        try:
            results = train_unsupervised.main(["--config", path])
        finally:
            train_unsupervised.inpaint_viz_fn = saved
        walls["stage"] = time.perf_counter() - t0
        with open(raw["metrics_csv"]) as f:
            rows = list(csv.DictReader(f))
        phases = [r["phase"] for r in rows]
        losses = [float(r["loss"]) for r in rows]
        pngs = [_png_pixels(os.path.join(out, "stage", f"val_{e}", "inpaint.png"))
                for e in range(raw["max_epochs"])]
        equal = len(pngs) == len(drawn) and all(np.array_equal(p, d)
                                                for p, d in zip(pngs, drawn))
        n_train = int(0.8 * raw["dataset_size"]) // raw["batch_size"]
        print(f"inpainting stage CLI (python -m ocflow_torch.train_unsupervised, "
              f"inpainting_gan_fullres.yaml with {STAGE_CLI_CUTS}, 448x1024): test {results}, "
              f"CSV {phases.count('train')} train and {phases.count('val')} val rows, losses "
              f"finite {all(math.isfinite(v) for v in losses)}; panels {[p.shape for p in pngs]} "
              f"decoded and equal to the drawn ones: {equal}; {walls['stage']:.1f} s wall "
              f"(the data's generation included) [{card}]")
        if phases.count("train") != n_train * raw["max_epochs"] \
                or phases.count("val") != raw["max_epochs"] or not equal \
                or not all(math.isfinite(v) for v in [*losses, *results.values()]):
            raise AssertionError(f"inpainting stage CLI: {phases} {results} {equal}")
    return walls


def _inpainting_eval_phase(card, trees):
    """Phase 14 (g): ``python -m ocflow_torch.evaluate --task inpainting
    --model simple`` on ``SyntheticInpainting`` (448x1024, 24 samples, B=8)
    and on ``MpiSintelCleanInpainting`` (phase 11's tree): PSNR and SSIM
    against the same metrics computed in float64 on the CPU from the same
    completed images (1e-5 relative), SSIM at most 1, pairs/s of the metric
    pass from the second batch on, the command's wall time."""
    import io

    from ocflow_torch import evaluate
    from ocflow_torch.metrics import image_metrics

    out = {}
    for name, extra in (("SyntheticInpainting", ["--dataset_size", "24", "--image_size",
                                                 "448", "1024"]),
                        ("MpiSintelCleanInpainting", ["--root", trees["sintel"]])):
        seen, stamps = [], []
        saved = image_metrics.completed_images

        def recording(fn, batches, device=None):
            for complete, imgs in saved(fn, batches, device):
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())
                if len(seen) < len(batches):
                    seen.append((complete.detach().cpu().double(), imgs.cpu().double()))
                yield complete, imgs

        image_metrics.completed_images = recording
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                counts, results = _count_launches(lambda: evaluate.main(
                    ["--task", "inpainting", "--model", "simple", "--dataset", name,
                     "--batch_size", "8", *extra]))  # noqa: B023
        finally:
            image_metrics.completed_images = saved
        wall = time.perf_counter() - t0
        n = sum(c.shape[0] for c, _ in seen)
        psnr64 = sum(image_metrics.psnr(c, i).item() for c, i in seen) / len(seen)
        ssim64 = sum(image_metrics.ssim(c, i).item() for c, i in seen) / len(seen)
        rel = {"psnr": abs(results["psnr"] - psnr64) / abs(psnr64),
               "ssim": abs(results["ssim"] - ssim64) / abs(ssim64)}
        first_b = seen[0][0].shape[0]
        steady = (n - first_b) / (stamps[len(seen) - 1] - stamps[0]) if len(seen) > 1 else None
        print(f"main path evaluate_inpainting_{name} (--task inpainting --model simple, {n} "
              f"pairs, B=8) launches: {counts} (none expected); {buf.getvalue().strip()}; "
              f"against float64 on the CPU from the same completed images: PSNR "
              f"{psnr64:.6f} ({rel['psnr']:.3e}), SSIM {ssim64:.6f} ({rel['ssim']:.3e}) (tol "
              f"{INPAINT_METRIC_REL}); {wall:.1f} s wall (the data's generation included), "
              f"the metric pass {steady and f'{steady:.2f}'} pairs/s from the second batch on "
              f"[{card}]")
        if any(counts.values()) or max(rel.values()) > INPAINT_METRIC_REL \
                or not results["ssim"] <= 1.0:
            raise AssertionError(f"evaluate inpainting {name}: {counts} {results} {rel}")
        out[name] = {"wall_s": wall, "steady_pairs_per_s": steady, **results}
    return out


def _phase14(card, max_err, trees):
    """Phase 14 (module docstring): the cost volume past d = 10 on the
    general kernels, and the inpainting slice at full width. Returns the
    launch counts by path and the general kernels' records."""
    t0 = time.perf_counter()
    per_d, fnetc_launches, records = _general_d_phase(card, max_err)
    launches = {f"flownetc_d{CV_FLOWNETC_D}": fnetc_launches}
    launches[f"supervised_pwc_d{PWC_GENERAL_D}"], records["pwc_step"] = _pwc_general_step(
        card, max_err)
    synth_ms = _synthetic_inpainting_check(card)
    _inpainting_files_check(trees)
    found, fwd_ms, step_ms, _ = _inpainting_net_phase(card, trees)
    launches.update(found)
    launches["ocflownet"], oc_ms = _ocflownet_check(card)
    walls = _inpainting_cli_phase(card, trees)
    evals = _inpainting_eval_phase(card, trees)
    print(f"inpainting: SyntheticInpainting {synth_ms:.1f} ms per sample, InpaintingNet "
          f"forward {fwd_ms:.3f} ms, steps {step_ms}, OCFlowNet forward {oc_ms:.3f} ms, CLIs "
          f"{ {k: round(v, 1) for k, v in walls.items()} } s, evaluate {evals}; phase 14 took "
          f"{time.perf_counter() - t0:.1f} s wall [{card}]")
    return launches, per_d, records


# phase 15: the gated-conv GAN at the flagship config's width (B=2,
# 448x1024), fp32, TF32 off
GAN_SIZE = (2, 448, 1024)
GAN_TOKENS = (2, 28672)      # the refine branch's 112x256 positions, B=2
GAN_ATT_REL = 1e-4           # blockwise vs dense: max-abs over max|dense|
GAN_REL = 1e-4               # card vs CPU: outputs over max|CPU|, losses relative
# the size of the card-vs-CPU checks (b) and (c): the flagship size when the
# CPU's forward takes under ~30 s there
GAN_CHECK_SIZE = (2, 448, 1024)
# configs/inpainting_gan_fullres.yaml through its CLI: these cuts only (a
# CSV row every step)
# (10 samples: 8 / 1 / 1, 4 steps; cut from 16 samples and 2 epochs to leave
# phase 19 room in the time limit)
GAN_CLI_CUTS = {"dataset_size": 10, "max_epochs": 1, "log_every_n_steps": 1}


def _gan_nets(key, remat=False, seed=1):
    """A seeded generator of ``key`` (``gamma`` 0.5, BatchNorm statistics
    perturbed from the seed) and a seeded discriminator of the same kind, on
    the CPU."""
    from ocflow_torch.bench import perturb_batchnorm
    from ocflow_torch.models import registry

    gen = registry.build("inpainting", key, remat=remat,
                         generator=torch.Generator().manual_seed(seed))
    perturb_batchnorm(gen, torch.Generator().manual_seed(seed + 100))
    with torch.no_grad():
        gen.refine_attn.gamma.fill_(0.5)
    dis = registry.build("discriminator", key, generator=torch.Generator().manual_seed(seed + 1))
    return gen, dis


def _gan_batch(size, seed=2):
    b, h, w = size
    g = torch.Generator().manual_seed(seed)
    return {"image": torch.rand((b, h, w, 3), generator=g) * 2 - 1,
            "occ": (torch.rand((b, h, w, 1), generator=g) > 0.6).float()}


def _attention_range_ms(prof, iters):
    """Device ms a call inside ``ops.attention.RANGE`` (the attention's
    forward and its blockwise backward) in a ``torch.profiler`` trace."""
    from ocflow_torch.ops.attention import RANGE

    total = 0.0
    for e in prof.events():
        if e.name == RANGE and not str(getattr(e, "device_type", "")).endswith("CUDA"):
            total += getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
    return total / 1e3 / iters


def _gan_attention_check(card, dev="cuda"):
    """Phase 15 (a): blockwise against dense attention at ``GAN_TOKENS``,
    d=16, c=128 (the refine branch's q, k and v at 448x1024, B=2): the
    output and the q, k, v gradients of a seeded cotangent within
    ``GAN_ATT_REL`` of max|dense|; each path's forward ms, forward and
    backward ms, and peak memory."""
    from ocflow_torch.bench import cuda_ms
    from ocflow_torch.ops import attention as att

    b, n = GAN_TOKENS
    g = torch.Generator(device=dev).manual_seed(3)
    q, k = (torch.randn((b, n, 16), generator=g, device=dev) for _ in range(2))
    v, cot = (torch.randn((b, n, 128), generator=g, device=dev) for _ in range(2))
    paths = {"dense": att.dense_attention,
             "blockwise": lambda *a: att.blockwise_attention(*a, 1024)}
    res, out = {}, {}
    for name, fn in paths.items():
        def both(fn=fn):
            ts = [t.detach().requires_grad_() for t in (q, k, v)]
            o = fn(*ts)
            return (o.detach(), *torch.autograd.grad(o, ts, cot))

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out[name] = both()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda fn=fn: fn(q, k, v), 5)
        res[name] = {"fwd_ms": fwd_ms, "fwd_bwd_ms": cuda_ms(both, 3), "peak_gib": peak}
    errs = {part: ((bl - de).abs().max() / de.abs().max()).item()
            for part, bl, de in zip(("out", "dq", "dk", "dv"), out["blockwise"], out["dense"])}
    print(f"check gan attention blockwise vs dense, {b}x{n} tokens, d=16, c=128, fp32, TF32 "
          f"(matmul) {torch.backends.cuda.matmul.allow_tf32}: "
          f"{ {k: f'{v:.3e}' for k, v in errs.items()} } of max|dense| (tol {GAN_ATT_REL})")
    for name, r in res.items():
        print(f"time gan attention {name} {b}x{n}: forward {r['fwd_ms']:.3f} ms, forward and "
              f"backward {r['fwd_bwd_ms']:.3f} ms, peak memory {r['peak_gib']:.2f} GiB over "
              f"the inputs [{card}]")
    if max(errs.values()) > GAN_ATT_REL or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError(f"gan attention: {errs}")
    del out
    torch.cuda.empty_cache()
    return res


def _gan_forward_check(card, dev="cuda"):
    """Phase 15 (b): the eval forwards of InpaintSANet (remat off and on)
    and InpaintSANetOrg on the card against the same forward on the CPU at
    ``GAN_CHECK_SIZE`` (coarse and refined within ``GAN_REL`` of max|CPU|;
    remat does nothing without gradients, so one CPU forward serves both),
    the token count the self-attention sees, the launches (none), the card's
    and the CPU's forward times."""
    from ocflow_torch.bench import cuda_ms
    from ocflow_torch.models.gated_conv import SelfAttention

    batch = _gan_batch(GAN_CHECK_SIZE)
    tokens = []
    hook = torch.nn.modules.module.register_module_forward_pre_hook(
        lambda m, a: tokens.append(a[0].shape[2] * a[0].shape[3])
        if isinstance(m, SelfAttention) else None)
    out = {}
    try:  # the hook is global: removed below whatever happens
        for key in ("gated", "gated_org"):
            gen, _ = _gan_nets(key)
            gen.eval()
            t0 = time.perf_counter()
            with torch.no_grad():
                ref = gen(batch["image"], batch["occ"])
            cpu_s = time.perf_counter() - t0
            for remat in ((False, True) if key == "gated" else (False,)):
                card_gen = copy.deepcopy(gen).to(dev)
                for m in card_gen.modules():
                    if hasattr(m, "remat"):
                        m.remat = remat
                x = {k: v.to(dev) for k, v in batch.items()}
                counts, got = _count_launches(lambda: _gen_no_grad(card_gen, x))
                errs = [((g.cpu() - r).abs().max() / r.abs().max()).item()
                        for g, r in zip(got, ref)]
                ms = cuda_ms(lambda: _gen_no_grad(card_gen, x), 3)
                label = f"{key}{' remat' if remat else ''}"
                print(f"check gan forward {label} card vs CPU at "
                      f"{'x'.join(map(str, GAN_CHECK_SIZE))}, seeded, gamma 0.5: coarse "
                      f"{errs[0]:.3e}, refined {errs[1]:.3e} of max|CPU| (tol {GAN_REL}); "
                      f"launches {counts} (none expected); the attention saw {tokens[-1]} "
                      f"tokens; card {ms:.3f} ms, CPU {cpu_s:.1f} s [{card}]")
                if max(errs) > GAN_REL or any(counts.values()):
                    raise AssertionError(f"gan forward {label}: {errs} {counts}")
                out[label] = {"ms": ms, "cpu_s": cpu_s, "tokens": tokens[-1]}
                del card_gen
    finally:
        hook.remove()
    return out


def _gen_no_grad(model, x):
    with torch.no_grad():
        return model(x["image"], x["occ"])


def _gan_step_check(card, dev="cuda"):
    """Phase 15 (c): one GAN step (the projected nets, remat, SGD at 1e-4
    and 4e-4) on the card and on the CPU from the same seeded weights and
    batch at ``GAN_CHECK_SIZE``: ``d_loss`` and ``g_loss`` within
    ``GAN_REL`` relative; the largest per-tensor gradient gap (printed), of
    the tensors whose gradient is not zero (over 1e-4 of the net's
    max|grad|: a bias before a train-mode BatchNorm, or the key conv's,
    has none, and reads fp32 rounding). SGD, not the CLI's Adam: Adam's first step moves a weight by
    about its learning rate whatever its gradient's size, so a zero
    gradient's rounding would move the discriminator that ``g_loss`` reads
    by 4e-4 in another direction on each device."""
    from ocflow_torch.train import TrainState, make_gan_inpainting_step

    batch = _gan_batch(GAN_CHECK_SIZE, seed=4)
    res = {}
    for where in ("cpu", dev):
        gen, dis = _gan_nets("gated", remat=True)
        gen, dis = gen.to(where), dis.to(where)
        states = (TrainState(gen, torch.optim.SGD(gen.parameters(), lr=1e-4)),
                  TrainState(dis, torch.optim.SGD(dis.parameters(), lr=4e-4)))
        t0 = time.perf_counter()
        _, metrics = make_gan_inpainting_step({})(states, {k: v.to(where)
                                                           for k, v in batch.items()})
        grads = {f"{n}.{k}": p.grad.detach().cpu() for n, m in (("G", gen), ("D", dis))
                 for k, p in m.named_parameters()}
        res[where] = ({k: v.item() for k, v in metrics.items()}, grads,
                      time.perf_counter() - t0)
    (mc, gc, cpu_s), (mg, gg, _) = res["cpu"], res[dev]
    rel = {k: abs(mg[k] - v) / abs(v) for k, v in mc.items()}
    scale = {n: max(v.abs().max().item() for k, v in gc.items() if k.startswith(n))
             for n in ("G", "D")}
    gaps = {k: ((gg[k] - v).abs().max() / v.abs().max()).item() for k, v in gc.items()
            if v.abs().max().item() > 1e-4 * scale[k[0]]}
    worst = max(gaps, key=gaps.get)
    print(f"check gan step card vs CPU at {'x'.join(map(str, GAN_CHECK_SIZE))} (projected, "
          f"remat, SGD): metrics relative { {k: f'{v:.3e}' for k, v in rel.items()} } "
          f"(d_loss, g_loss tol {GAN_REL}); largest per-tensor gradient gap {gaps[worst]:.3e} "
          f"of max|grad| ({worst}; printed, not held: the train-mode BatchNorms), median "
          f"{sorted(gaps.values())[len(gaps) // 2]:.3e}, over the {len(gaps)} of {len(gc)} "
          f"tensors whose gradient is not zero; the CPU step {cpu_s:.1f} s [{card}]")
    if rel["d_loss"] > GAN_REL or rel["g_loss"] > GAN_REL:
        raise AssertionError(f"gan step card vs CPU: {rel}")
    return {"metrics_rel": rel, "worst_grad": gaps[worst], "cpu_s": cpu_s}


def _gan_step_timing(card, dev="cuda"):
    """Phase 15 (d, f): the flagship step at ``GAN_SIZE`` on the card with
    remat on (as the config ships) and off: its launches (none), both TF32
    flags read inside every generator and discriminator forward while the
    caller's are on (off), the median of 5 warm steps' ms (CUDA events),
    the peak memory of a step; with remat, a ``torch.profiler`` split of
    two steps into the attention (``ops.attention.RANGE``), convolutions,
    BatchNorm and the rest, and the card's busy share."""
    import statistics

    from ocflow_torch.bench import cuda_ms
    from ocflow_torch.tools.flownetc_profile import profile_fn
    from ocflow_torch.train import create_train_state, make_gan_inpainting_step

    batch = {k: v.to(dev) for k, v in _gan_batch(GAN_SIZE, seed=5).items()}
    out = {}
    for remat in (True, False):
        gen, dis = _gan_nets("gated", remat=remat)
        states = (create_train_state(gen, 1e-4, device=dev),
                  create_train_state(dis, 4e-4, device=dev))
        step = make_gan_inpainting_step({})
        seen = []
        hooks = [m.register_forward_pre_hook(lambda m, a: seen.append(
            (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)))
            for m in (gen, dis)]
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        try:
            step(states, batch)  # warm
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            counts, (_, metrics) = _count_launches(lambda: step(states, batch))
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
        finally:
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
            for h in hooks:
                h.remove()
        runs = [cuda_ms(lambda: step(states, batch), 1) for _ in range(5)]
        ms = statistics.median(runs)
        losses = {k: round(v.item(), 6) for k, v in metrics.items()}
        label = "remat" if remat else "no remat"
        print(f"main path gan_step ({label}, B=2 448x1024 fp32, projected nets, D-then-G) "
              f"launches: {counts} (none expected: no kernel of this repository); TF32 read "
              f"inside the step's {len(seen)} forwards (cudnn, matmul): {sorted(set(seen))} "
              f"(the caller's True); metrics {losses}")
        print(f"time gan_step {label} B=2 448x1024: {ms:.3f} ms (median of 5, CUDA events; "
              f"runs {', '.join(f'{r:.2f}' for r in runs)}), {2e3 / ms:.2f} pairs/s; peak "
              f"memory {peak:.2f} GiB [{card}]")
        if any(counts.values()) or set(seen) != {(False, False)} \
                or not all(math.isfinite(v) for v in losses.values()):
            raise AssertionError(f"gan step {label}: {counts} {seen} {losses}")
        out[label] = {"ms": ms, "peak_gib": peak, "launches": counts}
        if remat:
            from torch.profiler import ProfilerActivity, profile

            prof_all = profile_fn(lambda: step(states, batch), 2, 2)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(2):
                    step(states, batch)
                torch.cuda.synchronize()
            attention = _attention_range_ms(prof, 2)
            kinds = prof_all["by_kind"]  # the attention's kernels: matmul and other
            split = {"attention": attention, "convolutions": kinds.get("conv", 0.0),
                     "batchnorm": kinds.get("batchnorm", 0.0)}
            split["rest"] = prof_all["kernel_ms_per_batch"] - sum(split.values())
            print(f"time gan_step remat where the kernel time goes (torch.profiler, 2 steps): "
                  f"{prof_all['kernel_ms_per_batch']:.3f} ms of kernels per step (busy "
                  f"{100 * prof_all['busy_share']:.1f}%), "
                  f"{ {k: round(v, 3) for k, v in split.items()} } ms; by kind "
                  f"{ {k: round(v, 3) for k, v in kinds.items()} } [{card}]")
            out["split"] = split
            out["busy_share"] = prof_all["busy_share"]
        del states, gen, dis
        torch.cuda.empty_cache()
    return out


def _gan_cli_phase(card, dev="cuda", keep=None):
    """Phase 15 (d, e): ``configs/inpainting_gan_fullres.yaml`` through
    ``python -m ocflow_torch.train_unsupervised`` in a process of its own,
    cut by ``GAN_CLI_CUTS`` (width, batch, remat, learning rates as
    shipped), its outputs in a temporary directory: exit 0, the CSV's rows
    with the GAN metrics, the pair checkpoint, the exported generator,
    finite test metrics, the wall time, the loop's pairs/s and the peak
    memory the CLI prints; then ``python -m ocflow_torch.evaluate --task
    inpainting --model gated`` on the exported generator (SyntheticInpainting
    16 samples at 448x1024, B=2) in this process: launches (none), finite
    PSNR and SSIM <= 1, pairs/s over its wall (the data's generation
    included); ``keep``: a path the exported generator is copied to."""
    import csv
    import io
    import os
    import shutil
    import subprocess
    import tempfile

    from ocflow_torch import evaluate
    from ocflow_torch.train import config as config_lib
    from ocflow_torch.utils.checkpoint import CheckpointManager, load_pytree

    with tempfile.TemporaryDirectory() as tmp:
        with open("configs/inpainting_gan_fullres.yaml") as f:
            raw = config_lib.parse_flat_yaml(f.read())
        raw.update(GAN_CLI_CUTS)
        raw.update({k: os.path.join(tmp, v) for k, v in (
            ("metrics_csv", "metrics.csv"), ("log_dir", "tb"), ("checkpoint_dir", "ckpt"),
            ("result_dir", "."))})
        path = os.path.join(tmp, "gan.yaml")
        with open(path, "w") as f:
            f.write("".join(f"{k}: {_yaml_value(v)}\n" for k, v in raw.items()))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "ocflow_torch.train_unsupervised",
                               "--config", path, "--device", dev], capture_output=True,
                              text=True, timeout=900)
        wall = time.perf_counter() - t0
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(("fit:", "test:",
                                                                          "generator"))]
        rows = []
        if os.path.exists(raw["metrics_csv"]):
            with open(raw["metrics_csv"]) as f:
                rows = list(csv.DictReader(f))
        phases = [r["phase"] for r in rows]
        gan_cols = ("whole_loss", "d_loss", "g_loss", "content_loss")
        finite = all(math.isfinite(float(r[c])) for r in rows if r["phase"] == "train"
                     for c in gan_cols)
        manager = CheckpointManager(raw["checkpoint_dir"])
        pair = manager.restore() if manager.best_step is not None else None
        gen_path = os.path.join(raw["checkpoint_dir"], "generator")
        ips = [float(r["images_per_sec"]) for r in rows if r["phase"] == "train"]
        n_train = int(0.8 * raw["dataset_size"]) // raw["batch_size"]
        print(f"gan CLI (python -m ocflow_torch.train_unsupervised, inpainting_gan_fullres.yaml "
              f"with {GAN_CLI_CUTS}: 448x1024, B=2, remat, D at 4x): exit {proc.returncode}; "
              f"{lines}; CSV {phases.count('train')} train rows with the GAN metrics (finite "
              f"{finite}) and {phases.count('val')} val rows; pair checkpoint at epoch "
              f"{manager.best_step} ({type(pair).__name__} of {len(pair or ())}); generator "
              f"exported {os.path.exists(gen_path)}; the loop's rate at its last step "
              f"{ips[-1] if ips else 0.0:.3f} images/s, "
              f"{raw['batch_size'] * 1e3 / ips[-1] if ips else 0.0:.1f} ms a step (host clock, "
              f"a metrics fetch every step); {wall:.1f} s wall (the process's start, the "
              f"data's generation, TensorBoard included) [{card}]")
        if proc.returncode != 0 or phases.count("train") != n_train * raw["max_epochs"] \
                or phases.count("val") != raw["max_epochs"] or not finite \
                or not isinstance(pair, tuple) or not os.path.exists(gen_path):
            raise AssertionError(f"gan CLI: {proc.returncode} {phases} {proc.stderr[-3000:]}")
        if not any(ln.startswith("test:") for ln in lines) \
                or set(load_pytree(gen_path)) != {"params"}:
            raise AssertionError(f"gan CLI outputs: {lines}")
        if keep:
            shutil.copy(gen_path, keep)

        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            counts, results = _count_launches(lambda: evaluate.main(
                ["--task", "inpainting", "--model", "gated", "--checkpoint", gen_path,
                 "--dataset", "SyntheticInpainting", "--dataset_size", "16", "--image_size",
                 *map(str, GAN_SIZE[1:]), "--batch_size", "2", "--device", dev]))
        ewall = time.perf_counter() - t0
        print(f"main path evaluate_gated (--task inpainting --model gated on the exported "
              f"generator, 16 pairs 448x1024, B=2) launches: {counts} (none expected); "
              f"{buf.getvalue().strip()}; {ewall:.1f} s wall, {16 / ewall:.2f} pairs/s (the "
              f"data's generation included) [{card}]")
        if any(counts.values()) or not all(math.isfinite(v) for v in results.values()) \
                or not results["ssim"] <= 1.0:
            raise AssertionError(f"evaluate gated: {counts} {results}")
    return {"cli_wall_s": wall, "eval_wall_s": ewall, "eval": results}


def _phase15(card, dev="cuda", keep=None):
    """Phase 15 (module docstring): the gated-conv GAN (``keep``: where the
    GAN run's exported generator is copied). Returns the launches of its
    paths (none) and its numbers."""
    t0 = time.perf_counter()
    out = {"attention": _gan_attention_check(card, dev)}
    out["forward"] = _gan_forward_check(card, dev)
    out["step_vs_cpu"] = _gan_step_check(card, dev)
    out["step"] = _gan_step_timing(card, dev)
    out["cli"] = _gan_cli_phase(card, dev, keep)
    print(f"gan: phase 15 took {time.perf_counter() - t0:.1f} s wall [{card}]")
    launches = {"gan_step": out["step"]["remat"]["launches"]}
    return launches, out


# the two-stage pipelines, the joint step, the VGG loss and FID (phase 16)
# configs/two_stage_gc_fullres.yaml through its CLI: these cuts only (every
# step logged, a panel every epoch)
# (12 samples: 9 / 1 / 2, 4 steps an epoch; cut from 24 to leave phase 19
# room in the time limit)
GC_CLI_CUTS = {"dataset_size": 12, "max_epochs": 2, "unfreeze_epoch": 1,
               "log_every_n_steps": 1, "log_image_every_epoch": 1}
GC_SIZE = (2, 448, 1024)      # the GC config's batch and frames
GC_CHECK_SIZE = (2, 64, 128)  # the GC step card vs CPU: the CPU takes seconds there
GC_REL = 1e-4                 # card vs CPU: metrics relative
# BASELINE.json configuration #5: the joint step on KITTI-2015, bf16, B=16
JOINT_SIZE = (16, 320, 1216)
JOINT_VALID = 0.3             # KITTI's sparse ground truth: ~30% of pixels valid
JOINT_LOSS_REL = 1e-5         # fp32 kernel step vs the plain cost volume
JOINT_GRAD_REL = 1e-4         # vs the plain backward on the kernel forward
# the bf16 gradient vs the fp32 one, relative L2, by part: FlowOccNetCV,
# InpaintingNet's last block (up6), the whole InpaintingNet (read 0.061,
# 0.011, 0.407 on the H100; the inpainter's bf16 cotangent grows through its
# train-mode BatchNorms block by block, as in the JAX package)
JOINT_BF16_L2 = {"flow_occ": 0.1, "inpaint.up6": 0.05, "inpaint": 0.5}
# FlowOccNetCV's last occlusion head scaled, a stand-in for trained weights:
# seeded, it puts ~95% of the pixels within 1e-2 of 0.5, where bf16's
# resolution (2^-8) flips the straight-through mask the inpainter reads;
# scaled, ~0.7% (a trained net's occlusion is as clear of the threshold).
# The seeded net's bf16-vs-fp32 reading is printed beside it (read 0.039,
# 0.012, 0.479: the flipped mask moves the inpainter's part).
JOINT_OCC_SCALE = 100.0
UNSUP_TWOSTAGE_CUTS = {"max_epochs": 1}  # cut from 2: phase 19's room in the time limit
FID_CHECK = (8, 128, 256)     # evaluate --with_fid card vs CPU: samples, size
FID_SIZE = (16, 448, 1024)
FID_FEATURE_REL = 1e-4        # Inception features card vs CPU, of max|CPU|
FID_REL = 1e-4                # the FID card vs CPU on the same images, relative


def _gc_pair(key="gated", remat=True, seed=1, perturb=False):
    """``nn.ModuleDict({'occ', 'inpaint'})`` seeded as the CLI seeds it
    (occlusion from 42, inpainter from ``seed``) on the CPU; ``perturb``:
    BatchNorm statistics perturbed, a gated generator's ``gamma`` 0.5."""
    from torch import nn

    from ocflow_torch.bench import perturb_batchnorm
    from ocflow_torch.models import SimpleOcclusionNet, registry

    kwargs = {"remat": remat} if "gated" in key else {}
    inp = registry.build("inpainting", key, generator=torch.Generator().manual_seed(seed),
                         **kwargs)
    pair = nn.ModuleDict({"occ": SimpleOcclusionNet(generator=torch.Generator().manual_seed(42)),
                          "inpaint": inp})
    if perturb:
        perturb_batchnorm(pair, torch.Generator().manual_seed(seed + 100))
        if hasattr(inp, "refine_attn"):
            with torch.no_grad():
                inp.refine_attn.gamma.fill_(0.5)
    return pair


def _gc_batch(size, seed=6):
    b, h, w = size
    g = torch.Generator().manual_seed(seed)
    return {"images": torch.rand((b, h, w, 6), generator=g) * 2 - 1,
            "flow": torch.randn((b, h, w, 2), generator=g) * 3,
            "occ": (torch.rand((b, h, w, 1), generator=g) > 0.7).float()}


def _gc_step_check(card, dev="cuda"):
    """Phase 16 (b): one GC step (gated generator, remat, pixel-wise) on the
    card and on the CPU from the same seeded weights and batch at
    ``GC_CHECK_SIZE``, fp32: every metric within ``GC_REL`` relative, the
    largest per-tensor gradient gap printed (train-mode BatchNorms)."""
    from ocflow_torch.train import TrainState
    from ocflow_torch.train.steps_two_stage import (make_two_stage_gc_optimizer,
                                                    make_two_stage_gc_step)

    batch = _gc_batch(GC_CHECK_SIZE)
    res = {}
    for where in ("cpu", dev):
        pair = _gc_pair(perturb=True).to(where)
        state = TrainState(pair, make_two_stage_gc_optimizer(pair, 1e-4, 1e-5, 0))
        t0 = time.perf_counter()
        _, metrics = make_two_stage_gc_step({"photo_weight": 1.0})[0](state, batch)
        grads = {k: p.grad.detach().cpu() for k, p in pair.named_parameters()}
        res[where] = ({k: v.item() for k, v in metrics.items()}, grads,
                      time.perf_counter() - t0)
    (mc, gc, cpu_s), (mg, gg, _) = res["cpu"], res[dev]
    rel = {k: abs(mg[k] - v) / max(abs(v), 1e-30) for k, v in mc.items()}
    scale = max(v.abs().max().item() for v in gc.values())
    gaps = {k: ((gg[k] - v).abs().max() / v.abs().max()).item() for k, v in gc.items()
            if v.abs().max().item() > 1e-4 * scale}
    worst = max(gaps, key=gaps.get)
    print(f"check gc step card vs CPU at {'x'.join(map(str, GC_CHECK_SIZE))} (occlusion + "
          f"gated, remat, pixel-wise, fp32): metrics relative "
          f"{ {k: f'{v:.3e}' for k, v in rel.items()} } (tol {GC_REL}); largest per-tensor "
          f"gradient gap {gaps[worst]:.3e} of max|grad| ({worst}; printed, not held: the "
          f"train-mode BatchNorms), median {sorted(gaps.values())[len(gaps) // 2]:.3e}; the "
          f"CPU step {cpu_s:.1f} s [{card}]")
    if max(rel.values()) > GC_REL:
        raise AssertionError(f"gc step card vs CPU: {rel}")
    return {"metrics_rel": rel, "worst_grad": gaps[worst]}


def _gc_step_timing(card, dev="cuda"):
    """Phase 16 (b): the GC step at ``GC_SIZE`` on the card (gated, remat, as
    the config ships), ``pixel-wise`` and ``vgg`` (the seeded VGG16): its
    launches (none), both TF32 flags read inside every forward while the
    caller's are on (off), the median of 5 warm steps' ms (CUDA events), the
    peak memory, a ``torch.profiler`` split of two steps into the attention,
    convolutions, BatchNorm and the rest, and the card's busy share."""
    import statistics

    from torch.profiler import ProfilerActivity, profile

    from ocflow_torch.bench import cuda_ms
    from ocflow_torch.losses.perceptual import init_vgg16
    from ocflow_torch.tools.flownetc_profile import profile_fn
    from ocflow_torch.train import TrainState
    from ocflow_torch.train.steps_two_stage import (make_two_stage_gc_optimizer,
                                                    make_two_stage_gc_step)

    batch = {k: v.to(dev) for k, v in _gc_batch(GC_SIZE, seed=7).items()}
    out = {}
    for loss_type in ("pixel-wise", "vgg"):
        pair = _gc_pair().to(dev)
        state = TrainState(pair, make_two_stage_gc_optimizer(pair, 1e-4, 1e-5, 0))
        vgg = init_vgg16(device=dev) if loss_type == "vgg" else None
        step = make_two_stage_gc_step({"loss_type": loss_type, "photo_weight": 1.0}, vgg)[0]
        seen = []
        hooks = [m.register_forward_pre_hook(lambda m, a: seen.append(
            (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)))
            for m in (pair["occ"], pair["inpaint"], *([vgg] if vgg is not None else []))]
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        try:
            step(state, batch)  # warm
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            counts, (_, metrics) = _count_launches(lambda: step(state, batch))
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
        finally:
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
            for h in hooks:
                h.remove()
        runs = [cuda_ms(lambda: step(state, batch), 1) for _ in range(5)]
        ms = statistics.median(runs)
        losses = {k: round(v.item(), 6) for k, v in metrics.items()}
        prof_all = profile_fn(lambda: step(state, batch), 2, 2)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                step(state, batch)
            torch.cuda.synchronize()
        kinds = prof_all["by_kind"]
        split = {"attention": _attention_range_ms(prof, 2),
                 "convolutions": kinds.get("conv", 0.0), "batchnorm": kinds.get("batchnorm", 0.0)}
        split["rest"] = prof_all["kernel_ms_per_batch"] - sum(split.values())
        print(f"main path gc_step_{loss_type} (B=2 448x1024 fp32, occlusion + gated, remat) "
              f"launches: {counts} (none expected: no kernel of this repository); TF32 read "
              f"inside the step's {len(seen)} forwards (cudnn, matmul): {sorted(set(seen))} "
              f"(the caller's True); metrics {losses}")
        print(f"time gc_step {loss_type} B=2 448x1024: {ms:.3f} ms (median of 5, CUDA events; "
              f"runs {', '.join(f'{r:.2f}' for r in runs)}), {2e3 / ms:.2f} pairs/s; peak "
              f"memory {peak:.2f} GiB; kernel time {prof_all['kernel_ms_per_batch']:.3f} ms "
              f"a step (busy {100 * prof_all['busy_share']:.1f}%), "
              f"{ {k: round(v, 3) for k, v in split.items()} } ms; by kind "
              f"{ {k: round(v, 3) for k, v in kinds.items()} } [{card}]")
        if any(counts.values()) or set(seen) != {(False, False)} \
                or not all(math.isfinite(v) for v in losses.values()):
            raise AssertionError(f"gc step {loss_type}: {counts} {seen} {losses}")
        out[loss_type] = {"ms": ms, "peak_gib": peak, "split": split, "launches": counts,
                          "busy_share": prof_all["busy_share"]}
        del state, pair, vgg
        torch.cuda.empty_cache()
    return out


def _gc_cli_phase(card, dev="cuda"):
    """Phase 16 (a): ``configs/two_stage_gc_fullres.yaml`` (SimpleOcclusionNet
    and InpaintSANet with remat, B=2, 448x1024) through ``main`` of
    ``python -m ocflow_torch.train_unsupervised``, cut by ``GC_CLI_CUTS``,
    outputs in a temporary directory; the validation panel's function is
    wrapped to keep the inpainter's weights at the end of each epoch: after
    epoch 0 (gated) they equal the seeded ones bit for bit, after epoch 1
    (unfrozen) they differ. The CSV's rows, the pair checkpoint, finite test
    metrics, the wall time, the loop's ms a step and the peak memory."""
    import csv
    import io
    import os
    import tempfile

    from ocflow_torch import train_unsupervised as tu
    from ocflow_torch.models import registry
    from ocflow_torch.train import config as config_lib
    from ocflow_torch.utils.checkpoint import CheckpointManager

    seeded = {k: v for k, v in registry.build(
        "inpainting", "gated", remat=True, generator=torch.Generator().manual_seed(1)
    ).state_dict().items() if not k.endswith(("running_mean", "running_var", "tracked"))}
    snaps = []
    panel = tu.pipeline_viz_fn

    def keep(state, batch):
        snaps.append({k: v.detach().cpu().clone()
                      for k, v in state.model["inpaint"].state_dict().items() if k in seeded})
        return panel(state, batch)

    with tempfile.TemporaryDirectory() as tmp:
        with open("configs/two_stage_gc_fullres.yaml") as f:
            raw = config_lib.parse_flat_yaml(f.read())
        raw.update(GC_CLI_CUTS)
        raw.update({k: os.path.join(tmp, v) for k, v in (
            ("metrics_csv", "metrics.csv"), ("log_dir", "tb"), ("checkpoint_dir", "ckpt"),
            ("result_dir", "."))})
        path = os.path.join(tmp, "gc.yaml")
        with open(path, "w") as f:
            f.write("".join(f"{k}: {_yaml_value(v)}\n" for k, v in raw.items()))
        buf = io.StringIO()
        tu.pipeline_viz_fn = keep
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                results = tu.main(["--config", path, "--device", dev])
        finally:
            tu.pipeline_viz_fn = panel
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with open(raw["metrics_csv"]) as f:
            rows = list(csv.DictReader(f))
        tree = CheckpointManager(raw["checkpoint_dir"]).restore()
        panels = sorted(os.listdir(tmp))
    phases = [r["phase"] for r in rows]
    steps = phases.count("train") // raw["max_epochs"]
    ips = [float(r["images_per_sec"]) for r in rows if r["phase"] == "train"]
    frozen = len(snaps) == 2 and all(torch.equal(snaps[0][k], v) for k, v in seeded.items())
    moved = len(snaps) == 2 and not all(torch.equal(snaps[1][k], v) for k, v in seeded.items())
    halves = {k.split(".")[0] for k in tree["params"]}
    fit = [ln for ln in buf.getvalue().splitlines() if ln.startswith(("fit:", "test:"))]
    print(f"gc CLI (train_unsupervised main, two_stage_gc_fullres.yaml with {GC_CLI_CUTS}: "
          f"448x1024, B=2, gated + remat, unfreeze at step {steps}): {fit}; CSV "
          f"{phases.count('train')} train rows, {phases.count('val')} val rows; the "
          f"inpainter after epoch 0 equals the seeded one bit for bit: {frozen}, after epoch 1 "
          f"it moved: {moved}; checkpoint halves {sorted(halves)}; panels "
          f"{[p for p in panels if p.startswith('val_')]}; the loop's rate at its last step "
          f"{ips[-1] if ips else 0.0:.3f} images/s, "
          f"{raw['batch_size'] * 1e3 / ips[-1] if ips else 0.0:.1f} ms a step (host clock, a "
          f"metrics fetch every step); peak memory {peak:.2f} GiB; {wall:.1f} s wall (the "
          f"data's generation, panels, TensorBoard included) [{card}]")
    if not (frozen and moved) or halves != {"occ", "inpaint"} or phases.count("val") != 2 \
            or not all(math.isfinite(v) for v in results.values()):
        raise AssertionError(f"gc CLI: {frozen} {moved} {halves} {phases} {results}")
    return {"wall_s": wall, "peak_gib": peak, "ms_per_step": raw["batch_size"] * 1e3 / ips[-1]}


def _joint_batch(dev, seed=8):
    b, h, w = JOINT_SIZE
    g = torch.Generator().manual_seed(seed)
    valid = (torch.rand((b, h, w, 1), generator=g) < JOINT_VALID).float()
    flow = (torch.rand((b, h, w, 2), generator=g) * 40 - 20) * valid
    imgs = torch.rand((b, h, w, 6), generator=g) * 2 - 1
    return {"images": imgs.to(dev), "flow": flow.to(dev), "valid": valid.to(dev)}


def _joint_pair(occ_scale=None):
    """The joint step's seeded pair on the CPU: FlowOccNetCV (its last
    occlusion head scaled by ``JOINT_OCC_SCALE``) and InpaintingNet
    (BatchNorm statistics perturbed)."""
    from torch import nn

    from ocflow_torch.bench import perturb_batchnorm
    from ocflow_torch.models import FlowOccNetCV, InpaintingNet

    inp = InpaintingNet(generator=torch.Generator().manual_seed(1))
    perturb_batchnorm(inp, torch.Generator().manual_seed(101))
    flow_occ = FlowOccNetCV(generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        flow_occ.predict_occ2[0].weight.mul_(JOINT_OCC_SCALE if occ_scale is None else occ_scale)
    return nn.ModuleDict({"flow_occ": flow_occ, "inpaint": inp})


def _bf16_parts(g16, g32):
    """The relative L2 of the bf16 gradient ``g16`` against the fp32 one
    ``g32`` (``{name: tensor}`` of the joint pair) over each part of
    ``JOINT_BF16_L2`` (a prefix of the names)."""
    def rel_l2(prefix):
        keys = [k for k in g32 if k.startswith(prefix + ".")]
        num = sum(((g16[k] - g32[k]) ** 2).sum().item() for k in keys)
        return (num / sum((g32[k] ** 2).sum().item() for k in keys)) ** 0.5

    return {part: rel_l2(part) for part in JOINT_BF16_L2}


def _joint_phase(card, max_err, dev="cuda"):
    """Phase 16 (c): the joint flow + occlusion + inpainting step
    (``train.steps_joint``, FlowOccNetCV + InpaintingNet, seeded) at
    ``JOINT_SIZE`` on a seeded KITTI-like batch (``JOINT_VALID`` of the
    pixels valid). bf16: its launches (5 cost volumes, 5 backward, nothing
    else), every cost-volume call replayed against its plain version (2^-6
    of max|plain|) and timed beside its bound, the master weights fp32.
    fp32, deterministic algorithms: every call replayed (1e-4), the loss and
    metrics against the same step on the plain cost volume
    (``JOINT_LOSS_REL``), the gradients against the same step with the plain
    backward on the kernel forward (``JOINT_GRAD_REL`` of the net's
    max|grad|). The bf16 gradient against the fp32 one, relative L2 by part
    within ``JOINT_BF16_L2``; the same reading on the seeded pair without
    ``JOINT_OCC_SCALE``, printed. Each step's ms (median of 5, default
    algorithms) and peak memory. Returns the bf16 step's launches and the
    per-call times summed."""
    from ocflow_torch.bench import cuda_ms
    from ocflow_torch.kernels import cost_volume as cv_mod
    from ocflow_torch.models import flow_occ_nets as fon
    from ocflow_torch.train import TrainState
    from ocflow_torch.train.steps_joint import make_joint_step

    batch = _joint_batch(dev)
    base = _joint_pair()
    targets = [(fon, "cost_volume"), (cv_mod, "cost_volume_backward")]

    def fresh():
        pair = copy.deepcopy(base).to(dev)
        return TrainState(pair, torch.optim.Adam(pair.parameters(), lr=1e-4))

    def grads_of(state):
        return {k: p.grad.detach().float().clone() for k, p in state.model.named_parameters()}

    out, failures = {}, []
    # bf16: launches, every call replayed, the master weights
    state = fresh()
    step = make_joint_step({"dtype": "bfloat16"})[0]
    box = {}
    _zero_counts()
    calls = _record(targets, lambda: box.update(out=step(state, batch)))
    counts = _read_counts()
    g16, m16 = grads_of(state), {k: v.item() for k, v in box["out"][1].items()}
    fp32_masters = all(p.dtype == torch.float32 for p in state.model.parameters())
    expect = {k: 0 for k in counts}
    expect.update(cost_volume=5, cost_volume_bwd=5)
    print(f"main path joint_step_bf16 (B=16 320x1216, FlowOccNetCV + InpaintingNet, "
          f"dtype bfloat16) launches: {counts} (expected {expect}); master weights fp32: "
          f"{fp32_masters}; metrics { {k: round(v, 6) for k, v in m16.items()} }")
    if counts != expect or len(calls) != 10 or not fp32_masters:
        failures.append(f"joint bf16 launches {counts}, {len(calls)} calls")
    per = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}, {"ms": 0.0, "plain_ms": 0.0,
                                                            "bound_ms": 0.0}
    for k, (name, args) in enumerate(calls):
        kind = "cost_volume" if name == "cost_volume" else "cost_volume_bwd"
        _check_float(kind, args, torch.bfloat16, max_err, f"joint bf16 call {k} ")
        fwd = kind == "cost_volume"
        k_ms = cuda_ms(lambda: (cv_mod.cost_volume if fwd else cv_mod.cost_volume_backward)(
            *args), 10)
        p_ms = cuda_ms(lambda: (cv_mod.cost_volume_plain if fwd
                                else cv_mod.cost_volume_backward_plain)(*args), 2)
        nbytes, ops = (_cv_cost if fwd else _cv_bwd_cost)(args[0], args[-1])
        bound = max(nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[torch.bfloat16]) * 1e3
        p = per[0 if fwd else 1]
        p["ms"] += k_ms
        p["plain_ms"] += p_ms
        p["bound_ms"] += bound
        print(f"time joint {kind} bf16 {tuple(args[0].shape)} d={args[-1]}: kernel "
              f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {bound:.4f} ms "
              f"({100 * bound / k_ms:.2f}% of bound) [{card}]")
    del calls, state
    for name, p in zip(("cost_volume", "cost_volume_bwd"), per):
        print(f"time joint {name} sum over one bf16 step's 5 calls: kernel {p['ms']:.4f} ms, "
              f"plain {p['plain_ms']:.4f} ms, bound {p['bound_ms']:.4f} ms [{card}]")

    # fp32, deterministic: the kernel step, the plain cost volume, the plain
    # backward on the kernel forward
    det = (torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    step32 = make_joint_step({})[0]
    runs = {}
    try:
        for label, fn in (("kernel", None), ("plain", cv_mod.cost_volume_plain),
                          ("plain backward", lambda f1, f2, d: _PlainBackward.apply(
                              f1, f2, d, cv_mod.cost_volume))):
            state = fresh()
            saved = fon.cost_volume
            if fn is not None:
                fon.cost_volume = fn
            try:
                if label == "kernel":
                    box = {}
                    calls = _record(targets, lambda: box.update(out=step32(state, batch)))
                    metrics = box["out"][1]
                else:
                    _, metrics = step32(state, batch)
            finally:
                fon.cost_volume = saved
            runs[label] = ({k: v.item() for k, v in metrics.items()}, grads_of(state))
            del state
    finally:
        torch.backends.cudnn.deterministic = det[0]
        torch.use_deterministic_algorithms(det[1], warn_only=det[2])
    for k, (name, args) in enumerate(calls):
        _check_float("cost_volume" if name == "cost_volume" else "cost_volume_bwd", args,
                     torch.float32, max_err, f"joint fp32 call {k} ")
    del calls
    (m32, g32), (mp, _), (_, gpb) = runs["kernel"], runs["plain"], runs["plain backward"]
    merr = {k: abs(m32[k] - v) / max(abs(v), 1e-30) for k, v in mp.items() if v}
    gerr = {}
    for net in ("flow_occ", "inpaint"):
        scale = max(v.abs().max().item() for k, v in gpb.items() if k.startswith(net))
        gerr[net] = max((g32[k] - v).abs().max().item() for k, v in gpb.items()
                        if k.startswith(net)) / scale
    l2 = _bf16_parts(g16, g32)
    del runs, g16, g32, gpb
    # the seeded pair as drawn (no JOINT_OCC_SCALE): bf16 against fp32, printed
    seeded = {}
    for dtype in ("bfloat16", None):
        pair = _joint_pair(occ_scale=1.0).to(dev)
        make_joint_step({"dtype": dtype})[0](
            TrainState(pair, torch.optim.Adam(pair.parameters(), lr=1e-4)), batch)
        seeded[dtype] = {k: p.grad.detach().float().clone() for k, p in pair.named_parameters()}
        del pair
    l2_seeded = _bf16_parts(seeded["bfloat16"], seeded[None])
    del seeded
    print(f"e2e joint_step fp32: loss {m32['loss']:.6e}, on the plain cost volume "
          f"{mp['loss']:.6e}, metrics relative {_worst(merr)} (tol {JOINT_LOSS_REL}); "
          f"gradients against the plain backward on the kernel forward {gerr} of each net's "
          f"max|grad| (tol {JOINT_GRAD_REL}; deterministic algorithms); the bf16 step's "
          f"gradient against the fp32 one, relative L2 by part "
          f"{ {k: round(v, 4) for k, v in l2.items()} } (tol {JOINT_BF16_L2}); the seeded pair "
          f"without the occlusion head's x{JOINT_OCC_SCALE:g} (printed, not held) "
          f"{ {k: round(v, 4) for k, v in l2_seeded.items()} }; loss {m16['loss']:.6e} "
          f"[{card}]")
    if max(merr.values()) > JOINT_LOSS_REL or max(gerr.values()) > JOINT_GRAD_REL \
            or not all(l2[k] <= tol for k, tol in JOINT_BF16_L2.items()):
        failures.append(f"joint step: metrics {merr}, gradients {gerr}, bf16 l2 {l2}")

    # each step's time and peak memory (PyTorch's default algorithms)
    torch.backends.cudnn.deterministic = False
    torch.use_deterministic_algorithms(False)
    for dtype in ("bfloat16", "float32"):
        state = fresh()
        step = make_joint_step({"dtype": dtype})[0]
        step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs_ms = [cuda_ms(lambda: step(state, batch), 1) for _ in range(5)]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ms = sorted(runs_ms)[2]
        print(f"time joint_step {dtype} B=16 320x1216: {ms:.3f} ms (median of 5, CUDA "
              f"events; runs {', '.join(f'{r:.2f}' for r in runs_ms)}), {16e3 / ms:.2f} "
              f"pairs/s; peak memory {peak:.2f} GiB [{card}]")
        out[dtype] = {"ms": ms, "peak_gib": peak}
        del state
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = det[0]
    torch.use_deterministic_algorithms(det[1], warn_only=det[2])
    if failures:
        raise AssertionError("; ".join(failures))
    out["per_call"] = {"cost_volume": per[0], "cost_volume_bwd": per[1]}
    out["bf16_l2"], out["bf16_l2_seeded"] = l2, l2_seeded
    out["grad_err"], out["metrics_err"] = gerr, merr
    return counts, out


def _unsup_twostage_cli_phase(card, dev="cuda"):
    """Phase 16 (d): ``configs/unsupervised.yaml`` as shipped (TwoStageModelGC:
    the gated generator at 96x128, B=16, SyntheticFlow) and its ``with_gt_flow:
    false`` copy (TwoStageModel: frozen seeded SimpleFlowNet and
    InpaintingNet), each cut by ``UNSUP_TWOSTAGE_CUTS`` through ``python -m
    ocflow_torch.train_unsupervised`` in a process of its own, the two at the
    same time, outputs in a temporary directory: exit 0, the CSV's rows,
    finite test metrics, the wall time."""
    import csv
    import os
    import subprocess
    import tempfile

    from ocflow_torch.train import config as config_lib

    def run(gt):
        with tempfile.TemporaryDirectory() as tmp:
            with open("configs/unsupervised.yaml") as f:
                raw = config_lib.parse_flat_yaml(f.read())
            raw.update(UNSUP_TWOSTAGE_CUTS, with_gt_flow=gt)
            raw.update({k: os.path.join(tmp, v) for k, v in (
                ("metrics_csv", "metrics.csv"), ("log_dir", "tb"), ("checkpoint_dir", "ckpt"),
                ("result_dir", "."))})
            path = os.path.join(tmp, "unsup.yaml")
            with open(path, "w") as f:
                f.write("".join(f"{k}: {_yaml_value(v)}\n" for k, v in raw.items()))
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "ocflow_torch.train_unsupervised",
                                   "--config", path, "--device", dev], capture_output=True,
                                  text=True, timeout=600)
            wall = time.perf_counter() - t0
            rows = []
            if os.path.exists(raw["metrics_csv"]):
                with open(raw["metrics_csv"]) as f:
                    rows = list(csv.DictReader(f))
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(("fit:", "test:"))]
        phases = [r["phase"] for r in rows]
        label = "gc" if gt else "no_gt_flow"
        finite = all(math.isfinite(float(r["loss"])) for r in rows)
        print(f"unsupervised.yaml twostage {label} CLI (a process of its own, with "
              f"{UNSUP_TWOSTAGE_CUTS}: 96x128, B=16): exit {proc.returncode}; {lines}; CSV "
              f"{phases.count('train')} train rows, {phases.count('val')} val rows (finite "
              f"{finite}); {wall:.1f} s wall [{card}]")
        if proc.returncode != 0 or phases.count("val") != raw["max_epochs"] or not finite \
                or not any(ln.startswith("test:") for ln in lines):
            raise AssertionError(f"unsupervised.yaml {label}: {proc.returncode} {phases} "
                                 f"{proc.stderr[-3000:]}")
        return label, wall

    # both processes at the same time (their start-up on the host, mostly)
    with ThreadPoolExecutor(2) as pool:
        return dict(pool.map(run, (True, False)))


def _fid_phase(card, generator, dev="cuda"):
    """Phase 16 (e): ``python -m ocflow_torch.evaluate --task inpainting
    --model gated --checkpoint <phase 15's exported generator> --with_fid
    --allow_random_fid``: on the card and on the CPU on the same
    ``FID_CHECK`` images (the FIDs within ``FID_REL`` relative; the seeded
    InceptionV3's pool features of one batch card vs CPU within
    ``FID_FEATURE_REL`` of max|CPU|); then on the card at ``FID_SIZE`` (launches: none; wall,
    pairs/s) with the Inception's ms a batch of 2 (the resize to 299x299
    included)."""
    import io

    from ocflow_torch import evaluate
    from ocflow_torch.bench import cuda_ms
    from ocflow_torch.metrics import init_inception

    def run(where, n, h, w):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
            counts, results = _count_launches(lambda: evaluate.main(
                ["--task", "inpainting", "--model", "gated", "--checkpoint", generator,
                 "--dataset", "SyntheticInpainting", "--dataset_size", str(n), "--image_size",
                 str(h), str(w), "--batch_size", "2", "--with_fid", "--allow_random_fid",
                 "--device", where]))
        return counts, results, time.perf_counter() - t0

    n, h, w = FID_CHECK
    _, cpu, cpu_s = run("cpu", n, h, w)
    counts, card_res, card_s = run(dev, n, h, w)
    x = torch.rand((2, h, w, 3), generator=torch.Generator().manual_seed(9)) * 2 - 1
    feats = {}
    for where in ("cpu", dev):
        extract = evaluate.inception_features(init_inception(device=where))
        feats[where] = extract(x.to(where)).cpu()
    ferr = ((feats[dev] - feats["cpu"]).abs().max() / feats["cpu"].abs().max()).item()
    gap = abs(card_res["fid"] - cpu["fid"]) / abs(cpu["fid"])
    print(f"check evaluate --with_fid --allow_random_fid (the exported gated generator, "
          f"SyntheticInpainting {n} at {h}x{w}, B=2) card vs CPU: card {card_res}, CPU {cpu} "
          f"(FID relative gap {gap:.3e}, tol {FID_REL}; the seeded network's features are "
          f"~3e-3, its FID ~1e-6); pool features of one batch {ferr:.3e} of max|CPU| (tol "
          f"{FID_FEATURE_REL}); launches {counts} (none expected); wall card {card_s:.1f} s, "
          f"CPU {cpu_s:.1f} s [{card}]")
    if any(counts.values()) or ferr > FID_FEATURE_REL or not gap <= FID_REL:
        raise AssertionError(f"evaluate --with_fid: {counts} {ferr} {card_res}")
    n, h, w = FID_SIZE
    counts, res, wall = run(dev, n, h, w)
    net = evaluate.inception_features(init_inception(device=dev))
    xb = (torch.rand((2, h, w, 3), generator=torch.Generator().manual_seed(10)) * 2 - 1).to(dev)
    inc_ms = cuda_ms(lambda: net(xb), 10)
    print(f"main path evaluate_fid (--task inpainting --model gated --with_fid "
          f"--allow_random_fid, {n} pairs {h}x{w}, B=2) launches: {counts} (none expected); "
          f"{res}; {wall:.1f} s wall, {n / wall:.2f} pairs/s (the data's generation and the "
          f"host's sqrtm of a 2048x2048 product included); InceptionV3 {inc_ms:.3f} ms a "
          f"batch of 2 (the resize to 299x299 included) [{card}]")
    if any(counts.values()) or not math.isfinite(res["fid"]):
        raise AssertionError(f"evaluate --with_fid at {h}x{w}: {counts} {res}")
    return {"fid_card_cpu": (card_res["fid"], cpu["fid"]), "feature_err": ferr,
            "wall_s": wall, "inception_ms": inc_ms}


def _phase16(card, max_err, generator, dev="cuda"):
    """Phase 16 (module docstring): the two-stage pipelines, the joint step,
    the VGG loss and FID. Returns the launches of its paths and its
    numbers."""
    t0 = time.perf_counter()
    out = {"gc_cli": _gc_cli_phase(card, dev)}
    out["gc_check"] = _gc_step_check(card, dev)
    out["gc_step"] = _gc_step_timing(card, dev)
    joint_launches, out["joint"] = _joint_phase(card, max_err, dev)
    out["unsup_cli"] = _unsup_twostage_cli_phase(card, dev)
    out["fid"] = _fid_phase(card, generator, dev)
    print(f"two-stage, joint, VGG, FID: phase 16 took {time.perf_counter() - t0:.1f} s wall "
          f"[{card}]")
    launches = {"joint_step_bf16": joint_launches,
                "gc_step": out["gc_step"]["pixel-wise"]["launches"],
                "gc_step_vgg": out["gc_step"]["vgg"]["launches"]}
    return launches, out


# phase 17: trained weights from the original OCFlow checkpoints, imported
# and served; the user's own frames as JPEG and as interlaced PNG
IMPORT_SEED = 17
IMPORT_GAN_SIZE = (1, 256, 512)  # the imported generator, card vs CPU
IMPORT_GAN_REL = 1e-4            # outputs, max-abs over max|CPU|
JPEG_FRAMES = "tests/data/jpeg_frames.json"  # committed frames, their decode sha256
DECODE_PASSES = 12               # frames decoded per timing pass and thread
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))  # x0, y0, dx, dy


def _adam7_png(img, seed=0) -> bytes:
    """An interlaced (Adam7) 8-bit PNG of ``img`` ``[H, W, C]``: each pass's
    rows filtered with a seeded mix of the five filter types."""
    import struct
    import zlib

    import numpy as np

    from ocflow_torch.utils import png

    rng = np.random.default_rng(seed)
    h, w, c = img.shape
    raw = []
    for x0, y0, dx, dy in ADAM7:
        sub = img[y0::dy, x0::dx]
        if sub.size:
            rows = np.ascontiguousarray(sub).reshape(sub.shape[0], -1)
            raw.append(png.filter_rows(rows, c, rng.integers(0, 5, len(rows))).tobytes())
    header = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 2: 4, 3: 2, 4: 6}[c], 0, 0, 1)
    return (png.PNG_SIGNATURE + png._chunk(b"IHDR", header)
            + png._chunk(b"IDAT", zlib.compress(b"".join(raw))) + png._chunk(b"IEND", b""))


def _torch_spectral_norm(sd, generator):
    """The port's ``SNConv2d`` tensors (``weight``, ``u``, ``sigma``) in
    ``torch.nn.utils.spectral_norm``'s layout (``weight_orig``,
    ``weight_u``, and a unit ``weight_v``), as the original discriminators'
    checkpoints hold them."""
    out = {}
    for k, v in sd.items():
        base = k.rsplit(".", 1)[0]
        if k.endswith(".sigma"):
            continue
        if k.endswith(".u"):
            out[f"{base}.weight_u"] = v.reshape(-1)
        elif k.endswith(".weight") and f"{base}.u" in sd:
            out[f"{base}.weight_orig"] = v
            vec = torch.randn(v[0].numel(), generator=generator)
            out[f"{base}.weight_v"] = vec / vec.norm()
        else:
            out[k] = v
    return out


def _original_checkpoints(src):
    """Seeded checkpoints in the original code's layouts (the port's init
    scale): a Lightning FlowNetCV (``model.``, with the original's dead
    ``deconv2``) and a combined Lightning gated-conv GAN (``generator.`` +
    ``discriminator.``, spectral norms as torch stores them). Returns the
    seeded nets."""
    import os

    from ocflow_torch.models.pwc_net import FlowNetCV

    g = torch.Generator().manual_seed(IMPORT_SEED)
    flow = FlowNetCV(generator=g)
    sd = {f"model.{k}": v for k, v in flow.state_dict().items()}
    sd["model.deconv2.weight"] = torch.randn(2, 2, 4, 4, generator=g) * 0.1
    sd["model.deconv2.bias"] = torch.zeros(2)
    torch.save({"state_dict": sd, "epoch": 41, "hyper_parameters": {"lr": 1e-4}},
               os.path.join(src, "flownetcv_trained.ckpt"))
    gen, dis = _gan_nets("gated", seed=IMPORT_SEED)
    sd = {f"generator.{k}": v for k, v in gen.state_dict().items()}
    sd.update({f"discriminator.{k}": v for k, v in _torch_spectral_norm(
        dis.state_dict(), torch.Generator().manual_seed(IMPORT_SEED + 2)).items()})
    torch.save({"state_dict": sd, "epoch": 7}, os.path.join(src, "inpainting_gan.ckpt"))
    return flow, gen, dis


def _import_check(card, src, out):
    """``python -m ocflow_torch.tools.import_weights`` on ``src`` as a
    process; the manifest checked and the imported tensors held against
    the seeded nets' (the import's two maps are transposes: bit for bit).
    Returns ``{network: port checkpoint}`` and the tool's wall seconds."""
    import hashlib
    import json
    import os
    import subprocess

    from ocflow_torch.utils.checkpoint import load_pytree

    flow, gen, dis = _original_checkpoints(src)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "ocflow_torch.tools.import_weights",
                           "--src", src, "--out", out], capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError(f"import_weights exited {proc.returncode}:\n{proc.stdout}\n"
                             f"{proc.stderr}")
    manifest = json.load(open(os.path.join(out, "manifest.json")))
    got = sorted((e["network"], e["role"], e["family"], e["key"]) for e in manifest)
    want = [("flownetcv", "", "flow", "pwc"),
            ("sa_discriminator", "discriminator", "discriminator", "gated"),
            ("sanet", "generator", "inpainting", "gated")]
    sha = {e["output"]: hashlib.sha256(open(e["output"], "rb").read()).hexdigest() == e[
        "output_sha256"] and hashlib.sha256(open(e["source"], "rb").read()).hexdigest() == e[
        "source_sha256"] for e in manifest}
    ckpt = {e["network"]: e["output"] for e in manifest}
    same = {}
    for name, net in (("flownetcv", flow), ("sanet", gen)):
        imported, ref = load_pytree(ckpt[name])["params"], net.state_dict()
        same[name] = set(imported) == set(ref) and all(
            torch.equal(imported[k], v) for k, v in ref.items() if "num_batches_tracked" not in k)
    imported, ref = load_pytree(ckpt["sa_discriminator"])["params"], dis.state_dict()
    same["sa_discriminator"] = set(imported) == set(ref) and all(
        torch.equal(imported[k], v) if not k.endswith(".sigma") else float(imported[k]) == 1.0
        for k, v in ref.items())
    sizes = {os.path.basename(p): os.path.getsize(p) for p in sorted(
        os.path.join(src, f) for f in os.listdir(src))}
    print(f"import: python -m ocflow_torch.tools.import_weights on {sizes} (B) took {wall:.2f} s "
          f"wall (a process of its own: Python, torch and the port imported; host); manifest "
          f"{got} (expected {want}); sha256 of every source and output as recorded {sha}; "
          f"the imported tensors equal the seeded nets' {same} (spectral norms: sigma 1, "
          f"as flax starts it) [{card}]")
    if got != want or not all(sha.values()) or not all(same.values()):
        raise AssertionError(f"import: manifest {got}, sha {sha}, same {same}")
    return ckpt, wall


def _serve_imported(card, max_err, ckpt, dev="cuda"):
    """The imported FlowNetCV served by ``fast_apply`` at B=8, 448x1024:
    every kernel call of the bf16 and the W8A8 forward replayed against its
    plain version, each path's launches counted, fp32 ``fast_apply``
    against the eager fp32 forward on the plain cost volume, the bf16 and
    W8A8 forwards timed in turns. Returns the launches and the ms."""
    from ocflow_torch.bench import (BATCH, HEIGHT, SEED, WIDTH, calibration_batch,
                                    make_inputs, measure)
    from ocflow_torch.models import load_model, pwc_fast

    model = load_model("flow", "pwc", ckpt, dev)
    _, x32 = make_inputs(BATCH, HEIGHT, WIDTH, torch.float32, dev, SEED)
    model_b, xb = copy.deepcopy(model).bfloat16(), x32.bfloat16()
    serving = [(pwc_fast, n) for n in ("cost_volume", "conv_group", "conv_group_q8")]
    for kind, args in _record(serving, lambda: pwc_fast.fast_apply(model_b, xb)):
        _check_float(kind, args, torch.bfloat16, max_err, "imported ")
    scales = pwc_fast.calibrate_q8(model_b, calibration_batch(xb))
    for kind, args in _record(serving, lambda: pwc_fast.fast_apply(model_b, xb, q8=scales)):
        if kind == "conv_group_q8":
            _check_q8(args, max_err, "imported w8a8 ")
        else:
            _check_float(kind, args, torch.bfloat16, max_err, "imported w8a8 ")
    launches = {}
    for path, q8 in (("imported_bf16", None), ("imported_w8a8", scales)):
        launches[path], _ = _count_launches(
            lambda: pwc_fast.fast_apply(model_b, xb, q8=q8))  # noqa: B023
        want = {"cost_volume": 5, "cost_volume_bwd": 0, "conv_group_diff": 0, "gemm_probe": 0,
                **pwc_fast.prepare(model_b, torch.bfloat16, dev, q8).launch_counts()}
        print(f"main path {path} (the imported FlowNetCV, fast_apply, B={BATCH} "
              f"{HEIGHT}x{WIDTH}) launches: {launches[path]} (expected {want})")
        if launches[path] != want:
            raise AssertionError(f"{path} launch counts {launches[path]}")
    counted = ("cost_volume", "conv_group", "conv_group_staged", "conv_group_q8",
               "conv_group_q8_staged", "conv_group_q8_tma")
    got = [launches[p][k] for p in ("imported_bf16", "imported_w8a8") for k in counted]
    if got != [5, 59, 53, 0, 0, 0, 5, 24, 18, 0, 0, 35]:
        raise AssertionError(f"imported launches {got}, want 5 / 59 / 53 / 0 / 0 / 0 and "
                             f"5 / 24 / 18 / 0 / 0 / 35")
    out_f = pwc_fast.fast_apply(model, x32)
    with torch.no_grad(), _plain_eager_cost_volume():
        ref = model(x32)
    for name, o, r in zip(("full", "quarter"), out_f, ref):
        scale = r.abs().max().item()
        e = (o - r).abs().max().item()
        print(f"e2e imported {name}: fp32 fast_apply vs the eager fp32 forward (plain cost "
              f"volume) max_abs_err {e:.3e} (tol {E2E_FP32_TOL * scale:.3e}, max|eager| "
              f"{scale:.3e})")
        if not (o.shape == r.shape and torch.isfinite(o).all() and e <= E2E_FP32_TOL * scale):
            raise AssertionError(f"imported {name}: fp32 fast_apply vs eager {e}")
    runs = {"bf16": [], "w8a8": []}
    for path in ("bf16", "w8a8", "w8a8", "bf16"):
        runs[path].append(measure(model_b, xb, scales if path == "w8a8" else None)["ms_per_batch"])
    ms = {p: sum(r) / len(r) for p, r in runs.items()}
    for path, each in runs.items():
        print(f"e2e imported {path} fast_apply B={BATCH} {HEIGHT}x{WIDTH}: {ms[path]:.3f} "
              f"ms/batch, {BATCH * 1e3 / ms[path]:.2f} pairs/s (runs {each} ms; phase 7's seeded "
              f"forward runs the same kernels at the same shapes) [{card}]")
    return launches, ms


def _imported_generator_check(card, ckpt, dev="cuda"):
    """The imported InpaintSANet loaded by ``load_model`` on the card and on
    the CPU: one eval forward each at ``IMPORT_GAN_SIZE``."""
    from ocflow_torch.models import load_model

    batch = _gan_batch(IMPORT_GAN_SIZE)
    cpu = load_model("inpainting", "gated", ckpt, "cpu")
    with torch.no_grad():
        ref = cpu(batch["image"], batch["occ"])
    card_gen = load_model("inpainting", "gated", ckpt, dev)
    counts, got = _count_launches(lambda: _gen_no_grad(
        card_gen, {k: v.to(dev) for k, v in batch.items()}))
    errs = [((g.cpu() - r).abs().max() / r.abs().max()).item() for g, r in zip(got, ref)]
    print(f"check imported generator (InpaintSANet from the combined GAN checkpoint) card vs "
          f"CPU at {'x'.join(map(str, IMPORT_GAN_SIZE))}: coarse {errs[0]:.3e}, refined "
          f"{errs[1]:.3e} of max|CPU| (tol {IMPORT_GAN_REL}); launches {counts} (none "
          f"expected) [{card}]")
    if max(errs) > IMPORT_GAN_REL or any(counts.values()):
        raise AssertionError(f"imported generator: {errs} {counts}")


def _jpeg_infer_check(card, tmp, ckpt, dev="cuda", key="frames", label="infer_jpg"):
    """``python -m ocflow_torch.infer --checkpoint <imported> --iext jpg
    --save_flo`` over the committed JPEG frames ``jpeg_frames.json[key]``
    (the baseline frames, or their progressive copies): each frame's decode
    against its recorded sha256 (the JAX package's ``read_gen``), each
    ``.flo`` against the eager fp32 forward of the imported net on the same
    decoded pair, launches per pair. Returns the launches of the first pair
    and the ``.flo`` files."""
    import hashlib
    import json
    import os
    import shutil

    from ocflow_torch import infer
    from ocflow_torch.data import build_dataset, read_flo, read_gen
    from ocflow_torch.models import load_model, pwc_fast

    entries = json.load(open(JPEG_FRAMES))[key]
    frames = os.path.join(tmp, f"{label}_frames")
    os.makedirs(frames)
    decoded = {}
    for e in entries:
        path = shutil.copy(os.path.join(os.path.dirname(JPEG_FRAMES), e["file"]), frames)
        im = read_gen(path)
        decoded[e["file"]] = hashlib.sha256(im.tobytes()).hexdigest() == e["decode_sha256"] \
            and im.shape == (e["height"], e["width"], 3)
    print(f"jpeg frames ({key}): {len(decoded)} committed {entries[0]['height']}x"
          f"{entries[0]['width']} frames decoded by the port to the recorded sha256 of "
          f"the JAX read_gen decode {decoded}")
    if not all(decoded.values()):
        raise AssertionError(f"JPEG decode sha256 {decoded}")
    dst = os.path.join(tmp, label)
    with _Timed(infer, "fast_apply", keep=True) as timed:
        t0 = time.perf_counter()
        paths = infer.main(["--input", frames, "--output", dst, "--iext", "jpg", "--save_flo",
                            "--checkpoint", ckpt])
        wall = time.perf_counter() - t0
    model = load_model("flow", "pwc", ckpt, dev)
    ds = build_dataset("ImagesFromFolder", root=frames, iext="jpg")
    errs = []
    for i in range(len(ds)):
        x = torch.from_numpy(ds[i]["images"])[None].to(dev)
        with torch.no_grad():
            ref = model(x)[0][0].cpu().numpy()
        flo = read_flo(paths[2 * i + 1])
        scale = float(abs(ref).max())
        errs.append(float(abs(flo - ref).max()) / scale if flo.shape == ref.shape else 1.0)
    want = {"cost_volume": 5, "cost_volume_bwd": 0, "conv_group_diff": 0, "gemm_probe": 0,
            **pwc_fast.prepare(model, torch.float32, dev).launch_counts()}
    print(f"main path {label} (python -m ocflow_torch.infer --iext jpg --save_flo "
          f"--checkpoint <imported FlowNetCV>, {len(ds)} pairs of {ds.render_size}) launches per "
          f"pair: {timed.counts} (expected {want} each); each .flo vs the eager fp32 forward "
          f"on the decoded pair {[f'{e:.3e}' for e in errs]} of max|flow| (tol "
          f"{E2E_FP32_TOL}); {len(ds)} pairs in {wall:.2f} s wall (the model's build "
          f"included) [{card}]")
    if len(timed.counts) != len(ds) or any(c != want for c in timed.counts) \
            or len(paths) != 2 * len(ds) or max(errs) > E2E_FP32_TOL:
        raise AssertionError(f"{label}: {timed.counts}, {errs}")
    return timed.counts[0], [paths[2 * i + 1] for i in range(len(ds))]


def _write_pnm(path, img, magic=b"P6", maxval=255):
    """``img`` (uint8 [H, W, 3]) as binary P6 (``maxval`` 65535: each value
    times 257, big-endian) or ASCII P3."""
    import numpy as np

    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"%s\n%d %d\n%d\n" % (magic, w, h, maxval))
        if magic == b"P3":
            f.write(" ".join(map(str, img.ravel().tolist())).encode() + b"\n")
        elif maxval == 65535:
            f.write((img.astype(np.uint32) * 257).astype(">u2").tobytes())
        else:
            f.write(img.tobytes())
    return path


def _frames_check(card, tmp):
    """The frames past baseline JPEG and 8-bit PNM: the committed CMYK frame
    against its recorded sha256; the first frame written here as 16-bit P6
    and as ASCII P3 (maxval 255), each read back bit for bit; a
    FlyingChairs-layout pair of 16-bit P6 frames through ``build_dataset``
    and the port's ``DataLoader``: the fused pair path gives None (C8), and
    the samples equal those the generic path makes of the 8-bit frames bit
    for bit (the 8-bit dataset's fused samples, x * (1 / 127.5) - 1 in one
    pass, are printed beside them). Returns its paths for the timing."""
    import hashlib
    import json
    import os
    import shutil

    import numpy as np

    from ocflow_torch.data import build_dataset, native_io, read_gen
    from ocflow_torch.data.datasets import center_crop, normalize_image
    from ocflow_torch.data.pipeline import DataLoader

    data = os.path.dirname(JPEG_FRAMES)
    e = json.load(open(JPEG_FRAMES))["cmyk_frame"]
    cmyk = shutil.copy(os.path.join(data, e["file"]), tmp)
    im = read_gen(cmyk)
    cmyk_ok = hashlib.sha256(im.tobytes()).hexdigest() == e["decode_sha256"] \
        and im.shape == (e["height"], e["width"], 3)
    frames = [read_gen(os.path.join(data, f"frame_{i:04d}.jpg")) for i in range(2)]
    p16 = _write_pnm(os.path.join(tmp, "f16.ppm"), frames[0], maxval=65535)
    p3 = _write_pnm(os.path.join(tmp, "f_ascii.ppm"), frames[0], b"P3")
    trips = {k: bool(read_gen(p).dtype == np.uint8 and np.array_equal(read_gen(p), frames[0]))
             for k, p in (("p6 16-bit", p16), ("p3 ascii", p3))}
    roots = {}
    for bits in (8, 16):
        roots[bits] = os.path.join(tmp, f"chairs{bits}")
        os.makedirs(roots[bits])
        for k, img in enumerate(frames):
            _write_pnm(os.path.join(roots[bits], f"00000_img{k + 1}.ppm"), img,
                       maxval=65535 if bits == 16 else 255)
        h, w = frames[0].shape[:2]
        with open(os.path.join(roots[bits], "00000_flow.flo"), "wb") as f:
            f.write(np.array([202021.25], np.float32).tobytes()
                    + np.array([w, h], np.int32).tobytes() + np.zeros((h, w, 2), np.float32).tobytes())
    samples = {}
    for bits, root in roots.items():
        ds = build_dataset("FlyingChairs", root=root)
        samples[bits] = next(iter(DataLoader(ds, 1, num_workers=2, drop_last=False)))
    th, tw = ds.render_size
    fused = {bits: native_io.read_pair_norm(os.path.join(roots[bits], "00000_img1.ppm"),
                                            os.path.join(roots[bits], "00000_img2.ppm"), th, tw)
             for bits in roots}
    generic = np.concatenate([normalize_image(center_crop(f, th, tw)) for f in frames], -1)
    got = samples[16]["images"][0].numpy()
    chairs_ok = fused[16] is None and fused[8] is not None and np.array_equal(got, generic) \
        and np.array_equal(samples[16]["flow"], samples[8]["flow"])
    gap = float(np.abs(samples[8]["images"][0].numpy() - generic).max())
    print(f"frames: committed CMYK frame decoded to its recorded sha256 {cmyk_ok}; 16-bit P6 "
          f"and ASCII P3 of the first frame read back bit for bit {trips}; FlyingChairs "
          f"layout on 16-bit P6 through build_dataset and DataLoader ({th}x{tw}): fused pair "
          f"path None {fused[16] is None} (8-bit: an array {fused[8] is not None}), samples "
          f"equal to the generic path's of the 8-bit frames bit for bit {chairs_ok} (the 8-bit "
          f"fused samples {gap:.3e} from them) [{card}]")
    if not (cmyk_ok and all(trips.values()) and chairs_ok):
        raise AssertionError(f"frames: cmyk {cmyk_ok} {trips} chairs {chairs_ok}")
    return {"cmyk jpeg": cmyk, "p6 16-bit": p16, "p3 ascii": p3}


def _decode_timing(card, tmp, more=None):
    """Host decode of one 436x1024 frame as JPEG (the first committed frame),
    as an interlaced PNG of the same pixels (this file's writer) and as a
    plain PNG (the port's writer, phase 11's format), and of the frames in
    ``more`` (kind -> path: the progressive copy, the CMYK frame, 16-bit and
    ASCII PNM): ms per frame on one thread and on the loader's 6; the PNGs
    read back bit for bit. Returns the ms and each kind's wall seconds."""
    import os
    import shutil

    from ocflow_torch.data import native_io, read_gen
    from ocflow_torch.utils.png import encode_png

    jpg = shutil.copy(os.path.join(os.path.dirname(JPEG_FRAMES), "frame_0000.jpg"), tmp)
    img = read_gen(jpg)
    paths = {"jpeg": jpg, "adam7 png": os.path.join(tmp, "a7.png"),
             "png": os.path.join(tmp, "plain.png")}
    with open(paths["adam7 png"], "wb") as f:
        f.write(_adam7_png(img))
    with open(paths["png"], "wb") as f:
        f.write(encode_png(img, 4))
    exact = {k: bool((native_io.read_image(p) == img).all()) for k, p in paths.items()
             if k != "jpeg"}
    paths.update(more or {})
    ms, walls = {}, {}
    with ThreadPoolExecutor(6) as pool:
        for kind, path in paths.items():
            t_kind = time.perf_counter()
            native_io.read_image(path)
            t0 = time.perf_counter()
            for _ in range(DECODE_PASSES):
                native_io.read_image(path)
            one = (time.perf_counter() - t0) * 1e3 / DECODE_PASSES
            list(pool.map(native_io.read_image, [path] * 6))
            t0 = time.perf_counter()
            list(pool.map(native_io.read_image, [path] * (6 * DECODE_PASSES)))
            six = (time.perf_counter() - t0) * 1e3 / (6 * DECODE_PASSES)
            ms[kind] = (one, six)
            walls[kind] = time.perf_counter() - t_kind
    sizes = {k: os.path.getsize(p) for k, p in paths.items()}
    print(f"decode {img.shape[0]}x{img.shape[1]} frame (host clock, {os.cpu_count()} CPUs): "
          + "; ".join(f"{k} ({sizes[k]} B) {a:.2f} ms on one thread, {b:.2f} ms per frame on 6"
                      for k, (a, b) in ms.items())
          + f"; the PNGs read back bit for bit {exact} [{card}]")
    if not all(exact.values()):
        raise AssertionError(f"decode round trip {exact}")
    return ms, walls


def _phase17(card, max_err, dev="cuda"):
    """Phase 17 (module docstring): original checkpoints imported and
    served, JPEG (baseline, progressive, CMYK), interlaced PNG and PNM
    frames. Returns the launches of its paths and its numbers."""
    import os
    import shutil
    import tempfile

    from ocflow_torch.data import read_flo

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        src, out = os.path.join(tmp, "original"), os.path.join(tmp, "imported")
        os.makedirs(src)
        ckpt, import_s = _import_check(card, src, out)
        launches, ms = _serve_imported(card, max_err, ckpt["flownetcv"], dev)
        _imported_generator_check(card, ckpt["sanet"], dev)
        launches["infer_jpg"], base_flo = _jpeg_infer_check(card, tmp, ckpt["flownetcv"], dev)
        t1 = time.perf_counter()
        launches["infer_jpg_progressive"], prog_flo = _jpeg_infer_check(
            card, tmp, ckpt["flownetcv"], dev, "progressive_frames", "infer_jpg_progressive")
        flo_gap = max(float(abs(read_flo(a) - read_flo(b)).max())
                      for a, b in zip(base_flo, prog_flo))
        print(f"infer_jpg_progressive vs infer_jpg: the .flo files differ by {flo_gap:.3e} at "
              f"most (0 expected: the progressive frames decode to the same pixels) [{card}]")
        more = _frames_check(card, tmp)
        more["progressive jpeg"] = shutil.copy(
            os.path.join(os.path.dirname(JPEG_FRAMES), "frame_prog_0000.jpg"), tmp)
        checks = time.perf_counter() - t1
        decode, walls = _decode_timing(card, tmp, more)
        timing = sum(walls[k] for k in more)
    print(f"import and frames: phase 17 took {time.perf_counter() - t0:.1f} s wall, of which "
          f"{checks + timing:.1f} s for the progressive, CMYK and PNM frames: the progressive "
          f"infer run and the checks {checks:.1f} s, their decode timing {timing:.1f} s "
          f"[{card}]")
    return launches, {"import_s": import_s, "ms": ms, "decode_ms": decode, "flo_gap": flo_gap}


# phase 18: data parallelism over two gloo ranks that share cuda:0
DP_WORLD = 2
# the sharded fp32 step against its single-process oracle (the forward per
# block, the losses on the whole batch), both under deterministic algorithms:
# metrics relative (and 1e-12 absolute: smooth2 is weighted 0 and near 0),
# gradients max-abs over each tensor's max|grad|
DP_METRIC_REL, DP_METRIC_ABS, DP_GRAD_REL = 1e-5, 1e-12, 1e-4
# the H-sharded cost volume, (d, [B, C, H, W]), forward and backward against
# the single-device kernel, relative to max|single|
DP_SPATIAL = ((4, (8, 32, 112, 256)), (10, (8, 256, 56, 128)))
DP_SPATIAL_REL = 1e-4
# the torchrun CLI: configs/longrun_synthetic.yaml with these (20 samples:
# 16 / 2 / 2, 2 steps of 8, each logged; outputs in a temporary directory;
# cut from 44 samples to leave phase 19 room in the time limit)
DP_CLI_CUTS = {"dataset_size": 20, "max_epochs": 1, "log_every_n_steps": 1,
               "log_image_every_epoch": 1}
DP_TIMED_STEPS = 5


def _dp_collectives(mesh, dev):
    """The collectives the port uses, on ``dev`` tensors under gloo:
    all_reduce and broadcast as they are, all_gather and the halo's
    point-to-point exchange through the host. Returns each one's result."""
    r = mesh.rank
    summed = mesh.all_reduce(torch.tensor([r + 1.0], device=dev)).tolist()
    sent = mesh.broadcast(torch.tensor([r + 5.0], device=dev)).tolist()
    gathered = mesh.all_gather(torch.tensor([[float(r)]], device=dev)).flatten().tolist()
    prev, nxt = mesh.exchange(torch.tensor([100.0 + r], device=dev),
                              torch.tensor([200.0 + r], device=dev))
    want_prev = 0.0 if r == 0 else 199.0 + r
    want_next = 0.0 if r == mesh.size - 1 else 101.0 + r
    ok = (summed == [3.0] and sent == [5.0] and gathered == [0.0, 1.0]
          and prev.tolist() == [want_prev] and nxt.tolist() == [want_next]
          and prev.device == nxt.device == torch.device(dev))
    return {"all_reduce": summed, "broadcast": sent, "all_gather_staged": gathered,
            "exchange_staged": [prev.item(), nxt.item()], "ok": ok}


def _dp_probe_all_gather(mesh, dev):
    """gloo's own all_gather on ``dev`` tensors (the port stages it through
    the host): what it gives, or the error it raises."""
    import torch.distributed as dist

    src = torch.tensor([float(mesh.rank)], device=dev)
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    try:
        dist.all_gather(parts, src)
    except (RuntimeError, ValueError) as e:
        return f"raises: {str(e).splitlines()[0][:200]}"
    return f"works: {[p.item() for p in parts]}"


def _dp_serving(mesh, dev, failures):
    """bf16 and W8A8 ``fast_apply_sharded`` at B=8 448x1024 (a block of 4 a
    rank): each path's launches (zeroed just before, read just after), this
    rank's block against the single-process ``fast_apply`` on it, and the
    gathered batch against the blocks' forwards put together."""
    from ocflow_torch import parallel
    from ocflow_torch.bench import (BATCH, HEIGHT, SEED, WIDTH, calibration_batch,
                                    make_inputs)
    from ocflow_torch.models import pwc_fast

    model, x32 = make_inputs(BATCH, HEIGHT, WIDTH, torch.float32, dev, SEED)
    model_b = copy.deepcopy(model).bfloat16().eval()
    xb = x32.bfloat16()
    del model, x32
    parallel.replicated(model_b, mesh)
    scales = pwc_fast.calibrate_q8(model_b, calibration_batch(xb), device=dev)
    blocks = [parallel.batch_sharding(parallel.Mesh(r, mesh.size), BATCH)
              for r in range(mesh.size)]
    out = {}
    for path, q8 in (("bf16", None), ("w8a8", scales)):
        kw = {"q8": q8, "device": dev}
        pwc_fast.fast_apply_sharded(model_b, xb, mesh, **kw)  # packs the weights
        counts, mine = _count_launches(
            lambda: pwc_fast.fast_apply_sharded(model_b, xb, mesh, **kw))  # noqa: B023
        gathered = pwc_fast.fast_apply_sharded(model_b, xb, mesh, gather=True, **kw)
        refs = [pwc_fast.fast_apply(model_b, xb[s], **kw) for s in blocks]
        whole = [torch.cat(t) for t in zip(*refs)]
        diff_block = max((m - r).abs().max().item() for m, r in zip(mine, refs[mesh.rank]))
        diff_gathered = max((g - w).abs().max().item() for g, w in zip(gathered, whole))
        scale = max(w.abs().max().item() for w in whole)
        tol = KERNEL_TOL[torch.bfloat16] * scale
        want = {"cost_volume": 5, "cost_volume_bwd": 0, "conv_group_diff": 0,
                **pwc_fast.prepare(model_b, torch.bfloat16, dev, q8).launch_counts(),
                "gemm_probe": 0}
        got = {k: counts[k] for k in want}
        out[path] = {"launches": counts, "expected": want, "diff_block": diff_block,
                     "diff_gathered": diff_gathered, "max_abs": scale, "tol": tol,
                     "bitwise": diff_block == 0.0 and diff_gathered == 0.0}
        if got != want or not max(diff_block, diff_gathered) <= tol:
            failures.append(f"serving {path}: launches {got} (want {want}), block diff "
                            f"{diff_block}, gathered diff {diff_gathered}, tol {tol}")
    return out


def _dp_train(mesh, dev, failures, max_err):
    """The training step over the ranks (``longrun_synthetic.yaml`` hparams,
    seeded FlowNetCV, B=8 448x1024, a block of 4 a rank): the fp32 step
    against its single-process oracle under deterministic algorithms (rank
    0 runs the oracle), every kernel call of one fp32 step (rank 0) and of
    one bf16 step (rank 1) replayed against its plain version, one bf16
    step's launches, three bf16 Adam steps and the replicas' checksums, the
    single-process B=8 step (rank 0 alone) and the sharded step timed."""
    import os

    import torch.distributed as dist

    from ocflow_torch import parallel
    from ocflow_torch.bench import (BATCH, HEIGHT, SEED, WIDTH, make_train_inputs,
                                    measure_train, train_hparams)
    from ocflow_torch.kernels import cost_volume as cv_mod
    from ocflow_torch.models import pwc_fast
    from ocflow_torch.train import create_train_state, make_unsupervised_flow_step

    hp_b = train_hparams()
    hp_f = {**hp_b, "compute_dtype": "float32"}
    state0, _, batch = make_train_inputs(BATCH, HEIGHT, WIDTH, dev, SEED, hp_b)
    model0, lr = state0.model, hp_b["learning_rate"]
    del state0
    block = parallel.shard_batch(batch, mesh)
    alone = parallel.Mesh(0, 1)
    targets = [(pwc_fast, "cost_volume"), (pwc_fast, "conv_group"),
               (pwc_fast, "conv_group_diff"), (cv_mod, "cost_volume_backward")]
    names = {"cost_volume_backward": "cost_volume_bwd"}
    out = {}

    def fresh(hp, **extra):
        state = create_train_state(copy.deepcopy(model0), lr, device=dev)
        return state, make_unsupervised_flow_step({**hp, **extra})[0]

    # 1. fp32: the sharded step against the oracle, deterministic
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        state, step = fresh(hp_f, _fast_mesh=mesh)
        box = {}
        calls = _record(targets, lambda: box.update(m=step(state, block)[1]))
        metrics = {k: float(v) for k, v in box["m"].items()}
        grads = {n: p.grad.detach().clone() for n, p in state.model.named_parameters()}
        del state
        if mesh.rank == 0:
            ostate, ostep = fresh(hp_f, _blocks=mesh.size, _fast_mesh=alone)
            want = {k: float(v) for k, v in ostep(ostate, batch)[1].items()}
            metric_err = {k: abs(metrics[k] - v) / max(abs(v), 1e-30) for k, v in want.items()}
            metric_ok = all(abs(metrics[k] - v) <= DP_METRIC_REL * abs(v) + DP_METRIC_ABS
                            for k, v in want.items())
            grad_err = {n: ((grads[n] - p.grad).abs().max()
                            / p.grad.abs().max().clamp_min(1e-30)).item()
                        for n, p in ostate.model.named_parameters()}
            worst = max(grad_err, key=grad_err.get)
            out["oracle"] = {"metrics": metrics, "oracle_metrics": want,
                             "metric_rel": metric_err, "grad_worst": worst,
                             "grad_max_rel": grad_err[worst],
                             "grad_median_rel": sorted(grad_err.values())[len(grad_err) // 2]}
            if set(metrics) != set(want) or not metric_ok:
                failures.append(f"dp train fp32 vs oracle: metrics {metric_err}")
            if grad_err[worst] > DP_GRAD_REL:
                failures.append(f"dp train fp32 vs oracle: gradient {worst} "
                                f"{grad_err[worst]:.3e} of max|grad|")
            del ostate
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    if mesh.rank == 0:
        for kind, args in calls:
            _check_float(names.get(kind, kind), args, torch.float32, max_err,
                         "dp train rank 0 ")
        out["replayed_fp32"] = len(calls)
    del calls, grads
    torch.cuda.empty_cache()

    # 2. bf16: one step's kernel calls (rank 1 replays them), the next
    # step's launches
    state, step = fresh(hp_b, _fast_mesh=mesh)
    calls = _record(targets, lambda: step(state, block))
    if mesh.rank == 1:
        for kind, args in calls:
            _check_float(names.get(kind, kind), args, torch.bfloat16, max_err,
                         "dp train rank 1 ")
        out["replayed_bf16"] = len(calls)
    del calls
    counts, _ = _count_launches(lambda: step(state, block), bwd=True)
    want = {"cost_volume": 10, "cost_volume_bwd": 5, "conv_group": 72, "conv_group_staged": 72,
            "conv_group_diff": 31, "conv_group_q8": 0, **BWD_STEP_LAUNCHES}
    out["launches"] = counts
    if {k: counts[k] for k in want} != want:
        failures.append(f"dp train bf16 launches {counts}, want {want}")
    del state

    # 3. three bf16 Adam steps from the seed: the replicas stay equal
    state, step = fresh(hp_b, _fast_mesh=mesh)
    losses = [float(step(state, block)[1]["loss"]) for _ in range(3)]
    checksum = sum(p.detach().double().sum().item() for p in state.model.parameters())
    try:
        parallel.check_replicated(state.model, mesh)
        equal = True
    except RuntimeError:
        equal = False
        failures.append("dp train: the ranks' parameters differ after 3 Adam steps")
    out["adam"] = {"losses": losses, "checksum": checksum, "replicas_equal": equal}

    # 4. timing, bf16: the single-process B=8 step (rank 0 alone), then the
    # sharded step on both ranks at once
    dist.barrier()
    if mesh.rank == 0:
        single, single_step = fresh(hp_b, _fast_mesh=alone)
        out["single_b8_ms"] = measure_train(single, single_step, batch)["ms_per_step"]
        del single
        torch.cuda.empty_cache()
    dist.barrier()
    for _ in range(2):
        step(state, block)
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(DP_TIMED_STEPS):
        step(state, block)
    torch.cuda.synchronize()
    out["rank_step_ms"] = (time.perf_counter() - t0) * 1e3 / DP_TIMED_STEPS
    dist.barrier()
    return out


def _dp_spatial(mesh, dev, failures):
    """``spatial_cost_volume`` at ``DP_SPATIAL``, fp32, forward and backward
    for a seeded cotangent: its launches (1 forward, 1 backward), this
    rank's rows against the single-device kernel's."""
    from ocflow_torch import parallel
    from ocflow_torch.kernels import cost_volume as cv_mod

    out = {}
    for d, (b, c, h, w) in DP_SPATIAL:
        gen = torch.Generator().manual_seed(d)
        f1, f2 = (torch.randn((b, c, h, w), generator=gen).to(dev) for _ in range(2))
        g = torch.randn((b, (2 * d + 1) ** 2, h, w), generator=gen).to(dev)
        rows = parallel.batch_sharding(parallel.Mesh(mesh.rank, mesh.size), h)
        a = f1[:, :, rows].clone().requires_grad_()
        bb = f2[:, :, rows].clone().requires_grad_()

        def run():
            o = parallel.spatial_cost_volume(a, bb, d, mesh)  # noqa: B023
            (o * g[:, :, rows]).sum().backward()  # noqa: B023
            return o.detach()

        counts, mine = _count_launches(run)
        fa, fb = f1.requires_grad_(), f2.requires_grad_()
        ref = cv_mod.cost_volume(fa, fb, d)
        (ref * g).sum().backward()
        ref = ref.detach()[:, :, rows]
        errs = {"forward": ((mine - ref).abs().max() / ref.abs().max()).item(),
                "df1": ((a.grad - fa.grad[:, :, rows]).abs().max()
                        / fa.grad.abs().max()).item(),
                "df2": ((bb.grad - fb.grad[:, :, rows]).abs().max()
                        / fb.grad.abs().max()).item()}
        bitwise = {"forward": torch.equal(mine, ref),
                   "df1": torch.equal(a.grad, fa.grad[:, :, rows]),
                   "df2": torch.equal(bb.grad, fb.grad[:, :, rows])}
        launches = {k: counts[k] for k in ("cost_volume", "cost_volume_bwd")}
        out[f"d{d}"] = {"shape": [b, c, h, w], "rows": [rows.start, rows.stop],
                        "rel": errs, "bitwise": bitwise, "launches": counts}
        if launches != {"cost_volume": 1, "cost_volume_bwd": 1} \
                or max(errs.values()) > DP_SPATIAL_REL:
            failures.append(f"dp spatial d={d}: {errs}, launches {launches}")
        del f1, f2, g, a, bb, fa, fb, ref, mine
        torch.cuda.empty_cache()
    return out


def _dp_rank(rank, nproc, store, out_dir, dev="cuda", phases=(18, 19)):
    """One rank of phases 18 and 19: joins the gloo group on ``dev`` (every
    rank on cuda:0), runs phase 18's collectives, serving, training and
    spatial checks, then phase 19's steps (:func:`_gs_rank`), each of the
    ``phases`` asked for, and writes its readings (failures included: a
    rank does not raise between collectives, so the other does not wait on
    it) to ``out_dir/rank<r>.json``."""
    import datetime

    import torch.distributed as dist

    from ocflow_torch import parallel

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    parallel.initialize(store, nproc, rank, backend="gloo", device=dev,
                        timeout=datetime.timedelta(seconds=600))
    try:
        device = parallel.local_device(dev)
        mesh = parallel.make_mesh(device=device)
        failures, max_err = [], {k: 0.0 for k in ("cost_volume", "cost_volume_bwd",
                                                   "conv_group", "conv_group_diff")}
        t0 = time.perf_counter()
        res = {"rank": rank, "device": str(device)}
        if 18 in phases:
            res["collectives"] = _dp_collectives(mesh, device)
            if not res["collectives"]["ok"]:
                failures.append(f"collectives {res['collectives']}")
            res["serving"] = _dp_serving(mesh, device, failures)
            torch.cuda.empty_cache()
            res["train"] = _dp_train(mesh, device, failures, max_err)
            torch.cuda.empty_cache()
            res["spatial"] = _dp_spatial(mesh, device, failures)
            res["collectives"]["gloo_all_gather_direct"] = _dp_probe_all_gather(mesh, device)
        res["seconds"] = time.perf_counter() - t0
        if 19 in phases:
            torch.cuda.empty_cache()
            res["gs_failures"] = []
            res["gs"] = _gs_rank(mesh, device, res["gs_failures"], max_err)
            res["gs_seconds"] = time.perf_counter() - t0 - res["seconds"]
        res.update(failures=failures, max_err=max_err)
        with open(f"{out_dir}/rank{rank}.json", "w") as f:
            json.dump(res, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _dp_cli(card, tmp, dev="cuda"):
    """``torchrun --standalone --nproc_per_node 2 -m
    ocflow_torch.train_unsupervised --dist_backend gloo`` on
    ``configs/longrun_synthetic.yaml`` with ``DP_CLI_CUTS``: exit 0 (``fit``
    checks at its end that the ranks' parameters are equal, and raises if
    not), one ``fit:`` and one ``test:`` line (rank 0 prints), one CSV
    header with a train row a step and 1 val row (rank 0 writes), one TensorBoard
    event file, the best checkpoint. Returns its wall time."""
    import csv
    import os
    import subprocess

    from ocflow_torch.train import config as config_lib

    with open("configs/longrun_synthetic.yaml") as f:
        raw = config_lib.parse_flat_yaml(f.read())
    raw.update(DP_CLI_CUTS)
    raw.update({k: os.path.join(tmp, v) for k, v in (
        ("metrics_csv", "metrics.csv"), ("log_dir", "tb"), ("checkpoint_dir", "ckpt"),
        ("result_dir", "."))})
    path = os.path.join(tmp, "dp.yaml")
    with open(path, "w") as f:
        f.write("".join(f"{k}: {_yaml_value(v)}\n" for k, v in raw.items()))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node", str(DP_WORLD), "-m",
                           "ocflow_torch.train_unsupervised", "--config", path,
                           "--device", dev, "--dist_backend", "gloo"],
                          capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    fit_lines = [ln for ln in lines if ln.startswith("fit:")]
    test_lines = [ln for ln in lines if ln.startswith("test:")]
    with open(raw["metrics_csv"]) as f:
        text = f.read().splitlines()
    phases = [r["phase"] for r in csv.DictReader(text)]
    n_train = int(0.8 * raw["dataset_size"]) // raw["batch_size"]
    events = [n for n in os.listdir(raw["log_dir"]) if n.startswith("events")]
    ckpts = os.listdir(raw["checkpoint_dir"])
    print(f"dp torchrun CLI (2 gloo ranks on one card, longrun_synthetic.yaml with "
          f"{DP_CLI_CUTS}): exit {proc.returncode}, {fit_lines}, {test_lines}, CSV "
          f"{sum(t.startswith('phase,') for t in text)} header, {phases.count('train')} "
          f"train and {phases.count('val')} val rows, {len(events)} TensorBoard event "
          f"file, checkpoints {ckpts}; {wall:.1f} s wall (torchrun, both ranks' start and "
          f"TensorBoard included) [{card}]")
    if proc.returncode != 0 or len(fit_lines) != 1 or len(test_lines) != 1 \
            or sum(t.startswith("phase,") for t in text) != 1 \
            or phases != ["train"] * n_train + ["val"] or len(events) != 1 or not ckpts:
        raise AssertionError(f"dp torchrun CLI: {proc.returncode} {phases} {events} "
                             f"{proc.stdout[-2000:]} {proc.stderr[-3000:]}")
    return wall


def _dp_dryrun(card):
    """``python -m ocflow_torch.tools.dryrun_multigpu --nproc 2 --backend
    gloo`` (cuda; its default 4 pairs at 64x64, a 1x1 map at level 6): exit
    0, its JSON line. Returns it."""
    import subprocess

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "ocflow_torch.tools.dryrun_multigpu",
                           "--nproc", str(DP_WORLD), "--backend", "gloo"],
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"dryrun_multigpu: exit {proc.returncode} "
                             f"{proc.stdout[-2000:]} {proc.stderr[-3000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"dp dryrun_multigpu --nproc 2 --backend gloo: exit 0, metrics vs oracle max rel "
          f"{res['metric_max_rel']:.3e}, gradients {res['grad_max_rel']:.3e} of max|grad| "
          f"({res['grad_worst']}), replicas equal {res['replicas_equal']}; {wall:.1f} s wall "
          f"[{card}]")
    return res


def _phase18(card, max_err, dev="cuda", phases=(18, 19)):
    """Phase 18 (module docstring): two gloo ranks sharing the card, which
    run phase 19's steps too when ``phases`` has 19. Returns the launches
    of phase 18's paths, per rank, and its numbers (the ranks' readings
    under ``ranks``)."""
    import os
    import tempfile

    from ocflow_torch.tools.dryrun_multigpu import spawn

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    launches, failures = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        spawn(_dp_rank, DP_WORLD, tmp, dev, phases, timeout=900)
        ranks = []
        for r in range(DP_WORLD):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    ranks_s = time.perf_counter() - t0
    for res in ranks:
        for k, v in res["max_err"].items():
            max_err[k] = max(max_err[k], v)
    if 18 not in phases:
        return launches, {"ranks": ranks, "ranks_s": ranks_s,
                          "processes": _dp_processes(card, phases, dev)}
    label = f"[two ranks sharing one card, gloo; {card}]"
    for res in ranks:
        r = res["rank"]
        failures += [f"rank {r}: {f}" for f in res["failures"]]
        print(f"dp rank {r} on {res['device']}: collectives {res['collectives']}")
        for path, s in res["serving"].items():
            launches[f"dp_{path}_rank{r}"] = s["launches"]
            print(f"dp rank {r} fast_apply_sharded {path} (its block of B=8 448x1024): "
                  f"launches {s['launches']} (expected {s['expected']}); block vs the "
                  f"single-process fast_apply max_abs_diff {s['diff_block']:.3e}, gathered "
                  f"batch vs the blocks' forwards {s['diff_gathered']:.3e} (bit for bit "
                  f"{s['bitwise']}; tol {s['tol']:.3e}, 2^-6 of max|flow| {s['max_abs']:.3e})")
        tr = res["train"]
        launches[f"dp_train_rank{r}"] = tr["launches"]
        if "oracle" in tr:
            o = tr["oracle"]
            print(f"dp rank {r} fp32 step vs the single-process oracle (deterministic "
                  f"algorithms): metrics {o['metrics']} vs {o['oracle_metrics']}, max rel "
                  f"{max(o['metric_rel'].values()):.3e} (tol {DP_METRIC_REL}); gradients max "
                  f"{o['grad_max_rel']:.3e} of max|grad| ({o['grad_worst']}), median "
                  f"{o['grad_median_rel']:.3e} (tol {DP_GRAD_REL})")
        print(f"dp rank {r} bf16 step launches {tr['launches']} (expected 10 / 5 / 72 / 31 / "
              f"0); replayed calls fp32 {tr.get('replayed_fp32', 0)}, bf16 "
              f"{tr.get('replayed_bf16', 0)}; 3 Adam steps: losses {tr['adam']['losses']}, "
              f"parameter checksum {tr['adam']['checksum']!r}, replicas equal "
              f"{tr['adam']['replicas_equal']}")
        if "single_b8_ms" in tr:
            print(f"time dp single-process bf16 step B=8 448x1024 (rank 0 alone): "
                  f"{tr['single_b8_ms']:.3f} ms/step {label}")
        print(f"time dp sharded bf16 step, rank {r}'s block of 4: {tr['rank_step_ms']:.3f} "
              f"ms/step (mean of {DP_TIMED_STEPS}, both ranks stepping at once) {label}")
        for key, s in res["spatial"].items():
            launches[f"dp_spatial_{key}_rank{r}"] = s["launches"]
            print(f"dp rank {r} spatial_cost_volume {key} {s['shape']} rows {s['rows']}: "
                  f"rel to max|single| {s['rel']} (tol {DP_SPATIAL_REL}), bit for bit "
                  f"{s['bitwise']}, launches cost_volume {s['launches']['cost_volume']} "
                  f"backward {s['launches']['cost_volume_bwd']}")
        print(f"dp rank {r}: {res['seconds']:.1f} s from joining the group")
    processes = _dp_processes(card, phases, dev)
    cli_s, dry = processes["dp_cli"], processes["dryrun"]
    checksums = {res["train"]["adam"]["checksum"] for res in ranks}
    if len(checksums) != 1:
        failures.append(f"dp parameter checksums differ: {checksums}")
    if failures:
        raise AssertionError("; ".join(failures))
    wall = time.perf_counter() - t0
    gs_s = max(res.get("gs_seconds", 0.0) for res in ranks)
    print(f"data parallelism: phase 18 took {wall:.1f} s wall (the ranks {ranks_s:.1f} s, of "
          f"which phase 19's steps {gs_s:.1f} s; then at the same time the torchrun CLI "
          f"{cli_s:.1f} s, the dry run {dry['seconds']:.1f} s of its own and phase 19's "
          f"torchrun GAN CLI {processes.get('gs_cli', 0.0):.1f} s) [{card}]")
    return launches, {"ranks": ranks, "ranks_s": ranks_s, "processes": processes,
                      "seconds": wall}


def _dp_processes(card, phases=(18, 19), dev="cuda"):
    """The process groups of phases 18 and 19, started at the same time
    (mostly their processes' start-up on the host, each waited on in a
    thread): phase 18's torchrun CLI (:func:`_dp_cli`) and dry run
    (:func:`_dp_dryrun`), phase 19's torchrun GAN CLI (:func:`_gs_cli`).
    Their results by name; a failed check raises."""
    import tempfile

    with tempfile.TemporaryDirectory() as t18, tempfile.TemporaryDirectory() as t19, \
            ThreadPoolExecutor(3) as pool:
        jobs = {}
        if 18 in phases:
            jobs["dp_cli"] = pool.submit(_dp_cli, card, t18, dev)
            jobs["dryrun"] = pool.submit(_dp_dryrun, card)
        if 19 in phases:
            jobs["gs_cli"] = pool.submit(_gs_cli, card, t19, dev)
        return {k: f.result() for k, f in jobs.items()}


# 19. global batch statistics over the ranks (synced BatchNorm, the eager
# FlowNetCV's feature moments): every regime's step over two ranks against
# the single-process step on the whole batch, in phase 18's ranks
GS_SEED = 19
GS_SIZE = (8, 448, 1024)       # the zoo's global batch (4 a rank)
GS_LR = 1e-4
GS_METRIC_REL, GS_METRIC_ABS = 1e-4, 1e-12  # fp32 metrics: relative (and absolute: smooth2, weighted 0)
GS_GRAD_REL = 1e-3             # fp32: each gradient, max-abs over its net's max|grad|
GS_STATS_REL = 1e-5            # fp32: each running statistic, max-abs over its max
GS_BF16_LOSS_REL = 2e-2        # the bf16 joint step's loss, relative
# the GAN, GC and joint steps' fp32 gradients: one process's own fp32 step
# lies ~1e-2 of the net's max|grad| from the fp64 step there (InpaintingNet's
# and the gated generator's train-mode BatchNorms carry fp32 rounding far:
# read 6.6e-3-1.9e-2 on the CPU at 2x128x256, as far as the ranks' step), so
# the ranks' fp32 step is held against the single-process fp64 step: per
# net, its worst per-tensor error and its relative L2 each within
# GS_WITNESS_RATIO times the single-process fp32 step's own, plus
# GS_WITNESS_SLACK of the net's max|grad| (and of the net's norm)
GS_WITNESS_RATIO, GS_WITNESS_SLACK = 2.0, 1e-3
# the zoo: network_type, cost-volume launches (forward, backward) of a rank's step
GS_ZOO = {"pwc": ("flow", (5, 5)), "flowoccnetc": ("flow-occ", (1, 1)),
          "flownet": ("flow", (5, 5)), "flownetc": ("unsupervised", (2, 1))}
# configs/inpainting_gan_fullres.yaml through torchrun: these cuts only (8
# samples: 6 / 0 / 2, 3 steps of 2 pairs)
GS_CLI_CUTS = {"dataset_size": 8, "max_epochs": 1, "log_every_n_steps": 1,
               "log_image_every_epoch": 1}


@contextlib.contextmanager
def _collectives_counted():
    """Inside, the count of ``Mesh.psum`` calls (the synced statistics'
    forward collectives: BatchNorm, feature moments) and of every
    ``all_reduce`` (their backward, the gradients' and metrics' sums too)."""
    import torch.distributed as dist

    from ocflow_torch.parallel import mesh as mesh_mod

    box = {"psum": 0, "all_reduce": 0}
    psum, all_reduce = mesh_mod.Mesh.psum, dist.all_reduce

    def counted_psum(self, t):
        box["psum"] += 1
        return psum(self, t)

    def counted_all_reduce(*a, **k):
        box["all_reduce"] += 1
        return all_reduce(*a, **k)

    mesh_mod.Mesh.psum, dist.all_reduce = counted_psum, counted_all_reduce
    try:
        yield box
    finally:
        mesh_mod.Mesh.psum, dist.all_reduce = psum, all_reduce


def _gs_parts(state):
    """``[(net name, model, optimizer)]`` of a train state or of a GAN
    pair; a ``ModuleDict`` under one optimizer is split into its nets."""
    if isinstance(state, tuple):
        return [("G", state[0].model, state[0].optimizer),
                ("D", state[1].model, state[1].optimizer)]
    if isinstance(state.model, torch.nn.ModuleDict):
        return [(k, m, state.optimizer) for k, m in state.model.items()]
    return [("net", state.model, state.optimizer)]


def _gs_step(state, step, batch):
    """One train step; its metrics, every net's gradients (recorded before
    the optimizer, which may gate them) and running statistics."""
    grads = {}
    parts = _gs_parts(state)
    wrapped = []
    for opt in {id(o): o for _, _, o in parts}.values():
        inner = opt.step

        def snap(*a, _inner=inner, **k):
            for name, model, _ in parts:
                for n, p in model.named_parameters():
                    if p.grad is not None:
                        grads[f"{name}.{n}"] = p.grad.detach().clone()
            return _inner(*a, **k)

        opt.step = snap
        wrapped.append((opt, inner))
    try:
        _, metrics = step(state, batch)
    finally:
        for opt, inner in wrapped:
            opt.step = inner
    stats = {f"{name}.{n}": b.detach().clone() for name, model, _ in parts
             for n, b in model.named_buffers() if n.endswith(("running_mean", "running_var"))}
    return {k: float(v) for k, v in metrics.items()}, grads, stats


def _gs_net_errors(grads, ref):
    """Per net (the names' first part): the worst per-tensor max-abs error
    of ``grads`` against ``ref`` over the net's max|ref| (name, value), and
    the relative L2 over the net."""
    out = {}
    for net in sorted({k.split(".")[0] for k in ref}):
        keys = [k for k in ref if k.split(".")[0] == net]
        top = max(ref[k].abs().max().item() for k in keys)
        errs = {k: (grads[k].double() - ref[k].double()).abs().max().item() / max(top, 1e-300)
                for k in keys}
        worst = max(errs, key=errs.get)
        num = sum(((grads[k].double() - ref[k].double()) ** 2).sum().item() for k in keys)
        den = sum((ref[k].double() ** 2).sum().item() for k in keys)
        out[net] = {"worst": worst, "max": errs[worst], "l2": (num / max(den, 1e-300)) ** 0.5}
    return out


def _gs_compare(label, got, want, bf16, failures, witness=None):
    """The ranks' step against the single-process step (the phase-19
    constants); with ``witness`` (the single-process fp64 step's
    gradients) the gradients are held against it instead; returns the
    readings."""
    metrics, grads, stats = got
    ref_metrics, ref_grads, ref_stats = want
    mrel = {k: abs(metrics[k] - v) / max(abs(v), 1e-30) for k, v in ref_metrics.items()}
    out = {"metrics": metrics, "single_metrics": ref_metrics, "metric_rel": mrel}
    if bf16:
        ok = mrel["loss"] <= GS_BF16_LOSS_REL
    else:
        ok = set(metrics) == set(ref_metrics) and all(
            abs(metrics[k] - v) <= GS_METRIC_REL * abs(v) + GS_METRIC_ABS
            for k, v in ref_metrics.items())
        nets = {k.split(".")[0] for k in ref_grads}
        top = {n: max(g.abs().max().item() for k, g in ref_grads.items()
                      if k.split(".")[0] == n) for n in nets}
        gerr = {k: (grads[k] - g).abs().max().item() / max(top[k.split(".")[0]], 1e-30)
                for k, g in ref_grads.items()}
        own = {k: (grads[k] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
               for k, g in ref_grads.items()}
        serr = {k: (stats[k] - s).abs().max().item() / max(s.abs().max().item(), 1e-30)
                for k, s in ref_stats.items()}
        out.update(grad_worst=_worst(gerr), grad_max=max(gerr.values()),
                   grad_own_worst=_worst(own), grad_tensors=len(gerr),
                   stats_worst=_worst(serr) if serr else None, stats_buffers=len(serr))
        if witness is None:
            grads_ok = max(gerr.values()) <= GS_GRAD_REL
        else:
            ranks64, single64 = _gs_net_errors(grads, witness), _gs_net_errors(ref_grads,
                                                                               witness)
            out["witness"] = {"ranks": ranks64, "single": single64}
            grads_ok = all(
                ranks64[n][k] <= GS_WITNESS_RATIO * single64[n][k] + GS_WITNESS_SLACK
                for n in single64 for k in ("max", "l2"))
        ok = ok and set(grads) == set(ref_grads) and grads_ok \
            and (not serr or max(serr.values()) <= GS_STATS_REL)
    out["ok"] = ok
    if not ok:
        failures.append(f"gs {label} vs the single-process step: {out}")
    return out


def _gs_cases(dev):
    """``{label: (make, net module or None, expected launches, replay dtype
    or None, witness, reference)}``; ``make(step_mesh, dtype=float32)``
    builds from the seeds (each net drawn once, then copied) a fresh train
    state on ``dev`` in ``dtype``, its train step built for ``step_mesh``
    and the whole global batch (CPU); ``witness``: the gradients are held
    against the single-process fp64 step (``GS_WITNESS_RATIO``);
    ``reference``: the case whose single-process readings stand for this
    one's (the same weights, batch and step: the GC step before and after
    the inpainter unfreezes computes the same gradient, and only its
    optimizer gates it)."""
    from ocflow_torch.bench import smooth_images
    from ocflow_torch.models import flow_occ_nets, registry
    from ocflow_torch.train import TrainState
    from ocflow_torch.train import config as config_lib
    from ocflow_torch.train import steps
    from ocflow_torch.train.steps_inpainting import make_gan_inpainting_step
    from ocflow_torch.train.steps_joint import make_joint_step
    from ocflow_torch.train.steps_two_stage import (make_two_stage_gc_optimizer,
                                                    make_two_stage_gc_step)

    b, h, w = GS_SIZE
    g = torch.Generator().manual_seed(GS_SEED)
    share = torch.linspace(0.05, 0.6, b).view(b, 1, 1, 1)
    zoo_batch = {"images": smooth_images(torch.rand((b, 6, h // 8, w // 8), generator=g) * 2 - 1),
                 "flow": torch.randn((b, h, w, 2), generator=g) * 3,
                 "occ": (torch.rand((b, h, w, 1), generator=g) < share).float()}
    unsup_hp = {**config_lib.load_config("configs/longrun_synthetic.yaml").as_hparams(),
                "compute_dtype": "float32"}

    drawn = {}

    def once(name, build):
        """A fresh copy of the net(s) ``build()`` draws, drawn once."""
        if name not in drawn:
            drawn[name] = build()
        return copy.deepcopy(drawn[name])

    def zoo(key):
        kind = GS_ZOO[key][0]
        family = "flow_occ" if kind == "flow-occ" else "flow"

        def make(m, dtype=torch.float32):
            model = once(key, lambda: registry.build(
                family, key, generator=torch.Generator().manual_seed(GS_SEED)))
            if kind == "unsupervised":
                step, _ = steps.make_unsupervised_flow_step(
                    {**unsup_hp, "model": key, "_fast_mesh": m})
            else:
                factory = {"flow": steps.make_supervised_flow_step,
                           "flow-occ": steps.make_supervised_flow_occ_step}[kind]
                step, _ = factory({"model": key, "_fast_mesh": m})
            return TrainState(model.to(dev, dtype), torch.optim.Adam(
                model.parameters(), lr=GS_LR)), step, zoo_batch
        return make

    gan_cfg = config_lib.load_config("configs/inpainting_gan_fullres.yaml")

    def gan(m, dtype=torch.float32):
        # SGD at the config's rates (D at 4x), not the CLI's Adam: the D
        # step comes first, and Adam would move D's weights whose gradient
        # is rounding (a bias before a train-mode BatchNorm) by about the
        # learning rate in another direction on the ranks than in one
        # process, and g_loss reads the moved D (phase 15's check steps so)
        gen, dis = (n.to(dev, dtype) for n in once(
            "gan", lambda: _gan_nets("gated", remat=gan_cfg.remat)))
        lr = gan_cfg.learning_rate
        states = (TrainState(gen, torch.optim.SGD(gen.parameters(), lr=lr)),
                  TrainState(dis, torch.optim.SGD(dis.parameters(), lr=4 * lr)))
        return (states, make_gan_inpainting_step({**gan_cfg.as_hparams(), "_fast_mesh": m}),
                _gan_batch(GAN_SIZE))

    gc_cfg = config_lib.load_config("configs/two_stage_gc_fullres.yaml")

    def gc(unfreeze_step):
        def make(m, dtype=torch.float32):
            pair = once("gc", lambda: _gc_pair("gated", remat=gc_cfg.remat,
                                               perturb=True)).to(dev, dtype)
            opt = make_two_stage_gc_optimizer(pair, gc_cfg.learning_rate, gc_cfg.finetune_lr,
                                              unfreeze_step)
            step, _ = make_two_stage_gc_step({**gc_cfg.as_hparams(), "_fast_mesh": m})
            return TrainState(pair, opt), step, _gc_batch(GC_SIZE)
        return make

    joint_batch = _joint_batch("cpu")

    def joint(policy):
        def make(m, dtype=torch.float32):
            pair = once("joint", _joint_pair).to(dev, dtype)
            step, _ = make_joint_step({"dtype": policy, "_fast_mesh": m})
            return (TrainState(pair, torch.optim.Adam(pair.parameters(), lr=GS_LR)), step,
                    joint_batch)
        return make

    cases = {key: (zoo(key), _net_module(key), GS_ZOO[key][1], torch.float32, False, key)
             for key in GS_ZOO}
    cases.update({
        "gan": (gan, None, (0, 0), None, True, "gan"),
        "gc_before_unfreeze": (gc(1), None, (0, 0), None, True, "gc_before_unfreeze"),
        "gc_after_unfreeze": (gc(0), None, (0, 0), None, True, "gc_before_unfreeze"),
        "joint_fp32": (joint(None), flow_occ_nets, (5, 5), torch.float32, True, "joint_fp32"),
        "joint_bf16": (joint("bfloat16"), flow_occ_nets, (5, 5), torch.bfloat16, False,
                       "joint_bf16")})
    return cases


def _gs_single(make, batch, dev, witness, module):
    """The single-process step of a phase-19 case on the whole batch: its
    readings (:func:`_gs_step`), with ``witness`` the gradients of the fp64
    step (``module``'s ``cost_volume``, if any, on the plain version
    meanwhile: the kernels are fp32 and bf16), and the ms of a second step
    (host clock)."""
    from ocflow_torch import parallel
    from ocflow_torch.kernels import cost_volume as cv_mod

    alone = parallel.Mesh(0, 1)
    single, single_step, _ = make(alone)
    whole = {k: v.to(dev) for k, v in batch.items()}
    want = _gs_step(single, single_step, whole)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    single_step(single, whole)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    del single
    torch.cuda.empty_cache()
    grads64 = None
    if witness:
        exact, exact_step, _ = make(alone, torch.float64)
        saved = module.cost_volume if module else None
        if module:
            module.cost_volume = cv_mod.cost_volume_plain
        try:
            grads64 = _gs_step(exact, exact_step, {k: v.double() for k, v in whole.items()})[1]
        finally:
            if module:
                module.cost_volume = saved
        del exact
        torch.cuda.empty_cache()
    return want, grads64, ms


def _gs_rank(mesh, dev, failures, max_err):
    """Phase 19 on this rank: each case of :func:`_gs_cases` over the ranks
    (deterministic algorithms): one step on this rank's block with its
    launches counted, its kernel calls recorded and its collectives
    counted; a second step and the replicas checked equal bit for bit
    (parameters and buffers), that step's ms; rank 0 then runs the
    single-process step on the whole batch and holds the ranks' step
    against it (and times a second one); the recorded calls replayed against
    their plain versions, the fp32 ones on rank 0, the bf16 ones on rank 1.
    Returns the readings by case."""
    import os

    import torch.distributed as dist

    from ocflow_torch import parallel
    from ocflow_torch.kernels import cost_volume as cv_mod
    from ocflow_torch.train.loop import _models

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    alone = parallel.Mesh(0, 1)
    out, singles = {}, {}
    try:
        for label, (make, module, expect, replay, witness, ref) in _gs_cases(dev).items():
            dist.barrier()
            state, step, batch = make(mesh)
            block = {k: v.to(dev) for k, v in parallel.shard_batch(batch, mesh).items()}
            targets = [(module, "cost_volume"), (cv_mod, "cost_volume_backward")] if module \
                else []
            box = {}
            _zero_counts()
            with _collectives_counted() as coll:
                calls = _record(targets, lambda: box.update(r=_gs_step(state, step, block)))
            counts = _read_counts()
            launches = {"cost_volume": counts["cost_volume"],
                        "cost_volume_bwd": counts["cost_volume_bwd"]}
            res = {"launches": counts, "collectives": dict(coll)}
            if (launches["cost_volume"], launches["cost_volume_bwd"]) != expect or any(
                    v for k, v in counts.items() if k not in launches):
                failures.append(f"gs {label} rank {mesh.rank} launches {counts}, want "
                                f"{expect}")
            mine = box.pop("r")
            # a second step: the replicas after two steps, the rank step's ms
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            step(state, block)
            torch.cuda.synchronize()
            res["rank_step_ms"] = (time.perf_counter() - t0) * 1e3
            try:
                parallel.check_replicated(_models(state), mesh)
                res["replicas_equal"] = True
            except RuntimeError:
                res["replicas_equal"] = False
                failures.append(f"gs {label}: the ranks' nets differ after two steps")
            del state, block
            torch.cuda.empty_cache()
            dist.barrier()
            if mesh.rank == 0:
                if ref not in singles:
                    singles[ref] = _gs_single(make, batch, dev, witness, module)
                want, witness64, res["single_step_ms"] = singles[ref]
                res.update(_gs_compare(label, mine, want, replay == torch.bfloat16, failures,
                                       witness64))
            del mine
            torch.cuda.empty_cache()
            if replay is not None and mesh.rank == (0 if replay == torch.float32 else 1):
                for k, (kind, args) in enumerate(calls):
                    _check_float("cost_volume_bwd" if kind == "cost_volume_backward" else kind,
                                 args, replay, max_err, f"gs {label} rank {mesh.rank} "
                                 f"d={args[-1]} call {k} ")
                res["replayed"] = len(calls)
            del calls
            torch.cuda.empty_cache()
            out[label] = res
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    dist.barrier()
    return out


def _gs_cli(card, tmp, dev="cuda"):
    """``torchrun --standalone --nproc_per_node 2 -m
    ocflow_torch.train_unsupervised --dist_backend gloo`` on
    ``configs/inpainting_gan_fullres.yaml`` with ``GS_CLI_CUTS``: exit 0
    (``fit`` checks at its end that the replicas, generator and
    discriminator, are equal, and raises if not), one ``fit:``, one ``test:``
    and one ``generator checkpoint:`` line (rank 0 prints), one CSV header
    with 3 train rows (rank 0 writes), one TensorBoard event file, the
    exported generator loadable. Returns its wall time."""
    import csv
    import os
    import subprocess

    from ocflow_torch.train import config as config_lib
    from ocflow_torch.utils.checkpoint import load_pytree

    with open("configs/inpainting_gan_fullres.yaml") as f:
        raw = config_lib.parse_flat_yaml(f.read())
    raw.update(GS_CLI_CUTS)
    raw.update({k: os.path.join(tmp, v) for k, v in (
        ("metrics_csv", "metrics.csv"), ("log_dir", "tb"), ("checkpoint_dir", "ckpt"),
        ("result_dir", "."))})
    path = os.path.join(tmp, "gan.yaml")
    with open(path, "w") as f:
        f.write("".join(f"{k}: {_yaml_value(v)}\n" for k, v in raw.items()))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node", str(DP_WORLD), "-m",
                           "ocflow_torch.train_unsupervised", "--config", path,
                           "--device", dev, "--dist_backend", "gloo"],
                          capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    picked = {k: [ln for ln in lines if ln.startswith(k)]
              for k in ("fit:", "test:", "generator checkpoint:")}
    with open(raw["metrics_csv"]) as f:
        text = f.read().splitlines()
    rows = list(csv.DictReader(text))
    phases = [r["phase"] for r in rows]
    events = [n for n in os.listdir(raw["log_dir"]) if n.startswith("events")]
    gen_path = os.path.join(raw["checkpoint_dir"], "generator")
    exported = os.path.exists(gen_path) and "params" in load_pytree(gen_path)
    print(f"gs torchrun GAN CLI (2 gloo ranks on one card, inpainting_gan_fullres.yaml with "
          f"{GS_CLI_CUTS}: 448x1024, B=2, 1 a rank, remat): exit {proc.returncode}, "
          f"{picked['fit:']}, {picked['test:']}, {picked['generator checkpoint:']}; CSV "
          f"{sum(t.startswith('phase,') for t in text)} header, {phases.count('train')} train "
          f"rows (steps {[r['step'] for r in rows]}), {len(events)} TensorBoard event file, "
          f"generator exported {exported}; {wall:.1f} s wall (torchrun, both ranks' start and "
          f"TensorBoard included) [{card}]")
    if proc.returncode != 0 or any(len(v) != 1 for v in picked.values()) \
            or sum(t.startswith("phase,") for t in text) != 1 or phases != ["train"] * 3 \
            or len(events) != 1 or not exported:
        raise AssertionError(f"gs torchrun GAN CLI: {proc.returncode} {phases} {events} "
                             f"{proc.stdout[-2000:]} {proc.stderr[-3000:]}")
    return wall


def _phase19(card, ranks, cli_s):
    """Phase 19 (module docstring): the readings of :func:`_gs_rank` from
    each rank; ``cli_s``: the wall time of its torchrun GAN CLI
    (:func:`_gs_cli`, run beside phase 18's processes). Returns the launches
    of its paths, per rank, and its numbers."""
    t0 = time.perf_counter()
    launches, failures = {}, []
    label = f"[two ranks sharing one card, gloo; {card}]"
    for res in ranks:
        r = res["rank"]
        failures += [f"rank {r}: {f}" for f in res.get("gs_failures", [])]
        for case, c in res["gs"].items():
            launches[f"gs_{case}_rank{r}"] = c["launches"]
            print(f"gs rank {r} {case}: launches {c['launches']}; collectives of the step "
                  f"{c['collectives']} (psum: the synced statistics' forward collectives; "
                  f"all_reduce: every collective, their backward and the gradients' and "
                  f"metrics' sums included); replicas equal after two steps "
                  f"{c['replicas_equal']}; replayed calls {c.get('replayed', 0)}")
            if "metrics" in c:
                held = "printed" if "witness" in c else f"tol {GS_GRAD_REL}"
                extra = ("" if "grad_worst" not in c else
                         f"; gradients worst {c['grad_worst']} of the net's max|grad| ({held}; "
                         f"of the tensor's own max {c['grad_own_worst']}, printed) over "
                         f"{c['grad_tensors']} tensors; running statistics worst "
                         f"{c['stats_worst']} over {c['stats_buffers']} buffers (tol "
                         f"{GS_STATS_REL})")
                if "witness" in c:
                    w = c["witness"]
                    extra += ("; against the single-process fp64 step, per net (worst "
                              "per-tensor over the net's max|grad|, relative L2), the ranks' "
                              "fp32 step " + ", ".join(
                                  f"{n} {v['max']:.3e} ({v['worst']}) / {v['l2']:.3e}"
                                  for n, v in w["ranks"].items())
                              + "; the single-process fp32 step " + ", ".join(
                                  f"{n} {v['max']:.3e} / {v['l2']:.3e}"
                                  for n, v in w["single"].items())
                              + f" (held: the ranks' within {GS_WITNESS_RATIO}x the single "
                              f"step's + {GS_WITNESS_SLACK})")
                tol = GS_BF16_LOSS_REL if case == "joint_bf16" else GS_METRIC_REL
                print(f"gs {case} over two ranks vs the single-process step on the whole "
                      f"batch: metrics {c['metrics']} vs {c['single_metrics']}, relative "
                      f"{_worst(c['metric_rel'])} (tol {tol}"
                      f"{', the loss' if case == 'joint_bf16' else ''}){extra}")
                print(f"time gs {case}: single-process step {c['single_step_ms']:.3f} ms, "
                      f"rank 0's block {c['rank_step_ms']:.3f} ms (host clock, both ranks "
                      f"stepping at once; for the record only) {label}")
            else:
                print(f"time gs {case}: rank {r}'s block {c['rank_step_ms']:.3f} ms {label}")
    if failures:
        raise AssertionError("; ".join(failures))
    steps_s = max(res["gs_seconds"] for res in ranks)
    print(f"global batch statistics: phase 19's steps took {steps_s:.1f} s in phase 18's "
          f"ranks, its torchrun GAN CLI {cli_s:.1f} s beside phase 18's processes [{card}]")
    return launches, {"cli_s": cli_s, "steps_s": steps_s, "seconds": time.perf_counter() - t0}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from ocflow_torch.bench import (BATCH, HEIGHT, SEED, WIDTH, calibration_batch,
                                    cuda_ms, gpu_info, make_inputs, measure)
    from ocflow_torch.data import native_io
    from ocflow_torch.kernels import _build, conv_chain, conv_chain_q8
    from ocflow_torch.kernels import cost_volume as cv_mod
    from ocflow_torch.models import pwc_fast
    from ocflow_torch.tools import spike_int8
    from ocflow_torch.tools.q8_error import flow_errors

    # PyTorch's own TF32 flags, read once for phase 6; off everywhere else
    tf32_defaults = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = gpu_info()
    print(card)  # name, power limit: the line nvidia-smi gives
    dev = torch.device("cuda")

    # 2. build: the kernels (one nvcc each) and the host decoder (g++), all
    # started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(native_io.build)
        built = _build.build_all()
        built["host decoder (g++)"] = host.result()
    print(f"build: {time.perf_counter() - t0:.2f} s wall; " + ", ".join(
        f"{k} {v['seconds']:.2f} s" for k, v in built.items()))

    model, x32 = make_inputs(BATCH, HEIGHT, WIDTH, torch.float32, "cuda", SEED)
    model.eval()
    model_b = copy.deepcopy(model).bfloat16()
    xb = x32.bfloat16()
    max_err = {"cost_volume": 0.0, "conv_group": 0.0, "conv_group_q8": 0.0,
               "cost_volume_bwd": 0.0, "conv_group_diff": 0.0, "cost_volume_general": 0.0,
               "cost_volume_bwd_general": 0.0, "conv_group_tma": 0.0,
               "conv_group_q8_tma": 0.0, "conv_group_diff_bwd": 0.0}
    serving = [(pwc_fast, n) for n in ("cost_volume", "conv_group", "conv_group_q8")]

    # 3. every kernel call of the bf16/fp32 path, kernel vs plain
    recorded = {}
    for dtype, m, x in ((torch.float32, model, x32), (torch.bfloat16, model_b, xb)):
        calls = _record(serving, lambda: pwc_fast.fast_apply(m, x))
        recorded[dtype] = calls
        for kind, args in calls:
            _check_float(kind, args, dtype, max_err)

    # 4. W8A8: calibrate on the held-out batch, replay every call
    t0 = time.perf_counter()
    xc = calibration_batch(xb)
    scales = {"w8a8": pwc_fast.calibrate_q8(model_b, xc),
              "w8a8_enc_ctx": pwc_fast.calibrate_q8(model_b, xc, encoder=True, ctx=True)}
    del xc
    print(f"calibrate_q8 (bf16, seed-1 batch, decoders; then + encoder and "
          f"context chain): {time.perf_counter() - t0:.2f} s host")
    q8_plain_ms = {mode: [] for mode in scales}
    for mode, sc in scales.items():
        label = f"{mode} "
        calls = _record(serving, lambda: pwc_fast.fast_apply(model_b, xb, q8=sc))
        recorded[mode] = [args for kind, args in calls if kind == "conv_group_q8"]
        for kind, args in calls:
            if kind == "conv_group_q8":
                q8_plain_ms[mode].append(_check_q8(args, max_err, label))
            else:
                _check_float(kind, args, torch.bfloat16, max_err, label)
        del calls

    # 5. each path once, its launches counted (conv_group_tma: those of
    # the stride-1 bf16 convs on the TMA kernel, as launch_counts reckons
    # them at this input size)
    size = (BATCH, HEIGHT, WIDTH)
    want = {"bf16": pwc_fast.prepare(model_b, torch.bfloat16, dev).launch_counts(size)}
    want.update({mode: pwc_fast.prepare(model_b, torch.bfloat16, dev, sc).launch_counts(size)
                 for mode, sc in scales.items()})
    launches, outs = {}, {}
    launches["bf16"], outs["bf16"] = _count_launches_tma(
        lambda: pwc_fast.fast_apply(model_b, xb))
    for mode, sc in scales.items():
        launches[mode], outs[mode] = _count_launches_tma(
            lambda: pwc_fast.fast_apply(model_b, xb, q8=sc))  # noqa: B023
    launches["spike_int8"], gemm_res = _count_launches(
        spike_int8.probe)
    for path in want:
        expect = {"cost_volume": 5, "cost_volume_bwd": 0, "conv_group_diff": 0,
                  **want[path], "gemm_probe": 0}
        print(f"main path {path} launches: {launches[path]} (expected {expect})")
        if launches[path] != expect:
            raise AssertionError(f"{path} launch counts {launches[path]}")
    # staged: every bf16 conv but the encoders' six stride-2 convs, every
    # int8 conv of the default W8A8 forward; all those bf16 convs on the
    # TMA kernel
    counted = ("conv_group", "conv_group_staged", "conv_group_tma", "conv_group_q8",
               "conv_group_q8_staged", "conv_group_q8_tma")
    if [launches[p][k] for p in ("bf16", "w8a8") for k in counted] \
            != [59, 53, 53, 0, 0, 0, 24, 18, 18, 0, 0, 35]:
        raise AssertionError(f"launches {launches}, want 59 / 53 / 53 / 0 / 0 / 0 and "
                             "24 / 18 / 18 / 0 / 0 / 35")
    # the int8 TMA kernel's routing depends on no size: KITTI's 8x320x1216
    # (levels 19, 38 and 76 wide) as launch_counts reckons it
    kitti = {mode: pwc_fast.prepare(model_b, torch.bfloat16, dev, sc).launch_counts(
        (BATCH, 320, 1216)) for mode, sc in scales.items()}
    print("main path int8 TMA launches (conv_group_q8_tma of all int8 convs, the rest on "
          "conv_group_q8): "
          + "; ".join(f"{where}: " + ", ".join(
              f"{p} {c['conv_group_q8_tma']} of {c['conv_group_q8_tma'] + c['conv_group_q8']}"
              for p, c in counts.items())
              for where, counts in (("at 8x448x1024", {p: launches[p] for p in scales}),
                                    ("at 8x320x1216 by launch_counts", kitti))))
    if [launches[p]["conv_group_q8_tma"] for p in ("w8a8", "w8a8_enc_ctx")] != [35, 35] or \
            [c["conv_group_q8_tma"] for c in kitti.values()] != [35, 35]:
        raise AssertionError(f"int8 TMA launches {launches}, {kitti}")
    print(f"main path spike_int8 launches: {launches['spike_int8']}")
    if launches["spike_int8"]["gemm_probe"] < 2:
        raise AssertionError("the GEMM probe did not launch its kernel")
    for name, r in gemm_res.items():
        print(f"check gemm_probe {name} {spike_int8.SIZE}^3: max_abs_err "
              f"{r['max_abs_err']:.3e} ({'exact required' if name == 'int8' else '1e-2 of max|plain|'})")

    # 6. end to end; fp32 fast_apply once more with PyTorch's default TF32
    # flags (a user's run; fast_apply pins its fp32 cuDNN convolutions),
    # against the same eager forward (TF32 off)
    out_f = pwc_fast.fast_apply(model, x32)
    with torch.no_grad(), _plain_eager_cost_volume():
        ref = model(x32)
    # the eager FlowNetCV itself on the cost-volume kernel (5 levels)
    launches["eager"], out_eager = _count_launches(lambda: _no_grad(model, x32))
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32_defaults
    try:
        out_tf32 = pwc_fast.fast_apply(model, x32)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    failures = []
    for i, name in enumerate(("full", "quarter")):
        want_shape = (BATCH, HEIGHT, WIDTH, 2) if name == "full" else (
            BATCH, HEIGHT // 4, WIDTH // 4, 2)
        r = ref[i]
        for t in (out_f[i], *(o[i] for o in outs.values())):
            if tuple(t.shape) != want_shape or t.dtype != torch.float32 \
                    or not torch.isfinite(t).all():
                raise AssertionError(f"{name}: bad output {t.shape} {t.dtype}")
        scale = r.abs().max().item()
        err32 = (out_f[i] - r).abs().max().item()
        err_tf32 = (out_tf32[i] - r).abs().max().item()
        eb = flow_errors(outs["bf16"][i], r)
        print(f"e2e {name}: fp32 fast vs eager max_abs_err {err32:.3e} "
              f"(tol {E2E_FP32_TOL * scale:.3e}, max|eager| {scale:.3e}); with "
              f"PyTorch's default TF32 flags (cudnn {tf32_defaults[0]}, matmul "
              f"{tf32_defaults[1]}) {err_tf32:.3e} ({err_tf32 / scale:.3e} of "
              f"max|eager|, same tol); bf16 vs fp32 rel_l2 {eb['rel_l2']:.4f} (tol "
              f"{E2E_BF16_REL_L2}) max_abs_err {eb['max_abs']:.3e}")
        if not err32 <= E2E_FP32_TOL * scale:
            failures.append(f"{name}: fp32 fast_apply vs eager {err32}")
        if not err_tf32 <= E2E_FP32_TOL * scale:
            failures.append(f"{name}: fp32 fast_apply, default TF32 flags, vs eager {err_tf32}")
        if not eb["rel_l2"] <= E2E_BF16_REL_L2:
            failures.append(f"{name}: bf16 vs fp32 rel_l2 {eb['rel_l2']}")
        for mode, tol in E2E_Q8_TOL.items():
            e = flow_errors(outs[mode][i], r)
            e16 = flow_errors(outs[mode][i], outs["bf16"][i])
            print(f"e2e {name}: {mode} vs fp32 eager rel_l2 {e['rel_l2']:.4f} "
                  f"max_abs_err {e['max_abs']:.3e} ({e['max_abs_rel']:.4f} of "
                  f"max|eager|; quarter tol {tol}); vs bf16 fast_apply rel_l2 "
                  f"{e16['rel_l2']:.4f} max_abs_err {e16['max_abs']:.3e}")
            if name == "quarter" and not e["max_abs_rel"] <= tol:
                failures.append(f"{mode} vs fp32 eager: {e['max_abs_rel']} of max > {tol}")
    expect = {k: 0 for k in launches["eager"]}
    expect["cost_volume"] = 5
    print(f"main path eager (the eager fp32 FlowNetCV forward) launches: "
          f"{launches['eager']} (expected {expect})")
    if launches["eager"] != expect:
        raise AssertionError(f"eager launch counts {launches['eager']}")
    for name, o, r in zip(("full", "quarter"), out_eager, ref):
        scale = r.abs().max().item()
        e = (o - r).abs().max().item()
        print(f"e2e {name}: eager fp32 FlowNetCV on the cost-volume kernel vs on the "
              f"plain cost volume max_abs_err {e:.3e} (tol {E2E_FP32_TOL * scale:.3e}, "
              f"max|plain| {scale:.3e})")
        if not e <= E2E_FP32_TOL * scale:
            failures.append(f"{name}: eager kernel vs plain cost volume {e}")
    del out_eager
    if failures:
        raise AssertionError("; ".join(failures))

    # 7. timing (bf16 serving shapes), beside the card on the line above
    per = {k: {"ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
               "bound_ms": 0.0, "library_ms": 0.0}
           for k in ("cost_volume", "cost_volume_bwd", "conv_group",
                     "conv_group_diff", "conv_group_q8", "conv_group_tma",
                     "conv_group_q8_tma")}
    per["conv_group_diff"].update(bwd_ms=0.0, library_bwd_ms=0.0, bwd_bound_ms=0.0,
                                  staged_ms=0.0, tma_ms=0.0, pack_ms=0.0)
    per["conv_group_diff_bwd"] = {}
    per["conv_group"]["staged_ms"] = 0.0
    per["conv_group_tma"]["staged_ms"] = 0.0
    per["conv_group_q8_tma"].update(staged_ms=0.0, bf16_tma_ms=0.0, cudnn_ms=0.0)

    def add(kind, k_ms, p_ms, nbytes, ops, peak, lib_ms):
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = ops / peak * 1e3
        p = per[kind]
        p["ms"] += k_ms
        p["plain_ms"] += p_ms
        p["bytes_ms"] += b_ms
        p["ops_ms"] += o_ms
        p["bound_ms"] += max(b_ms, o_ms)
        p["library_ms"] += lib_ms or 0.0
        return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations"

    for kind, args in recorded[torch.bfloat16]:
        if kind == "cost_volume":
            k_ms = cuda_ms(lambda: cv_mod.cost_volume(*args), 20)
            p_ms = cuda_ms(lambda: cv_mod.cost_volume_plain(*args), 3)
            nbytes, flops = _cv_cost(args[0])
            lib_ms = None
            shape = tuple(args[0].shape)
        else:
            outs_cg = conv_chain.conv_group(*args)
            k_ms = cuda_ms(lambda: conv_chain.conv_group(*args), 5)
            # the PR 5 staged kernel on every stride-1 conv of the group
            s_ms = cuda_ms(lambda: conv_chain.conv_group(*args, staged=True), 5)
            per[kind]["staged_ms"] += s_ms
            p_ms = cuda_ms(lambda: conv_chain.conv_group_plain(*args), 3)
            lib_ms = cuda_ms(_library_conv(*args, outs_cg), 5)
            nbytes, flops = _cg_cost(*args, outs_cg)
            shape = tuple(args[0][0].shape)
        bound, by = add(kind, k_ms, p_ms, nbytes, flops, PEAK_FLOPS[torch.bfloat16], lib_ms)
        staged = "" if kind == "cost_volume" else f", staged kernel (PR 5) {s_ms:.4f} ms"
        print(f"time {kind} bf16 {shape}: kernel {k_ms:.4f} ms ({_rate(flops, k_ms, bound)})"
              f"{staged}, plain {p_ms:.4f} ms, library "
              f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms, "
              f"bound {bound:.4f} ms ({by}; {nbytes} B, {flops} flop) [{card}]")

    p = per["cost_volume"]
    print(f"time cost_volume d=4 sum over the bf16 forward's 5 levels: kernel "
          f"{p['ms']:.4f} ms, plain {p['plain_ms']:.4f} ms, bound {p['bound_ms']:.4f} ms "
          f"({100 * p['bound_ms'] / p['ms']:.2f}% of bound) [{card}]")

    # csrc/conv_group_q8.cu's own launches: the int8 convs of the opt-in
    # 'enc'+'ctx' forward's encoder and context groups (every int8 conv of
    # the default forward runs the TMA kernel, timed conv by conv below),
    # each group's int8 launches on the host's clock (events around the call
    # loop; its bf16-read convs left out)
    skip_bf16 = conv_chain_q8.launch_conv
    for args, p_ms in zip(recorded["w8a8_enc_ctx"], q8_plain_ms["w8a8_enc_ctx"], strict=True):
        inputs, group = args
        if group.nhwc:
            continue
        # the kernels alone: the context group's inputs quantized once here
        inputs = conv_chain_q8.input_codes_q8(inputs, group)
        args = (inputs, group)
        outs_q8 = conv_chain_q8.conv_group_q8(*args)
        conv_chain_q8.launch_conv = lambda *a, **k: None
        try:
            k_ms = cuda_ms(lambda: conv_chain_q8.conv_group_q8(*args), 5)
        finally:
            conv_chain_q8.launch_conv = skip_bf16
        blocks = conv_chain_q8.conv_group_q8(inputs, _emit_all(group))
        yard_ms = cuda_ms(_bf16_conv_like_q8(inputs, group, blocks), 5)
        nbytes, ops = _q8_cost(inputs, group, outs_q8)
        bound, by = add("conv_group_q8", k_ms, p_ms, nbytes, ops,
                        PEAK_FLOPS[torch.int8], None)
        per["conv_group_q8"]["yard_ms"] = per["conv_group_q8"].get("yard_ms", 0.0) + yard_ms
        shape = tuple(inputs[0].shape)
        print(f"time conv_group_q8 w8a8_enc_ctx {shape} ({group.n_int8} int8 convs): kernel "
              f"{k_ms:.4f} ms ({ops / k_ms / 1e9:.1f} TOP/s, {100 * bound / k_ms:.2f}% of "
              f"bound), plain {p_ms:.4f} ms, library none (bf16 cuDNN conv of the same "
              f"shapes {yard_ms:.4f} ms), bound {bound:.4f} ms ({by}; {nbytes} B, "
              f"{ops} op) [{card}]")
    for kind in ("conv_group", "conv_group_q8"):
        p = per[kind]
        staged = (f", staged kernel (PR 5) {p['staged_ms']:.4f} ms" if "staged_ms" in p
                  else "")
        print(f"time {kind} sum over the "
              f"{'bf16 forward' if kind == 'conv_group' else 'w8a8_enc_ctx forward encoder and context'}"
              f"'s groups: kernel {p['ms']:.4f} ms{staged}, bound "
              f"{p['bound_ms']:.4f} ms ({100 * p['bound_ms'] / p['ms']:.2f}% of bound), "
              f"cuDNN {p.get('yard_ms', p['library_ms']):.4f} ms [{card}]")
    _tma_conv_timing(card, recorded[torch.bfloat16], max_err, per)
    _q8_tma_conv_timing(card, recorded["w8a8"], max_err, per)
    for name, r in gemm_res.items():
        same = r["library_same_output_ms"]
        print(f"time gemm_probe {name} {spike_int8.SIZE}^3 (calls queued behind a spin "
              f"kernel): kernel {r['ms']:.4f} ms ({r['tops']:.1f} TOP/s, "
              f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound), library {r['library_ms']:.4f} "
              f"ms ({r['library_tops']:.1f} TOP/s)"
              + (f", library with the kernel's fp32 output {same:.4f} ms" if same else "")
              + f", plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), the output written alone {r['store_ms']:.4f} ms, host "
              f"issue {r['host_us']:.1f} us a call [{card}]")

    # end to end in turns: bf16, W8A8, W8A8, bf16
    e2e = {"bf16": [], "w8a8": []}
    for path in ("bf16", "w8a8", "w8a8", "bf16"):
        e2e[path].append(measure(model_b, xb, scales["w8a8"] if path == "w8a8" else None))
    for path, runs in e2e.items():
        each = [r["ms_per_batch"] for r in runs]
        ms = sum(each) / len(each)
        print(f"e2e {path} fast_apply B={BATCH} {HEIGHT}x{WIDTH}: {ms:.3f} ms/batch, "
              f"{BATCH * 1e3 / ms:.2f} pairs/s (runs {each} ms) [{card}]")

    # 8. training (the serving records freed first)
    del recorded, outs, out_f, ref, model, model_b, x32, xb
    torch.cuda.empty_cache()
    failures = []
    launches.update(_train_phase(card, max_err, per, add, failures))
    if failures:
        raise AssertionError("; ".join(failures))

    # 9. the FlowNetC family, d=10
    fnetc_launches, d10, d10_bwd = _flownetc_phase(card, tf32_defaults)
    launches.update(fnetc_launches)

    # 10. the training system: loaders, fit, evaluate, a checkpoint restore
    launches.update(_fit_phase(card))

    # 11. the file-backed data path and the serving and eval CLIs; 12. the
    # cost volume at every d, supervised training, the new nets served (on
    # phase 11's Sintel tree); 13. the unsupervised zoo: the step on the nets
    # with a cost volume, the CLI on FlowNetC, the nets without a kernel
    # served; 14. the cost volume past d = 10, the inpainting slice (on phase
    # 11's trees)
    p12, p14 = {}, {}

    def after_files(trees):
        found, p12["per_d"], p12["step_ms"] = _phase12(card, max_err, trees)
        found.update(_phase13(card, max_err))
        more, p14["per_d"], p14["records"] = _phase14(card, max_err, trees)
        found.update(more)
        return found

    launches.update(_files_phase(card, max_err, then=after_files))

    # 15. the gated-conv GAN at the flagship config's width; 16. the
    # two-stage pipelines, the joint step, the VGG loss, FID (on phase 15's
    # exported generator)
    import tempfile

    with tempfile.TemporaryDirectory() as keep:
        generator = f"{keep}/generator"
        gan_launches, _ = _phase15(card, keep=generator)
        launches.update(gan_launches)
        more, p16 = _phase16(card, max_err, generator)
        launches.update(more)

    # 17. trained weights from original checkpoints, imported and served;
    # JPEG and interlaced PNG frames
    more, _ = _phase17(card, max_err)
    launches.update(more)

    # 18. data parallelism: two gloo ranks sharing the card; 19. global
    # batch statistics, every regime's step in the same ranks
    more, p18 = _phase18(card, max_err)
    launches.update(more)
    more, _ = _phase19(card, p18["ranks"], p18["processes"]["gs_cli"])
    launches.update(more)

    # per kernel: its source, the TPU kernel it replaces, and the path whose
    # calls its times sum (its "launches" are that path's count)
    meta = {
        "cost_volume": ("ocflow_torch/csrc/cost_volume.cu",
                        "ocflow_tpu/ops/pallas/cost_volume_kernel.py:91", "bf16"),
        "cost_volume_bwd": ("ocflow_torch/csrc/cost_volume_bwd.cu",
                            "ocflow_tpu/ops/pallas/cost_volume_kernel.py:187", "train"),
        "conv_group": ("ocflow_torch/csrc/conv_group.cu",
                       "ocflow_tpu/ops/pallas/conv_chain_kernel.py:463", "bf16"),
        # the TMA kernel's own launches on the bf16 forward (a part of
        # conv_group's), each timed alone
        "conv_group_tma": ("ocflow_torch/csrc/conv_group_tma.cu",
                           "ocflow_tpu/ops/pallas/conv_chain_kernel.py:463", "bf16"),
        # the forward: all 31 convs of the bf16 step on the TMA kernel
        "conv_group_diff": ("ocflow_torch/csrc/conv_group_tma.cu",
                            "ocflow_tpu/ops/pallas/conv_chain_kernel.py:1198", "train"),
        # the opt-in forward's encoder and context groups only
        "conv_group_q8": ("ocflow_torch/csrc/conv_group_q8.cu",
                          "ocflow_tpu/ops/pallas/conv_chain_kernel.py:943", "w8a8_enc_ctx"),
        # every int8 conv of the W8A8 forward's decoders, each timed alone
        "conv_group_q8_tma": ("ocflow_torch/csrc/conv_group_q8_tma.cu",
                              "ocflow_tpu/ops/pallas/conv_chain_kernel.py:943", "w8a8"),
        "gemm_probe": ("ocflow_torch/csrc/gemm_probe.cu", "tools/spike_int8.py:92",
                       "spike_int8"),
    }
    for p in per.values():
        p["bound_by"] = "bytes" if p["bytes_ms"] >= p["ops_ms"] else "operations"
    # conv_group_diff's backward on its two kernels, over the bf16 step's
    # groups: launches of the train path, the kernels' device time queued,
    # library = cuDNN's autograd over the concat (host's clock); beside
    # them the whole backward on the host's clock and queued, the VJP route
    q, tr = per.pop("conv_group_diff_bwd"), launches["train"]
    bwd_entry = {
        "name": "conv_group_diff_bwd", "route": "cuda",
        "source": "ocflow_torch/csrc/conv_group_dw.cu",
        "sources": ["ocflow_torch/csrc/conv_group_tma.cu", "ocflow_torch/csrc/conv_group_dw.cu"],
        "replaces": "ocflow_tpu/ops/pallas/conv_chain_kernel.py:1258", "path": "train",
        "launches": tr["conv_group_diff_dx"] + tr["conv_group_diff_dw"],
        "launches_dx": tr["conv_group_diff_dx"], "launches_dw": tr["conv_group_diff_dw"],
        "vjp_calls": tr["conv_group_diff_vjp"],
        "max_abs_err": max_err["conv_group_diff_bwd"], "ms": q["ms"],
        "plain_ms": q["plain_ms"], "bound_ms": q["bound_ms"], "bound_by": q["bound_by"],
        "library_ms": q["library_ms"],
        **{k: q[k] for k in ("dx_ms", "dw_ms", "host_ms", "queued_ms", "vjp_ms",
                             "adjoint_pack_ms")}}
    per["gemm_probe"] = gemm_res["int8"]
    max_err["gemm_probe"] = gemm_res["int8"]["max_abs_err"]
    kernels = []
    for name, (source, replaces, path) in meta.items():
        p = per[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "path": path, "launches": launches[path][name],
            "launches_by_path": {k: c[name] for k, c in launches.items() if name in c},
            **({"staged_launches_by_path": {k: c[f"{name}_staged"]
                                            for k, c in launches.items()}}
               if name in ("conv_group", "conv_group_q8") else {}),
            "max_abs_err": max_err[name], "ms": p["ms"],
            "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
            "bound_by": p["bound_by"],
            "library_ms": p["library_ms"] if name in (
                "conv_group", "conv_group_diff", "conv_group_tma", "gemm_probe") else None,
            **({"library_reason": NO_LIBRARY[name]} if name in NO_LIBRARY else {}),
            **{k: p[k] for k in ("bwd_ms", "library_bwd_ms", "bwd_bound_ms", "yard_ms",
                                 "staged_ms", "tma_ms", "pack_ms", "bf16_tma_ms",
                                 "cudnn_ms") if k in p},
        })
        if name == "gemm_probe":
            # the numbers above are int8's; bf16's beside them
            kernels[-1].update({f"{k}_bf16": v for k, v in gemm_res["bfloat16"].items()
                                if k not in ("max_abs_err", "tops", "library_tops")},
                               max_abs_err_bf16=gemm_res["bfloat16"]["max_abs_err"])
        if name == "cost_volume":
            # the numbers above are the d=4 calls of the bf16 forward; the
            # d=10 call of one FlowNetC forward, fp32, beside them
            kernels[-1].update(d=4, **{f"{k}_d10": v for k, v in d10.items()})
        if name == "cost_volume_bwd":
            # the d=4 calls of the bf16 step; the d=10 call of FlowNetC's
            # input gradient, fp32, beside them
            kernels[-1].update(d=4, launches_d10=launches["flownetc_grad"][name],
                               **{f"{k}_d10": v for k, v in d10_bwd.items()})
        if name in ("cost_volume", "cost_volume_bwd"):
            # every d built; phase 12's other d: [ms, bound_ms, bound_by]
            # per dtype at each of CV_NEW_SHAPES
            kernels[-1].update(displacements=list(cv_mod.FORWARD_DISPLACEMENTS),
                               other_d={"shapes": CV_NEW_SHAPES, **p12["per_d"][name]})
            # phase 16: the 5 calls of one bf16 joint step (B=16, 320x1216),
            # summed
            kernels[-1].update({f"{k}_joint_bf16": v
                                for k, v in p16["joint"]["per_call"][name].items()})
    kernels.append(bwd_entry)
    # the general kernels (d > 10): their path is a FlowNetC built with
    # displacement 12 (forward and input gradient); times at its fp32
    # 8x256x56x128 call; the other d and shapes beside them
    path = f"flownetc_d{CV_FLOWNETC_D}"
    pwc_path = f"supervised_pwc_d{PWC_GENERAL_D}"
    for name, source_line in (("cost_volume_general", 91), ("cost_volume_bwd_general", 187)):
        rec = p14["records"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": "ocflow_torch/csrc/cost_volume_any.cu",
            "replaces": f"ocflow_tpu/ops/pallas/cost_volume_kernel.py:{source_line}",
            "path": path, "launches": launches[path][name], "d": CV_FLOWNETC_D,
            "launches_by_path": {p: launches[p][name] for p in (path, pwc_path)},
            "pwc_step": p14["records"]["pwc_step"],
            "max_abs_err": max_err[name], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"], "library_ms": None,
            "library_reason": NO_LIBRARY["cost_volume" if "bwd" not in name
                                         else "cost_volume_bwd"],
            "other_d": {"shapes": CV_NEW_SHAPES, **p14["per_d"][name]}})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
