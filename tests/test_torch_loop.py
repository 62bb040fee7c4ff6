"""The port's training system against ``ocflow_tpu``'s, on the CPU.

- ``CsvLogger``: the same bytes as the JAX package's on the same rows,
  the header extension included;
- flow metrics against ``ocflow_tpu.metrics.flow_metrics`` within 1e-6
  relative (fp32 sums in another order);
- ``flow_to_image`` and the panels equal the JAX package's bit for bit,
  the PNG writer's files decode (imageio) to the same pixels;
- the whole slice: the port's ``fit`` against ``ocflow_tpu.train.loop.fit``
  with the same weights, data, splits and shuffles (bound at the test);
- ``fit`` stops on a non-finite loss;
- no module of the port imports JAX, OpenCV, PyYAML, imageio or PIL.
"""

import csv
import re
import subprocess
import sys
from pathlib import Path

import imageio.v2 as imageio
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ocflow_torch.metrics import flow_metrics as tmetrics
from ocflow_torch.models import FlowNetCV
from ocflow_torch.train import config as tconfig
from ocflow_torch.train import create_train_state, loop as tloop, make_unsupervised_flow_step
from ocflow_torch.utils import checkpoint as tckpt
from ocflow_torch.utils import panels as tpanels
from ocflow_torch.utils import png, viz
from ocflow_tpu.metrics import flow_metrics as jmetrics
from ocflow_tpu.models import pwc_net as jpwc
from ocflow_tpu.models.torch_convert import convert_flownetcv
from ocflow_tpu.parallel.mesh import make_mesh
from ocflow_tpu.train import TrainState as JTrainState
from ocflow_tpu.train import config as jconfig
from ocflow_tpu.train import loop as jloop
from ocflow_tpu.train import steps as jsteps
from ocflow_tpu.utils import checkpoint as jckpt
from ocflow_tpu.utils import panels as jpanels
from ocflow_tpu.utils import viz as jviz
from test_torch_ops import share_cores  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
METRIC_REL = 1e-6

ROWS = [
    ("train", 0, 0, {"loss": np.float32(0.9703344702720642), "epe": 16.85,
                     "images_per_sec": 0.0}),
    ("train", 4, 0, {"loss": 0.5, "epe": np.float32(1e-7), "images_per_sec": 17.459526}),
    ("val", 16, 0, {"loss": 0.8771848678588867, "epe": 13.7}),
    ("val", 32, 1, {"loss": 0.1, "epe": 2.0, "d_loss": 3.25}),   # a new key
    ("train", 48, 2, {"loss": 0.25, "epe": 1.5, "images_per_sec": 1.0, "g": -0.0}),
]


def test_csv_logger_bytes_equal_jax(tmp_path):
    port, ref = tmp_path / "port" / "m.csv", tmp_path / "jax" / "m.csv"
    pl, jl = tloop.CsvLogger(str(port)), jloop.CsvLogger(str(ref))
    for phase, step, epoch, metrics in ROWS:
        pl.row(phase, step, epoch, metrics)
        jl.row(phase, step, epoch, metrics)
    assert port.read_bytes() == ref.read_bytes()
    assert port.read_text().splitlines()[0] == "phase,step,epoch,d_loss,epe,g,images_per_sec,loss"
    tloop.CsvLogger("").row("train", 0, 0, {"loss": 1.0})  # no path: no file, no error


def _flows(seed=0, b=3, h=9, w=11):
    rng = np.random.default_rng(seed)
    gt = rng.normal(size=(b, h, w, 2)).astype(np.float32) * 5
    gt[0, 0, 0, 0] = 2e7  # unknown flow, left out
    pred = (gt + rng.normal(size=gt.shape).astype(np.float32)).astype(np.float32)
    occ = (rng.uniform(size=(b, h, w)) > 0.7).astype(np.float32)
    valid = (rng.uniform(size=(b, h, w, 1)) > 0.3).astype(np.float32)
    return gt, pred, occ, valid


def _close(port, ref):
    np.testing.assert_allclose(np.asarray(port, np.float64), np.asarray(ref, np.float64),
                               rtol=METRIC_REL, atol=0)


@pytest.mark.parametrize("fn", ["flow_error", "evaluate_flow", "flow_kitti_error",
                                "evaluate_kitti_flow", "occlusion_f1",
                                "calculate_average_epe"])
def test_flow_metrics_match_jax(fn):
    gt, pred, occ, valid = _flows()
    t, j = torch.from_numpy, jnp.asarray
    if fn == "flow_error":
        for o in (None, occ[1]):
            args = (gt[1, ..., 0], gt[1, ..., 1], pred[1, ..., 0], pred[1, ..., 1])
            _close(tmetrics.flow_error(*map(t, args), occ=None if o is None else t(o)),
                   jmetrics.flow_error(*map(j, args), occ=None if o is None else j(o)))
    elif fn == "evaluate_flow":
        _close(tmetrics.evaluate_flow(t(gt), t(pred)), jmetrics.evaluate_flow(j(gt), j(pred)))
        _close(tmetrics.evaluate_flow(t(gt[0]), t(pred[0]), t(occ[0])),
               jmetrics.evaluate_flow(j(gt[0]), j(pred[0]), j(occ[0])))
    elif fn == "flow_kitti_error":
        args = (gt[2, ..., 0], gt[2, ..., 1], pred[2, ..., 0], pred[2, ..., 1])
        for port, ref in zip(tmetrics.flow_kitti_error(*map(t, args), mask=t(valid[2, ..., 0])),
                             jmetrics.flow_kitti_error(*map(j, args), mask=j(valid[2, ..., 0]))):
            _close(port, ref)
    elif fn == "evaluate_kitti_flow":
        g3 = np.concatenate([gt[1], valid[1]], -1)
        for g in (gt[1], g3):
            for port, ref in zip(tmetrics.evaluate_kitti_flow(t(g), t(pred[1])),
                                 jmetrics.evaluate_kitti_flow(j(g), j(pred[1]))):
                _close(port, ref)
    elif fn == "occlusion_f1":
        p = np.random.default_rng(1).uniform(size=occ.shape).astype(np.float32)
        _close(tmetrics.occlusion_f1(t(p), t(occ)), jmetrics.occlusion_f1(j(p), j(occ)))
    else:
        batches = [{"images": gt[:2], "flow": gt[:2]}, {"images": gt[2:], "flow": gt[2:]}]
        shift = pred - gt
        _close(tmetrics.calculate_average_epe(
                   lambda x: x + t(shift[:x.shape[0]]),
                   [{k: t(v) for k, v in b.items()} for b in batches]),
               jmetrics.calculate_average_epe(lambda x: x + shift[:x.shape[0]], batches))


def test_flow_to_image_and_panels_equal_jax():
    gt, pred, _, _ = _flows(seed=3, b=2)
    pred[0, 1, 1] = np.nan
    assert np.array_equal(viz.flow_to_image(pred[0]), jviz.flow_to_image(pred[0]))
    assert np.array_equal(viz.make_color_wheel(), jviz.make_color_wheel())
    rng = np.random.default_rng(4)
    img1, img2, warped = (rng.uniform(-1.2, 1.2, (9, 11, 3)).astype(np.float32)
                          for _ in range(3))
    assert np.array_equal(tpanels.flow_panel(img1, img2, pred[1], gt[1]),
                          jpanels.flow_panel(img1, img2, pred[1], gt[1]))
    assert np.array_equal(tpanels.warp_panel(img1, img2, warped, pred[1]),
                          jpanels.warp_panel(img1, img2, warped, pred[1]))


@pytest.mark.parametrize("shape", [(1, 1, 3), (7, 13, 3), (64, 33, 3)])
def test_png_writer_decodes_with_imageio(tmp_path, shape):
    img = np.random.default_rng(shape[1]).integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "x.png")
    png.write_png(path, img)
    back = imageio.imread(path)
    assert back.dtype == np.uint8 and back.shape == shape
    assert np.array_equal(back, img)
    with pytest.raises(ValueError):
        png.encode_png(img.astype(np.float32))


def test_summary_logger_writes_png_images(tmp_path):
    """TensorBoard image summaries carry the PNG writer's bytes (no PIL),
    read back by TensorBoard's own event reader."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    img = np.random.default_rng(0).integers(0, 256, (12, 9, 3), dtype=np.uint8)
    logger = tloop.SummaryLogger(str(tmp_path / "tb"))
    logger.scalar("loss", np.float32(0.5), 3)
    logger.image("val/warp", img, 4)
    logger.close()
    events = EventAccumulator(str(tmp_path / "tb"))
    events.Reload()
    (image,) = events.Images("val/warp")
    assert (image.step, image.width, image.height) == (4, 9, 12)
    assert image.encoded_image_string == png.encode_png(img)
    assert [(e.step, e.value) for e in events.Scalars("loss")] == [(3, 0.5)]


# ---------------------------------------------------------------------------
# the whole slice: fit against ocflow_tpu.train.loop.fit

FIT = {"network_type": "flow", "model": "pwc", "dataset_name": "SyntheticFlowWarp",
       "dataset_size": 16, "image_size": [64, 128], "batch_size": 4, "num_workers": 0,
       "device_cache": True, "max_epochs": 2, "patience": 1000,
       "photo_weight": 4.0, "smooth1_weight": 0.5, "smooth2_weight": 0.0,
       "occ_aware": True, "occ_method": "range_map", "occ_resolution": "full",
       "compute_dtype": "float32", "fast_forward": "both", "log_every_n_steps": 1}
# Every CSV metric of the port's fit against the JAX fit's, relative, per
# learning rate. The two run the same data, splits, shuffles and weights.
# At lr 0 only the loop's own arithmetic differs (the steps' forward sums):
# measured <= 7.7e-6 over the 6 train and 2 val rows. With updates the
# trajectories part: Adam moves every weight by about lr whatever |grad|,
# so a near-zero gradient whose sign the summation order decides moves a
# weight by 2 lr the other way, and the early, chaotic training amplifies
# that step by step. Measured at lr 1e-6: 1.2e-4 (val, step 6); at 1e-5:
# 7.0e-3; at the config's 1e-4: 0.58 (flow_error, step 6), where the port
# against itself with its weights scaled by 1 + 1e-7 N(0, 1) drifts to 0.16
# by the same step: the dynamics, not a difference of the two systems. The
# bounds are 2.6x and 4x the measured drift.
FIT_REL = {0.0: 2e-5, 1e-6: 5e-4}


def _outputs(tmp_path, name):
    d = tmp_path / name
    return {"metrics_csv": str(d / "metrics.csv"), "log_dir": str(d / "tb"),
            "checkpoint_dir": str(d / "ckpt"), "result_dir": str(d)}


def _read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("lr", sorted(FIT_REL))
def test_fit_matches_jax_fit(tmp_path, lr):
    """FlowNetCV fp32, fused forward, range-map occlusion, 16
    SyntheticFlowWarp samples at 64x128 (12 / 1 / 3), B=4, 2 epochs, every
    step logged: the CSVs' rows and columns equal, each metric within
    ``FIT_REL[lr]``, the same epoch saved as best."""
    model = FlowNetCV(generator=torch.Generator().manual_seed(0))
    variables = convert_flownetcv(model.state_dict())
    fit = {**FIT, "learning_rate": lr}

    jcfg = jconfig.config_from_dict({**fit, **_outputs(tmp_path, "jax")})
    jtrain, jval, _ = jloop.make_loaders(jcfg)
    jstate = JTrainState.create(apply_fn=jpwc.FlowNetCV().apply,
                                params=variables["params"], tx=optax.adam(lr))
    jtrain_step, jeval_step = jsteps.make_unsupervised_flow_step(jcfg.as_hparams())
    # one device: the default mesh over the 8 virtual CPU devices would
    # shard the batch and pad the ragged val batch
    jloop.fit(jcfg, jstate, jtrain_step, jeval_step, jtrain, jval, mesh=make_mesh((1,)))

    cfg = tconfig.config_from_dict({**fit, **_outputs(tmp_path, "port")})
    train, val, _ = tloop.make_loaders(cfg, "cpu")
    state = create_train_state(model, cfg.learning_rate, device="cpu")
    train_step, eval_step = make_unsupervised_flow_step(cfg.as_hparams())
    state = tloop.fit(cfg, state, train_step, eval_step, train, val)
    assert state.step == 6

    port, ref = _read_csv(cfg.metrics_csv), _read_csv(jcfg.metrics_csv)
    assert list(port[0]) == list(ref[0])
    assert [(r["phase"], r["step"], r["epoch"]) for r in port] == \
        [(r["phase"], r["step"], r["epoch"]) for r in ref]
    assert [r["phase"] for r in port].count("train") == 6
    drift = {}
    for p, r in zip(port, ref):
        for k in r:
            if k in ("phase", "step", "epoch", "images_per_sec") or r[k] == "":
                continue
            rel = abs(float(p[k]) - float(r[k])) / abs(float(r[k]))
            drift[(p["phase"], p["step"], k)] = rel
    worst = max(drift, key=drift.get)
    assert drift[worst] <= FIT_REL[lr], (worst, drift[worst])
    assert tckpt.CheckpointManager(cfg.checkpoint_dir).best_step == \
        jckpt.CheckpointManager(jcfg.checkpoint_dir).best_step


def test_fit_stops_on_a_non_finite_loss(tmp_path):
    cfg = tconfig.config_from_dict({**FIT, "dataset_size": 10, "image_size": [64, 64],
                                    **_outputs(tmp_path, "nan")})
    train, val, _ = tloop.make_loaders(cfg, "cpu")
    state = create_train_state(FlowNetCV(), cfg.learning_rate, device="cpu")

    def nan_step(st, batch):
        st.step += 1
        return st, {"loss": torch.tensor(float("nan")), "epe": torch.tensor(1.0)}

    with pytest.raises(FloatingPointError, match="step 0"):
        tloop.fit(cfg, state, nan_step, nan_step, train, val)


def test_port_imports_no_jax_opencv_yaml_imageio_or_pil():
    code = (
        "import pkgutil, importlib, sys, ocflow_torch\n"
        "for m in pkgutil.walk_packages(ocflow_torch.__path__, 'ocflow_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
        "       'ocflow_tpu', 'cv2', 'yaml', 'imageio', 'PIL', 'orbax')]\n"
        "assert not bad, bad\n"
        "new = ('ocflow_torch.data.native_io', 'ocflow_torch.data.flow_io',\n"
        "       'ocflow_torch.data.frame_io', 'ocflow_torch.data.resize',\n"
        "       'ocflow_torch.infer', 'ocflow_torch.evaluate')\n"
        "assert all(m in sys.modules for m in new), new\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|ocflow_tpu|cv2|yaml|imageio|PIL|orbax)\b"
        r"|import_module\(\s*['\"](jax|flax|ocflow_tpu|cv2|yaml|imageio|PIL)", re.M)
    files = sorted((REPO / "ocflow_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders
