"""The port's serving and evaluation CLIs, ``python -m ocflow_torch.infer``
and ``python -m ocflow_torch.evaluate``, on the CPU, against the JAX
package's pieces on the same weights (carried across by the
``*_from_flax`` bridges into a port checkpoint) and the same files.

- ``evaluate --task flow --model pwc`` on a mini-Sintel tree (64x128 after
  the floor-64 crop, batches of 3 and a ragged 1) gives the EPE of the JAX
  pipeline: ``ocflow_tpu`` dataset -> ``DataLoader`` -> ``net.apply`` ->
  ``metrics.evaluate_flow``, within 1e-4 relative; likewise ``--task
  flow_occ --model flowoccnetc`` on ``MpiSintelFlowOccClean``, EPE and
  occlusion F1;
- ``infer --save_flo`` writes ``.flo`` files equal to the port's
  ``fast_apply`` on those pairs and PNGs equal to ``flow_to_image`` of
  them; with ``--q8`` the scales come from the first pair;
- what is not ported raises, naming its ROADMAP item.
"""

import os

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocflow_torch import evaluate as tevaluate
from ocflow_torch import infer as tinfer
from ocflow_torch.data import read_flo
from ocflow_torch.models import (FlowNetCV, calibrate_q8, fast_apply, flownetcv_from_flax,
                                 flowoccnetc_from_flax, load_model)
from ocflow_torch.utils.checkpoint import save_pytree
from ocflow_torch.utils.viz import flow_to_image
from ocflow_tpu import data as jdata
from ocflow_tpu import metrics as jmetrics
from ocflow_tpu.models import flow_occ_nets as jfon
from ocflow_tpu.models import pwc_net as jpwc
from test_data import make_mini_sintel
from test_torch_ops import share_cores  # noqa: F401  (autouse)

REL_TOL = 1e-4


@pytest.fixture(scope="module")
def sintel(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sintel"))
    make_mini_sintel(root)
    return root


def _checkpoint(path, state_dict):
    save_pytree(path, {"params": state_dict})
    return path


def _jax_epe(net, variables, root, name, batch_size, occ=False):
    loader = jdata.DataLoader(jdata.build_dataset(name, root=root), batch_size,
                              drop_last=False)
    apply = jax.jit(lambda v, x: net.apply(v, x))
    epes, f1s = [], []
    for batch in loader:
        out = apply(variables, jnp.asarray(batch["images"]))
        out = out if isinstance(out, tuple) else (out, None)
        epes.append(float(jmetrics.evaluate_flow(jnp.asarray(batch["flow"]), out[0])))
        if occ:
            f1s.append(float(jmetrics.occlusion_f1(out[1], jnp.asarray(batch["occ"]))))
    return float(np.mean(epes)), (float(np.mean(f1s)) if occ else None)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def test_evaluate_flow_pwc_matches_jax(sintel, tmp_path):
    net = jpwc.FlowNetCV()
    variables = jax.jit(net.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 128, 6)))
    ckpt = _checkpoint(str(tmp_path / "pwc.ckpt"), flownetcv_from_flax(variables["params"]))
    got = tevaluate.main(["--device", "cpu", "--task", "flow", "--model", "pwc",
                          "--dataset", "MpiSintelClean", "--root", sintel,
                          "--batch_size", "3", "--checkpoint", ckpt])
    ref, _ = _jax_epe(net, variables, sintel, "MpiSintelClean", 3)
    assert set(got) == {"epe"} and _rel(got["epe"], ref) <= REL_TOL, (got, ref)


def test_evaluate_flow_occ_flowoccnetc_matches_jax(sintel, tmp_path):
    net = jfon.FlowOccNetC()
    variables = jax.jit(net.init)(jax.random.PRNGKey(1), jnp.zeros((1, 64, 128, 6)))
    ckpt = _checkpoint(str(tmp_path / "foc.ckpt"), flowoccnetc_from_flax(variables))
    got = tevaluate.main(["--device", "cpu", "--task", "flow_occ", "--model",
                          "flowoccnetc", "--dataset", "MpiSintelFlowOccClean",
                          "--root", sintel, "--checkpoint", ckpt])
    ref_epe, ref_f1 = _jax_epe(net, variables, sintel, "MpiSintelFlowOccClean", 8, occ=True)
    assert set(got) == {"epe", "occlusion_f1"}
    assert _rel(got["epe"], ref_epe) <= REL_TOL, (got, ref_epe)
    assert _rel(got["occlusion_f1"], ref_f1) <= REL_TOL, (got, ref_f1)


@pytest.mark.parametrize("q8", [False, True])
def test_infer_writes_fast_apply_flows(sintel, tmp_path, q8):
    frames = os.path.join(sintel, "clean", "scene_1")
    out = str(tmp_path / "out")
    argv = ["--device", "cpu", "--input", frames, "--output", out, "--save_flo"]
    written = tinfer.main(argv + (["--q8"] if q8 else []))
    ds = jdata.build_dataset("ImagesFromFolder", root=frames)  # the JAX package's pairs
    assert written == [os.path.join(out, f"flow_{i:05d}.{ext}")
                       for i in range(len(ds)) for ext in ("png", "flo")]
    model = load_model("flow", "pwc", "", "cpu")
    scales = None
    for i in range(len(ds)):
        x = torch.from_numpy(ds[i]["images"])[None]
        if q8 and i == 0:
            scales = calibrate_q8(model, x, device="cpu")
        flow = fast_apply(model, x, q8=scales, device="cpu")[0][0].numpy()
        got = read_flo(os.path.join(out, f"flow_{i:05d}.flo"))
        assert got.shape == (64, 128, 2) and np.array_equal(got, flow)
        assert np.array_equal(imageio.imread(os.path.join(out, f"flow_{i:05d}.png")),
                              flow_to_image(flow))


def test_infer_eager_family_and_checkpoint(sintel, tmp_path):
    """``--model flownetc`` serves the eager module in eval mode; a
    checkpoint's ``params`` replace the seeded weights."""
    frames = os.path.join(sintel, "clean", "scene_0")
    model = FlowNetCV(generator=torch.Generator().manual_seed(5))
    ckpt = _checkpoint(str(tmp_path / "pwc.ckpt"), model.state_dict())
    out = str(tmp_path / "a")
    tinfer.main(["--device", "cpu", "--input", frames, "--output", out, "--save_flo",
                 "--checkpoint", ckpt])
    x = torch.from_numpy(jdata.build_dataset("ImagesFromFolder", root=frames)[0]["images"])
    ref = fast_apply(model, x[None], device="cpu")[0][0].numpy()
    assert np.array_equal(read_flo(os.path.join(out, "flow_00000.flo")), ref)
    written = tinfer.main(["--device", "cpu", "--input", frames, "--output",
                           str(tmp_path / "b"), "--model", "flownetc"])
    assert len(written) == 2 and all(p.endswith(".png") for p in written)
    assert imageio.imread(written[0]).shape == (64, 128, 3)


def test_clis_refuse_what_is_not_ported(sintel, tmp_path, capsys):
    # --task inpainting runs, the gated-conv generators too
    # (tests/test_torch_inpaint_cli.py, tests/test_torch_gan_cli.py); so does
    # --with_fid, on random Inception features only with --allow_random_fid
    # (tests/test_torch_fid*.py)
    with pytest.raises(SystemExit):
        tevaluate.main(["--device", "cpu", "--with_fid"])
    assert "--allow_random_fid" in capsys.readouterr().err
    fid = tevaluate.main(["--device", "cpu", "--task", "inpainting", "--model", "simple",
                          "--dataset", "MpiSintelCleanInpainting", "--root", sintel,
                          "--with_fid", "--allow_random_fid"])
    assert set(fid) == {"psnr", "ssim", "fid"} and np.isfinite(fid["fid"])
    with pytest.raises(ValueError, match="unknown model 'ocflownet' in family 'flow'"):
        tevaluate.main(["--device", "cpu", "--model", "ocflownet", "--dataset",
                        "MpiSintelClean", "--root", sintel])
    with pytest.raises(ValueError, match="pwc"):
        tinfer.main(["--device", "cpu", "--input", sintel, "--model", "flownetc", "--q8"])
    assert "PERF.md" in tinfer.Q8_HELP and "%" not in tinfer.Q8_HELP


def test_clis_run_on_cuda_unless_told(sintel, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        tevaluate.main(["--dataset", "MpiSintelClean", "--root", sintel])
    with pytest.raises(RuntimeError, match="CUDA"):
        tinfer.main(["--input", sintel, "--output", str(tmp_path)])


def test_evaluate_on_a_procedural_dataset():
    """``--dataset SyntheticFlow`` takes ``--dataset_size``,
    ``--dataset_seed`` and ``--image_size`` (generated on the run's
    device), as the JAX CLI's procedural datasets do."""
    argv = ["--device", "cpu", "--dataset", "SyntheticFlow", "--dataset_size", "3",
            "--image_size", "64", "128", "--batch_size", "2"]
    a = tevaluate.main(argv + ["--dataset_seed", "1"])
    b = tevaluate.main(argv + ["--dataset_seed", "2"])
    assert set(a) == {"epe"} and np.isfinite(a["epe"]) and a["epe"] != b["epe"]
