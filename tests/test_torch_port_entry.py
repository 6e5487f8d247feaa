"""The port's entry points on the CPU: closed-loop evaluation, the server,
the configuration, the data copies, and the package's isolation from JAX.

Every entry point is asked for the CPU with ``device="cpu"``; the shapes
are cut to a few images and a 32³ IoU so the file runs in seconds.
"""

import base64
import os
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from sqtpu.data import bmp as jbmp
from sqtpu.data import labels as jlabels
from sqtpu_torch.data import bmp as tbmp
from sqtpu_torch.data import labels as tlabels
from sqtpu_torch.evaluate import eval_random, load_eval_state, predict
from sqtpu_torch.ops.render import render_depth_hard_batch
from sqtpu_torch.serve import ServeClient, SQServer
from sqtpu_torch.utils.config import (
    EvalConfig, ServeConfig, parse_cli, resolve_device,
)

from test_torch_port_ops import _few_torch_threads  # noqa: F401


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "artifacts", "resnet_sq_c4_fp16.npz")
TRUTHS = os.path.join(ROOT, "runs", "eval_c4c3", "accs.npz")


# ---- closed-loop evaluation -------------------------------------------

def test_eval_random_on_cpu(tmp_path, capsys):
    cfg = EvalConfig(ckpt_dir=WEIGHTS, n=4, batch_size=2, acc_render_size=32,
                     device="cpu", out_dir=str(tmp_path))
    res = eval_random(cfg)
    out = capsys.readouterr().out
    assert "--Full::" in out and "--Rot::" in out
    with np.load(tmp_path / "accs.npz") as got, np.load(TRUTHS) as rec:
        assert set(got.files) == set(rec.files)  # the JAX package's keys
        assert got["true_params"].shape == got["pred_params"].shape == (4, 12)
        assert np.isfinite(got["pred_params"]).all()
        np.testing.assert_allclose(got["full_iou"].mean(),
                                   res["full_iou_mean"], rtol=1e-6)
    assert res["full_iou_mean"] > 0.7  # trained weights, not noise
    log = (tmp_path / "results.txt").read_text()
    assert log.count("---------- Example") == 4


@pytest.mark.parametrize("option", [
    {"iso": True}, {"model": "resnet_sq6d"}])
def test_eval_options_of_slice_f_run(option, tmp_path):
    """Options the slice gate refused until Slice F: the isometric view
    (c4's weights on it) and the 6D model (random weights, seeded):
    ``eval_random`` n=2 each."""
    ckpt = WEIGHTS if "iso" in option else str(tmp_path / "none")
    cfg = EvalConfig(ckpt_dir=ckpt, n=2, batch_size=2, acc_render_size=16,
                     device="cpu", out_dir=str(tmp_path), **option)
    res = eval_random(cfg)
    assert np.isfinite(res["full_iou_mean"])
    with np.load(tmp_path / "accs.npz") as d:
        q = d["true_params"][:, 8:]
    if "iso" in option:
        np.testing.assert_allclose(q, np.broadcast_to(
            np.array([1, 1, 1, 0]) / np.sqrt(3.0), q.shape), atol=1e-7)


@pytest.mark.parametrize("option", [
    {"noise_gaussian": 0.01}, {"noise_dropout": 0.1}, {"noise_salt": 0.01},
    {"input_filter": "median"}, {"save_pairs": 2}])
def test_options_of_slice_c_run(option, tmp_path):
    """Options the slice gate refused until Slice C (the noise protocol,
    the input filter, the saved pairs): ``eval_random`` n=2 each."""
    cfg = EvalConfig(ckpt_dir=WEIGHTS, n=2, batch_size=2, acc_render_size=16,
                     device="cpu", out_dir=str(tmp_path), **option)
    res = eval_random(cfg)
    assert np.isfinite(res["full_iou_mean"])
    pairs = [f for f in os.listdir(tmp_path) if f.endswith(".bmp")]
    assert len(pairs) == 2 * cfg.save_pairs


def test_serve_model_of_slice_f_runs(tmp_path_factory):
    """The 6D model, refused until Slice F, served (random weights)."""
    sock = str(tmp_path_factory.mktemp("sq") / "s.sock")
    server = SQServer(ServeConfig(ckpt_dir=str(tmp_path_factory.mktemp(
        "none")), model="resnet_sq6d", socket=sock, batch_size=1,
        image_size=32, device="cpu"))
    acceptor = threading.Thread(target=server.serve_forever, daemon=True)
    acceptor.start()
    assert server.ready.wait(30)
    with ServeClient(sock, timeout_s=30) as c:
        resp = c.predict(np.full((32, 32), 100, np.uint8))
        assert np.linalg.norm(resp["params"][8:]) == pytest.approx(1.0,
                                                                   abs=1e-5)
        c.shutdown()
    acceptor.join(timeout=5)
    assert not acceptor.is_alive()


@pytest.mark.parametrize("entry", ["predict_model", "generate_iso",
                                   "single_model"])
def test_bulk_options_of_slice_f_run(entry, tmp_path):
    """What the bulk entry points refused until Slice F: predict and
    evaluate single with the 6D model (random weights), generate with
    the isometric view."""
    from sqtpu_torch.evaluate import eval_single
    from sqtpu_torch.generate import generate
    from sqtpu_torch.predict import predict_files
    from sqtpu_torch.utils.config import GenerateConfig, PredictConfig

    bmp = tmp_path / "x.bmp"
    tbmp.write_bmp(bmp, np.full((32, 32), 100, np.uint8))
    none = str(tmp_path / "none")
    if entry == "predict_model":
        got = predict_files(PredictConfig(ckpt_dir=none, model="resnet_sq6d",
                                          image_size=32, device="cpu"),
                            [str(bmp)])
    elif entry == "generate_iso":
        generate(GenerateConfig(n=2, out=str(tmp_path / "gen"), iso=True,
                                image_size=32, device="cpu"))
        got = tlabels.parse_csv_torch(str(tmp_path / "gen" /
                                          "data_labels.csv"))
        np.testing.assert_allclose(got[:, 8:], np.broadcast_to(
            np.array([1, 1, 1, 0]) / np.sqrt(3.0), (2, 4)), atol=1e-6)
    else:
        got = eval_single(EvalConfig(ckpt_dir=none, model="resnet_sq6d",
                                     image_size=32, device="cpu"), str(bmp))
    got = np.asarray(got).reshape(-1, 12)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(np.linalg.norm(got[:, 8:], axis=-1), 1.0,
                               atol=1e-5)


def test_cuda_without_a_card_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("a card is present, so 'cuda' resolves")
    with pytest.raises(RuntimeError, match="--device cpu"):
        resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_resolve_device_sets_tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    assert resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_parse_cli():
    cfg = parse_cli(EvalConfig, ["--device", "cpu", "--n", "8", "--iso",
                                 "--acc-render-size", "32"])
    assert (cfg.device, cfg.n, cfg.iso, cfg.acc_render_size) == \
        ("cpu", 8, True, 32)
    assert parse_cli(ServeConfig, []).device == "cuda"


# ---- the server ---------------------------------------------------------

def test_server_on_cpu(tmp_path_factory):
    sock = str(tmp_path_factory.mktemp("sq") / "s.sock")
    with np.load(TRUTHS) as d:
        truths = torch.from_numpy(d["true_params"][:3])
    imgs = render_depth_hard_batch(truths, 256, n_bisect=16, quantize=True,
                                   n_sweep=64)
    model = load_eval_state(EvalConfig(ckpt_dir=WEIGHTS),
                            torch.device("cpu"))
    want = predict(model, imgs[..., None]).numpy()
    bmp_path = tmp_path_factory.mktemp("img") / "d.bmp"
    tbmp.write_bmp(bmp_path, np.rint(imgs[0].numpy() * 255).astype(np.uint8))

    server = SQServer(ServeConfig(ckpt_dir=WEIGHTS, socket=sock,
                                  batch_size=4, device="cpu"))
    acceptor = threading.Thread(target=server.serve_forever, daemon=True)
    acceptor.start()
    assert server.ready.wait(30)
    with ServeClient(sock, timeout_s=30) as c:
        assert c.ping()
        for i in range(3):
            resp = c.predict(np.rint(imgs[i].numpy() * 255).astype(np.uint8))
            np.testing.assert_allclose(resp["params"], want[i], atol=1e-5)
            assert len(resp["denormalized"]) == 12
        by_path = c.predict(str(bmp_path))
        np.testing.assert_allclose(by_path["params"], want[0], atol=1e-5)
        with pytest.raises(RuntimeError, match="expected"):
            c.predict(np.zeros((8, 8), np.uint8))
        stats = c.stats()
        assert stats["requests"] == 4 and stats["errors"] == 1
        c.shutdown()
    acceptor.join(timeout=5)
    assert not acceptor.is_alive()
    assert server.alive_threads() == []
    assert not os.path.exists(sock)


def test_server_refuses_a_live_socket(tmp_path_factory):
    import socket as socketlib

    sock = str(tmp_path_factory.mktemp("sq") / "s.sock")
    live = socketlib.socket(socketlib.AF_UNIX, socketlib.SOCK_STREAM)
    live.bind(sock)
    live.listen(1)
    try:
        server = SQServer(ServeConfig(ckpt_dir=WEIGHTS, socket=sock,
                                      batch_size=1, image_size=32,
                                      device="cpu"))
        with pytest.raises(SystemExit, match="already listening"):
            server.serve_forever()
    finally:
        live.close()


# ---- the numpy copies -------------------------------------------------------

def test_bmp_and_labels_match_jax_package(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (37, 53), np.uint8)
    tbmp.write_bmp(tmp_path / "t.bmp", img)
    jbmp.write_bmp(tmp_path / "j.bmp", img)
    assert (tmp_path / "t.bmp").read_bytes() == (tmp_path / "j.bmp").read_bytes()
    np.testing.assert_array_equal(tbmp.read_bmp(str(tmp_path / "j.bmp")), img)
    p = np.random.default_rng(1).uniform(size=(4, 12))
    np.testing.assert_array_equal(tlabels.denormalize_torch(p),
                                  jlabels.denormalize_torch(p))


# ---- isolation from JAX, and the chip smoke off the card ------------------

def test_port_imports_neither_jax_nor_sqtpu():
    code = (
        "import pkgutil, sys, sqtpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(sqtpu_torch.__path__, "
        "'sqtpu_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'sqtpu' or m.startswith('sqtpu.')]\n"
        "assert not bad, bad\n"
        "assert 'sqtpu_torch.serve' in sys.modules\n"
        "assert 'sqtpu_torch.train' in sys.modules\n"
        "assert 'sqtpu_torch.training.loop' in sys.modules\n"
        "assert 'sqtpu_torch.ops.kernels.explicit' in sys.modules\n"
        "for m in ('generate', 'predict', 'scan', 'fit', 'data.augment',"
        " 'data.datasets', 'data.native'):\n"
        "    assert 'sqtpu_torch.' + m in sys.modules, m\n"
        "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = _run_smoke(ROOT)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_b64_payload_round_trip():
    """What the client sends is what the server decodes."""
    img = np.random.default_rng(2).integers(0, 256, (256, 256), np.uint8)
    raw = np.frombuffer(base64.b64decode(base64.b64encode(img.tobytes())),
                        np.uint8)
    np.testing.assert_array_equal(raw.reshape(256, 256), img)
