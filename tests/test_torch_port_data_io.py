"""The port's data I/O against the JAX package, on the CPU: the label
parsers, the BMP-directory dataset, the native C++ scanner through ctypes,
``generate`` and ``scan``.

Inputs are made with numpy from a seed. The parsers, the CSV rows, the
packed dataset and its batches must agree to the bit. Renderers are held
to the renderer's bound (``sqtpu/ops/geometry.py:400-402``): fewer than
0.1% of the pixels off by more than one gray level. The native library
and CLI are built from ``native/sqscan.cpp`` into ``sqtpu_torch/build/``;
nothing is written under ``native/``.
"""

import os
import re
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqtpu import generate as jgenerate
from sqtpu import scan as jscan
from sqtpu.data import bmp as jbmp
from sqtpu.data import datasets as jdatasets
from sqtpu.data import labels as jlabels
from sqtpu.ops import quaternion as jquat
from sqtpu_torch import generate as tgenerate
from sqtpu_torch import scan as tscan
from sqtpu_torch.data import bmp as tbmp
from sqtpu_torch.data import datasets as tdatasets
from sqtpu_torch.data import labels as tlabels
from sqtpu_torch.data import native
from sqtpu_torch.ops.render import render_depth_hard_batch
from sqtpu_torch.utils.config import GenerateConfig

from test_torch_port_ops import _few_torch_threads, random_params  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIXEL_TOL = 1e-3


def gray_levels_off(a: np.ndarray, b: np.ndarray) -> float:
    return float((np.abs(a.astype(int) - b.astype(int)) > 1).mean())


def _label_csv(path, p: np.ndarray, header: bool = True) -> None:
    m = np.asarray(jquat.to_matrix(jnp.asarray(p[:, 8:12])))
    with open(path, "w") as f:
        if header:
            f.write("fn,a1,a2,a3,e1,e2,t1,t2,t3,m11,m12,m13,m21,m22,m23,"
                    "m31,m32,m33,q1,q2,q3,q4\n")
        for i in range(p.shape[0]):
            f.write(jgenerate._csv_row("%06d.bmp" % i, p[i], m[i]))


# ---- labels ------------------------------------------------------------------

@pytest.mark.parametrize("header", [True, False])
def test_label_parsers_match_jax(tmp_path, header):
    p = random_params(20, 7)
    path = str(tmp_path / "labels.csv")
    _label_csv(path, p, header)
    for name in ("parse_csv_torch", "parse_csv_keras"):
        np.testing.assert_array_equal(getattr(tlabels, name)(path),
                                      getattr(jlabels, name)(path))
    tn, tp = tlabels.parse_labels_txt(path)
    jn, jp = jlabels.parse_labels_txt(path)
    assert tn == jn and len(tn) == 7
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_allclose(tlabels.parse_csv_torch(path, np.float64), p,
                               atol=1e-6)


def test_csv_row_matches_jax():
    p = random_params(21, 3).astype(np.float32)
    m = np.asarray(jquat.to_matrix(jnp.asarray(p[:, 8:12])))
    for i in range(3):
        assert tlabels.csv_row("x.bmp", p[i], m[i]) == \
            jgenerate._csv_row("x.bmp", p[i], m[i])


# ---- the BMP-directory dataset -----------------------------------------------

@pytest.fixture(scope="module")
def bmp_dir(tmp_path_factory):
    """11 random 20×24 uint8 BMPs."""
    d = tmp_path_factory.mktemp("bmps")
    rng = np.random.default_rng(22)
    for i in range(11):
        tbmp.write_bmp(d / ("%06d.bmp" % i),
                       rng.integers(0, 256, (20, 24), np.uint8))
    return str(d)


@pytest.mark.parametrize("shuffle,drop", [(False, True), (True, True),
                                          (True, False)])
def test_depth_dataset_matches_jax(bmp_dir, tmp_path, shuffle, drop):
    labels = np.random.default_rng(23).uniform(size=(11, 12))
    t = tdatasets.DepthDataset(bmp_dir, labels, 0.75,
                               str(tmp_path / "t.npy"))
    j = jdatasets.DepthDataset(bmp_dir, labels, 0.75,
                               str(tmp_path / "j.npy"))
    assert (tmp_path / "t.npy").read_bytes() == (tmp_path / "j.npy").read_bytes()
    assert len(t) == len(j) == 11
    np.testing.assert_array_equal(t.train_indices, j.train_indices)
    np.testing.assert_array_equal(t.val_indices, j.val_indices)
    for idx in ("train_indices", "val_indices"):
        tb = list(t.batches(getattr(t, idx), 3, shuffle=shuffle, seed=5,
                            drop_remainder=drop))
        jb = list(j.batches(getattr(j, idx), 3, shuffle=shuffle, seed=5,
                            drop_remainder=drop))
        assert len(tb) == len(jb) > 0
        for (ti, tl), (ji, jl) in zip(tb, jb):
            assert ti.dtype == np.float32 and ti.shape[-1] == 1
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tl, jl)


def test_pack_is_kept_and_empty_dirs_refused(bmp_dir, tmp_path):
    pack = tdatasets.pack_bmp_dir(bmp_dir, str(tmp_path / "p.npy"))
    assert tdatasets.pack_bmp_dir(bmp_dir, pack) == pack
    arr = np.load(pack, mmap_mode="r")
    np.testing.assert_array_equal(
        arr[3], tbmp.read_bmp(os.path.join(bmp_dir, "000003.bmp")))
    with pytest.raises(FileNotFoundError):
        tdatasets.pack_bmp_dir(str(tmp_path))
    with pytest.raises(ValueError, match="labels"):
        tdatasets.DepthDataset(bmp_dir, np.zeros((3, 12)), 0.5,
                               str(tmp_path / "q.npy"))


def test_load_h5_dataset_is_gated_like_jax(tmp_path):
    try:
        import h5py
    except ImportError:
        for mod in (tdatasets, jdatasets):
            with pytest.raises(ImportError, match="h5py"):
                mod.load_h5_dataset(str(tmp_path / "none.h5"))
        return
    data = np.arange(24, dtype=np.uint8).reshape(2, 3, 4)
    with h5py.File(tmp_path / "d.h5", "w") as f:
        f["sq"] = data
    np.testing.assert_array_equal(
        tdatasets.load_h5_dataset(str(tmp_path / "d.h5")), data)


# ---- the native scanner ------------------------------------------------------

def test_native_builds_outside_native_dir():
    before = sorted(os.listdir(os.path.join(ROOT, "native")))
    lib, cli = native.library_path(), native.cli_path()
    assert os.path.dirname(lib) == os.path.dirname(cli) == native.BUILD_DIR
    assert os.path.exists(lib) and os.access(cli, os.X_OK)
    assert sorted(os.listdir(os.path.join(ROOT, "native"))) == before


def test_native_matches_the_plain_renderer():
    p = random_params(24, 4)
    got = native.render_batch_native(p, size=128, n_sweep=128, n_bisect=20)
    assert got.shape == (4, 128, 128) and got.dtype == np.uint8
    want = render_depth_hard_batch(torch.from_numpy(p), 128, n_bisect=20,
                                   quantize=True, n_sweep=128)
    want = np.rint(want.numpy() * 255).astype(np.uint8)
    assert all(g.max() > 50 for g in got)
    assert gray_levels_off(got, want) < PIXEL_TOL
    one = native.render_depth_native(p[0], 128, n_sweep=128, n_bisect=20)
    np.testing.assert_array_equal(one, got[0])


def test_native_bmp_writer_and_cli(tmp_path):
    img = np.random.default_rng(25).integers(0, 256, (40, 52), np.uint8)
    native.write_bmp_native(str(tmp_path / "n.bmp"), img)
    tbmp.write_bmp(tmp_path / "t.bmp", img)
    assert (tmp_path / "n.bmp").read_bytes() == (tmp_path / "t.bmp").read_bytes()
    np.testing.assert_array_equal(tbmp.read_bmp(str(tmp_path / "n.bmp")), img)
    bad = subprocess.run([native.cli_path(), "too", "few"],
                         capture_output=True)
    assert bad.returncode != 0 and b"usage" in bad.stderr


# ---- generate and scan ---------------------------------------------------------

def test_generate_writes_the_jax_packages_files(tmp_path):
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    tgenerate.generate(GenerateConfig(n=5, out=tdir, batch_size=2,
                                      image_size=32, seed=3, device="cpu"))
    jgenerate.generate(jgenerate.GenerateConfig(n=5, out=jdir, batch_size=2,
                                                image_size=32, seed=3))
    names = sorted(os.listdir(tdir))
    assert names == sorted(os.listdir(jdir)) == [
        "%06d.bmp" % i for i in range(5)] + ["data_labels.csv"]
    row = re.compile(r"^\d{6}\.bmp(,-?\d+\.\d{6}){21}$")
    tlines = open(os.path.join(tdir, "data_labels.csv")).read().splitlines()
    jlines = open(os.path.join(jdir, "data_labels.csv")).read().splitlines()
    assert len(tlines) == len(jlines) == 5
    assert all(row.match(x) for x in tlines + jlines)
    assert [x.split(",")[0] for x in tlines] == [x.split(",")[0]
                                                 for x in jlines]
    labels = tlabels.parse_csv_torch(os.path.join(tdir, "data_labels.csv"))
    imgs = np.stack([tbmp.read_bmp(os.path.join(tdir, "%06d.bmp" % i))
                     for i in range(5)])
    for i in range(5):
        tb = open(os.path.join(tdir, "%06d.bmp" % i), "rb").read()
        jb = open(os.path.join(jdir, "%06d.bmp" % i), "rb").read()
        assert len(tb) == len(jb) and tb[:54] == jb[:54]  # the same header
    # each image is its label's render (the CSV rounds to 6 decimals)
    again = render_depth_hard_batch(torch.from_numpy(labels), 32,
                                    n_bisect=20, quantize=True, n_sweep=32)
    again = (again * 255.0).to(torch.uint8).numpy()
    assert gray_levels_off(imgs, again) < 0.02 and imgs.max() > 50
    # the rotation columns are the quaternion's matrix
    cols = np.loadtxt(os.path.join(tdir, "data_labels.csv"), delimiter=",",
                      usecols=range(1, 22))
    m = np.asarray(jquat.to_matrix(jnp.asarray(cols[:, 17:21])))
    np.testing.assert_allclose(cols[:, 8:17], m.reshape(5, 9), atol=2e-6)


def test_generate_native_backend_and_refusals(tmp_path):
    tgenerate.generate(GenerateConfig(n=2, out=str(tmp_path / "n"),
                                      image_size=32, backend="native",
                                      device="cpu"))
    assert len(os.listdir(tmp_path / "n")) == 3
    # iso runs since Slice F: one image of the fixed view and its row
    tgenerate.generate(GenerateConfig(n=1, out=str(tmp_path / "i"),
                                      image_size=32, iso=True, device="cpu"))
    assert sorted(os.listdir(tmp_path / "i")) == ["000000.bmp",
                                                  "data_labels.csv"]
    with pytest.raises(ValueError, match="backend"):
        tgenerate.generate(GenerateConfig(n=1, out=str(tmp_path / "b"),
                                          backend="tpu", device="cpu"))


def _scan_args(path: str, seed: int) -> list:
    p = random_params(seed, 1)[0]
    m = np.asarray(jquat.to_matrix(jnp.asarray(p[8:12])))
    return [path] + ["%f" % v for v in np.concatenate(
        [p[0:3] * 255, p[3:5], p[5:8] * 255, m.ravel()])]


@pytest.mark.parametrize("seed", [26, 27])
def test_scan_matches_jax_and_the_native_cli(tmp_path, seed):
    args = _scan_args(str(tmp_path / "s.bmp"), seed)
    _, want = jscan.render_from_cli_args(args)
    _, got = tscan.render_from_cli_args(args, device="cpu")
    assert got.shape == (256, 256) and got.dtype == np.uint8
    assert got.max() > 50 and gray_levels_off(got, want) < PIXEL_TOL
    tbmp.write_bmp(args[0], got)
    np.testing.assert_array_equal(jbmp.read_bmp(args[0]), got)
    if not torch.cuda.is_available():  # the CLI renders on the card
        with pytest.raises(RuntimeError, match="--device cpu"):
            tscan.main(args)
    subprocess.run([native.cli_path(), str(tmp_path / "n.bmp"), *args[1:]],
                   check=True)
    assert gray_levels_off(tbmp.read_bmp(str(tmp_path / "n.bmp")),
                           got) < PIXEL_TOL
    with pytest.raises(SystemExit, match="usage"):
        tscan.render_from_cli_args(args[:5], device="cpu")
