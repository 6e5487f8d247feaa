"""The port's bench over several ranks: ``python -m torch.distributed.run
--standalone --nproc_per_node 2 -m sqtpu_torch.bench --device cpu``, the
JAX package's ``bench.py`` on its mesh of ``n_chips`` devices.

* (a) the launcher run at batch 2 and one timed step prints one line, from
  rank 0, with ``bench.py``'s keys less ``vs_baseline`` plus
  ``detail.device``, the global batch, ``n_chips`` 1 (two CPU ranks are
  one device) and finite rates above 0; no process imports jax or
  ``sqtpu`` (``PYTHONPROFILEIMPORTTIME`` lists every module each one
  imports);
* (b) every first-step loss over the resident rows equals the one-rank
  bench's at the same global batch, run beside it: 1e-5 relative in
  float32 (the JAX package's gate, ``__graft_entry__.py:196-210``), 2⁻⁸ in
  bfloat16 (bf16's resolution);
* (c) the two ranks' models are equal to the bit after the headline;
* (d) rank r's online and datagen batches are the stream of
  ``make_batch(fold_in(gen, r), B/2)``; one rank's are ``make_batch(gen,
  B)``'s, the stream the bench drew before it ran over ranks;
* (e) a world that does not divide the batch, or the sequence-parallel
  pair's batch of 64, raises ``ValueError`` before any step is built.

The two runs take about 45 s together, each process on two threads.
"""

import json
import math
import os
import subprocess
import sys

import pytest
import torch

from sqtpu_torch import bench
from sqtpu_torch.data.synthetic import make_batch
from sqtpu_torch.parallel import mesh
from sqtpu_torch.parallel.mesh import Layout
from sqtpu_torch.parallel.sharded_losses import fold_in
from sqtpu_torch.training import loop

from test_torch_port_ops import _few_torch_threads  # noqa: F401
from test_torch_port_weights import ROOT

RANKS = 2
BATCH = 2
RUN_TIMEOUT_S = 300
FP32_RTOL = 1e-5
BF16_RTOL = 2.0 ** -8
# each measurement over the resident rows, with its bound
FIRST_LOSSES = {
    "headline": BF16_RTOL,
    "explicit96": FP32_RTOL,
    "explicit128": FP32_RTOL,
    "explicit128_sharp20": FP32_RTOL,
    "explicit128_sharp20_bf16": BF16_RTOL,
    "sp_implicit128_pallas": FP32_RTOL,
    "sp_implicit128_jnp": FP32_RTOL,
}


def _start(cmd: list, out_dir, name: str, **env):
    """``cmd`` from the repo root at the bench's test size, stdout and
    stderr to files (the ranks' stderr is long)."""
    env = dict(os.environ, SQTPU_BENCH_BATCH=str(BATCH),
               SQTPU_BENCH_ITERS="1", OMP_NUM_THREADS="2", PYTHONPATH=ROOT,
               **env)
    out = open(out_dir / f"{name}.out", "w")
    err = open(out_dir / f"{name}.err", "w")
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=out, stderr=err,
                            start_new_session=True)
    return proc, out, err


def _finish(run, timeout: float) -> tuple:
    """Wait for a run; its exit code, stdout and stderr. A run that
    outlives ``timeout`` is killed with its children."""
    proc, out, err = run
    try:
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.wait()
        out.close()
        err.close()
    with open(out.name) as f, open(err.name) as g:
        return proc.returncode, f.read(), g.read()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The bench through the launcher on two CPU ranks, and on one rank
    (no launcher) beside it at the same global batch."""
    d = tmp_path_factory.mktemp("bench_ranks")
    ranks = _start([sys.executable, "-m", "torch.distributed.run",
                    "--standalone", "--nproc_per_node", str(RANKS), "-m",
                    "sqtpu_torch.bench", "--device", "cpu"], d, "ranks",
                   PYTHONPROFILEIMPORTTIME="1")
    one = _start([sys.executable, "-m", "sqtpu_torch.bench", "--device",
                  "cpu"], d, "one")
    ranks_res = _finish(ranks, RUN_TIMEOUT_S)
    one_res = _finish(one, RUN_TIMEOUT_S)
    for rc, _, err in (ranks_res, one_res):
        assert rc == 0, err[-4000:]
    return {"ranks": ranks_res[1:], "one": one_res[1:]}


# ---- (a) the launcher run ---------------------------------------------------

def test_launcher_prints_one_line_with_bench_py_s_keys(runs):
    stdout, _ = runs["ranks"]
    lines = stdout.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    sys.path.insert(0, ROOT)
    import chip_smoke

    top, detail = chip_smoke.jax_bench_keys()
    assert set(line) == top - {"vs_baseline"}
    assert set(line["detail"]) == detail | {"device"}
    assert line["detail"]["batch"] == BATCH
    assert line["detail"]["n_chips"] == 1
    assert line["detail"]["device"] == "cpu"


def test_launcher_rates_are_finite(runs):
    line = json.loads(runs["ranks"][0])
    rates = [line["value"]] + [v for k, v in line["detail"].items()
                               if k.endswith("_per_chip")
                               or k in ("imgs_per_sec_total",
                                        "loss_point_evals_per_sec")]
    assert len(rates) == 11
    assert all(math.isfinite(r) and r > 0 for r in rates)
    assert math.isfinite(line["detail"]["final_loss"])
    # one device: a chip's rate is the total
    assert line["value"] == line["detail"]["imgs_per_sec_total"]


def test_no_rank_imports_jax_or_sqtpu(runs):
    _, stderr = runs["ranks"]
    imported = {line.rsplit("|", 1)[1].strip()
                for line in stderr.splitlines()
                if line.startswith("import time:")}
    # the ranks' modules are listed (the bench itself runs as __main__)
    assert {"sqtpu_torch.training.loop", "sqtpu_torch.parallel.mesh"} <= (
        imported)
    assert not [m for m in imported if m.split(".")[0] in ("jax", "sqtpu")]
    ranks = bench.read_progress(stderr)
    assert [ranks[r]["backend"] for r in range(RANKS)] == ["gloo"] * RANKS
    # the CPU takes the kernels' plain versions: no launch
    for r in range(RANKS):
        assert set(ranks[r]["launches"].values()) == {0}


# ---- (b) first losses against one rank, (c) identical models ---------------

@pytest.mark.parametrize("name", list(FIRST_LOSSES))
def test_first_loss_matches_one_rank(runs, name):
    ranks = bench.read_progress(runs["ranks"][1])
    one = bench.read_progress(runs["one"][1])
    assert sorted(ranks) == list(range(RANKS)) and list(one) == [0]
    want = one[0]["first"][name]
    for rank in range(RANKS):
        got = ranks[rank]["first"][name]
        assert abs(got - want) <= FIRST_LOSSES[name] * abs(want), (
            rank, got, want)


def test_ranks_hold_one_model_after_the_headline(runs):
    ranks = bench.read_progress(runs["ranks"][1])
    digests = [ranks[r]["digest"] for r in range(RANKS)]
    assert len(digests[0]) == 64 and len(set(digests)) == 1
    assert "digest" not in bench.read_progress(runs["one"][1])[0]


# ---- (d) the online and datagen streams ------------------------------------

def _draws(draw, n: int = 2) -> list:
    return [draw() for _ in range(n)]


@pytest.mark.parametrize("world,rank", [(1, 0), (2, 0), (2, 1)])
def test_online_stream_is_each_rank_s_fold(world, rank):
    layout = Layout(rank=rank, world=world, n_data=world)
    gen = torch.Generator()
    gen.manual_seed(bench.ONLINE_SEED)
    got = _draws(bench.batch_stream(gen, BATCH, layout))
    ref = torch.Generator()
    ref.manual_seed(bench.ONLINE_SEED)
    if world == 1:
        want = _draws(lambda: make_batch(ref, BATCH, bench.IMAGE, "hard"))
    else:
        local = fold_in(ref, rank)
        want = _draws(lambda: make_batch(local, BATCH // world, bench.IMAGE,
                                         "hard"))
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.shape == (BATCH // world, bench.IMAGE, bench.IMAGE, 1)
        assert torch.equal(gi, wi) and torch.equal(gl, wl)
    # a stream: the next batch is another one
    assert not torch.equal(got[0][1], got[1][1])
    if world > 1:  # the other rank draws other shapes
        other = torch.Generator()
        other.manual_seed(bench.ONLINE_SEED)
        theirs = bench.batch_stream(other, BATCH, Layout(
            rank=1 - rank, world=world, n_data=world))()
        assert not torch.equal(theirs[1], got[0][1])


# ---- (e) layouts that do not fit --------------------------------------------

@pytest.mark.parametrize("batch,world,bad", [(3, 2, 3), (6, 3, 64),
                                             (2, 4, 2)])
def test_layout_that_does_not_fit_raises_before_a_step(monkeypatch, batch,
                                                       world, bad):
    monkeypatch.setattr(mesh, "init_layout", lambda n_grid, device: Layout(
        world=world, n_data=world, device=device))

    def no_step(*args, **kwargs):
        raise AssertionError("a step was built")

    monkeypatch.setattr(loop, "make_train_step", no_step)
    with pytest.raises(ValueError, match=f"batch_size {bad} must divide "
                                         f"the data axis of {world} ranks"):
        bench.measure(torch.device("cpu"), batch, 1)


@pytest.mark.parametrize("batch,world", [(2, 2), (512, 4), (512, 8)])
def test_layouts_that_fit(batch, world):
    bench.check_layouts(batch, world)
