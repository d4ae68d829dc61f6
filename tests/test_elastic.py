"""Elastic recovery: fault injection -> detection -> resume-from-checkpoint
(train.elastic; net-new vs the reference, SURVEY.md §5 'Failure detection /
elastic recovery')."""

import os

import jax
import numpy as np
import pytest

from conftest import small_graph

from hcspmm_tpu.models.net import Net
from hcspmm_tpu.ops.spmm import HybridSpMM
from hcspmm_tpu.train import elastic
from hcspmm_tpu.train.loop import train
from hcspmm_tpu.utils.checkpoint import load_pytree


def setup(n=48, deg=4, dim=8, hidden=8, classes=4, layers=2):
    rp, ci, nn = small_graph(n, deg)
    op = HybridSpMM(rp, ci, nn)
    net = Net(model="gcn", num_features=dim, hidden=hidden,
              num_classes=classes, num_layers=layers)
    x = np.random.RandomState(0).randn(nn, dim).astype(np.float32)
    y = np.ones(nn, dtype=np.int32)
    return net, op, x, y


def test_fault_injection_raises(tmp_path):
    net, op, x, y = setup()
    ckpt = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="injected fault at epoch 3"):
        train(net, op, x, y, epochs=6, warmup_epochs=0, scan_chunk=1,
              checkpoint_path=ckpt, checkpoint_every=2, fault_epoch=3)
    # the checkpoint written before the fault survives, at epoch 2
    _, meta = load_pytree(ckpt)
    assert meta["epoch"] == 2


def test_run_with_recovery_resumes_and_completes(tmp_path):
    net, op, x, y = setup()
    ckpt = str(tmp_path / "ck")
    res = elastic.run_with_recovery(
        net, op, x, y, epochs=6, checkpoint_path=ckpt, checkpoint_every=2,
        max_restarts=3, fault_epochs=[3], warmup_epochs=0, scan_chunk=1)
    assert res["restarts"] == 1
    # first attempt started at 0, retry resumed from the epoch-2 checkpoint
    assert res["resumed_from"] == [0, 2]
    assert np.isfinite(res["final_loss"])
    params, meta = load_pytree(ckpt)
    assert meta["epoch"] == 6
    # recovered params are real (finite) pytrees
    assert all(np.isfinite(np.asarray(l)).all()
               for l in jax.tree.leaves(params))


def test_run_with_recovery_exhausts_restarts(tmp_path):
    net, op, x, y = setup()
    ckpt = str(tmp_path / "ck")
    # fault before the first checkpoint every attempt: no progress possible
    with pytest.raises(RuntimeError, match="exhausted"):
        elastic.run_with_recovery(
            net, op, x, y, epochs=6, checkpoint_path=ckpt,
            checkpoint_every=10, max_restarts=2, fault_epochs=[1, 1, 1],
            warmup_epochs=0, scan_chunk=1)


def test_recovery_is_deterministic(tmp_path):
    """Two identical crash+resume runs produce bit-identical parameters:
    the checkpoint plus the seeded RNG stream fully determine the resumed
    trajectory (the Adam state restarts from the saved params — documented
    divergence from an uninterrupted run, like most epoch-granular
    elastic systems)."""
    net, op, x, y = setup()

    def run(tag):
        ckpt = str(tmp_path / tag)
        return elastic.run_with_recovery(
            net, op, x, y, epochs=8, checkpoint_path=ckpt,
            checkpoint_every=2, max_restarts=2, fault_epochs=[4],
            warmup_epochs=0, scan_chunk=1)

    a, b = run("a"), run("b")
    for la, lb in zip(jax.tree.leaves(a["params"]),
                      jax.tree.leaves(b["params"])):
        np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))


def test_corrupt_checkpoint_treated_as_absent(tmp_path):
    path = str(tmp_path / "ck")
    with open(path + ".npz", "wb") as f:
        f.write(b"not a zipfile")
    params, epoch = elastic.checkpoint_state(path)
    assert params is None and epoch == 0


def test_supervise_relaunches_cli(tmp_path):
    """Out-of-process supervision logic against an in-process CLI runner:
    first launch faults at epoch 3 (checkpointing every 2), the relaunch
    resumes with --resume and finishes the remaining epochs."""
    from hcspmm_tpu.train import cli

    ckpt = str(tmp_path / "ck")
    launches = []

    def runner(argv):
        launches.append(list(argv))
        try:
            return cli.main(argv)
        except RuntimeError:
            return 1

    res = elastic.supervise(
        ["--dataset", "example", "--synthetic-nodes", "48",
         "--synthetic-degree", "4", "--dim", "8", "--hidden", "8",
         "--classes", "4", "--num_layers", "2", "--device", "cpu"],
        checkpoint=ckpt, total_epochs=6, checkpoint_every=2,
        max_restarts=2, fault_epoch=3, runner=runner)
    assert res["restarts"] == 1
    assert res["epochs"] == 6
    assert len(launches) == 2
    assert "--fault-epoch" in launches[0] and "--fault-epoch" not in launches[1]
    assert "--resume" in launches[1]
    # relaunch asks only for the remaining epochs
    i = launches[1].index("--epochs")
    assert launches[1][i + 1] == "4"
    _, meta = load_pytree(ckpt)
    assert meta["epoch"] == 6


def test_supervise_parent_stays_off_the_device(tmp_path):
    """The supervising parent never starts a JAX backend, so the CLI it
    launches is the only process that opens the card."""
    import subprocess
    import sys

    code = f"""
import numpy as np
from jax._src import xla_bridge
from hcspmm_tpu.train import elastic
from hcspmm_tpu.utils.checkpoint import save_pytree

ckpt = {str(tmp_path / "ck")!r}
def runner(argv):
    save_pytree(ckpt, [{{"weights": np.ones((2, 2), np.float32)}}],
                {{"epoch": 3}})
    return 0
res = elastic.supervise(["--dataset", "example"], checkpoint=ckpt,
                        total_epochs=3, runner=runner)
assert res["epochs"] == 3, res
assert not xla_bridge.backends_are_initialized()
print("ok")
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
