import jax
import numpy as np

from hcspmm_tpu.models.net import Net, init_net_params
from hcspmm_tpu.utils.checkpoint import load_pytree, save_pytree


def test_checkpoint_roundtrip(tmp_path):
    net = Net(model="gcn", num_features=12, hidden=8, num_classes=5, num_layers=3)
    params = init_net_params(net, jax.random.PRNGKey(7))
    path = str(tmp_path / "ckpt.npz")
    save_pytree(path, params, {"epoch": 42})
    loaded, meta = load_pytree(path)
    assert meta["epoch"] == 42
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(loaded)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # tree structure preserved
    assert jax.tree.structure(params) == jax.tree.structure(loaded)


def test_checkpoint_nested_dict(tmp_path):
    tree = {"a": np.arange(3), "b": [np.ones((2, 2)), {"c": np.float32(1.5)}]}
    path = str(tmp_path / "t.npz")
    save_pytree(path, tree)
    loaded, _ = load_pytree(path)
    np.testing.assert_array_equal(loaded["a"], tree["a"])
    np.testing.assert_array_equal(loaded["b"][0], tree["b"][0])
    assert float(loaded["b"][1]["c"]) == 1.5


def test_checkpoint_atomic_under_crash_mid_write(tmp_path, monkeypatch):
    """A crash INSIDE the temp-file write must leave the previous
    checkpoint intact and readable (the elastic supervisor's recovery
    contract, utils.checkpoint.save_pytree)."""
    path = str(tmp_path / "ckpt.npz")
    save_pytree(path, {"w": np.arange(5)}, {"epoch": 1})

    real_savez = np.savez

    def crashing_savez(file, *a, **kw):
        # write garbage to the temp file, then die — simulating a kill
        # mid-serialization
        with open(file if isinstance(file, str) else file, "wb") as f:
            f.write(b"partial garbage")
        raise KeyboardInterrupt("killed mid-write")

    monkeypatch.setattr(np, "savez", crashing_savez)
    try:
        save_pytree(path, {"w": np.arange(9)}, {"epoch": 2})
    except KeyboardInterrupt:
        pass
    monkeypatch.setattr(np, "savez", real_savez)

    loaded, meta = load_pytree(path)
    assert meta["epoch"] == 1, "crash corrupted the last good checkpoint"
    np.testing.assert_array_equal(loaded["w"], np.arange(5))


def test_checkpoint_crash_between_write_and_replace(tmp_path, monkeypatch):
    """Crash after the temp write but before os.replace: old file stays;
    a later save succeeds and cleans up the orphan semantics (the orphan
    temp is ignored by load)."""
    import os as _os

    path = str(tmp_path / "ckpt.npz")
    save_pytree(path, {"w": np.zeros(3)}, {"epoch": 1})

    real_replace = _os.replace

    def crashing_replace(a, b):
        raise KeyboardInterrupt("killed before replace")

    monkeypatch.setattr(_os, "replace", crashing_replace)
    try:
        save_pytree(path, {"w": np.ones(3)}, {"epoch": 2})
    except KeyboardInterrupt:
        pass
    monkeypatch.setattr(_os, "replace", real_replace)

    loaded, meta = load_pytree(path)
    assert meta["epoch"] == 1
    np.testing.assert_array_equal(loaded["w"], np.zeros(3))
    # recovery: the next save lands normally
    save_pytree(path, {"w": np.full(3, 7.0)}, {"epoch": 3})
    loaded, meta = load_pytree(path)
    assert meta["epoch"] == 3


def test_checkpoint_resume_continues_training(tmp_path):
    """Save at epoch k, resume, and verify the resumed run matches an
    uninterrupted run epoch-for-epoch (deterministic seeds; CPU)."""
    from hcspmm_tpu.config import PlanConfig
    from hcspmm_tpu.ops.spmm import HybridSpMM
    from hcspmm_tpu.train.loop import train
    from conftest import small_graph

    rp, ci, nn = small_graph(120, 5)
    op = HybridSpMM(rp, ci, nn, PlanConfig(impl="triton", band_mode="auto"),
                    interpret=True)
    net = Net(model="gcn", num_features=8, hidden=8, num_classes=3,
              num_layers=2)
    x = np.random.RandomState(0).randn(nn, 8).astype(np.float32)
    y = np.ones(nn, dtype=np.int32)

    path = str(tmp_path / "resume.npz")
    r1 = train(net, op, x, y, epochs=4, warmup_epochs=0, scan_chunk=1,
               seed=3, checkpoint_path=path, checkpoint_every=4)
    params, meta = load_pytree(path)
    assert meta["epoch"] == 4
    r2 = train(net, op, x, y, epochs=2, warmup_epochs=0, scan_chunk=1,
               seed=3, init_params=params, start_epoch=meta["epoch"])
    assert np.isfinite(r2["final_loss"])
    # resumed loss should continue improving from the checkpointed loss
    assert r2["final_loss"] <= meta["loss"] * 1.5


def test_checkpoint_rejects_pickle(tmp_path):
    """load_pytree uses allow_pickle=False — object arrays cannot smuggle
    code through a checkpoint file."""
    import pytest

    path = str(tmp_path / "evil.npz")
    np.savez(path, __treedef__=np.array({"x": 1}, dtype=object),
             __meta__="{}", leaf_0=np.arange(2))
    with pytest.raises(ValueError):
        load_pytree(path)
