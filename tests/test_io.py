"""Loader parity tests (reference dataset.py:43-107 semantics)."""

import numpy as np

from hcspmm_tpu.graphs import io
from hcspmm_tpu.graphs.dataset import GraphDataset


def test_txt_loader_is_one_indexed_dst_src(tmp_path):
    # reference dataset.py:52-53: line "a,b" means edge (src=b-1 -> dst=a-1)
    p = tmp_path / "g.txt"
    p.write_text("2,1\n3,1\n3,2\n")
    src, dst, n = io.load_edges_txt(str(p))
    assert n == 3
    assert sorted(zip(src.tolist(), dst.tolist())) == [(0, 1), (0, 2), (1, 2)]


def test_npz_roundtrip(tmp_path):
    p = str(tmp_path / "g.npz")
    src = np.array([0, 1, 2], np.int32)
    dst = np.array([1, 2, 0], np.int32)
    io.save_edges_npz(p, src, dst, 5)
    s2, d2, n2 = io.load_edges_npz(p)
    assert n2 == 5
    np.testing.assert_array_equal(s2, src)
    np.testing.assert_array_equal(d2, dst)


def test_to_csr_merges_duplicates():
    src = np.array([0, 0, 0, 1], np.int32)
    dst = np.array([1, 1, 2, 0], np.int32)
    rp, ci = io.to_csr(src, dst, 3)
    assert rp.tolist() == [0, 2, 3, 3]   # duplicate (0,1) merged
    assert ci.tolist() == [1, 2, 0]


def test_dataset_from_txt(tmp_path):
    p = tmp_path / "g.txt"
    p.write_text("2,1\n1,2\n3,2\n2,3\n")
    ds = GraphDataset.from_txt(str(p), dim=8, num_classes=4)
    assert ds.num_nodes == 3
    assert ds.x.shape == (3, 8)
    assert ds.y.shape == (3,)
    assert (ds.y == 1).all()            # all-ones labels (main reference quirk)
    assert ds.train_mask.all()          # train = 100% of nodes
    assert ds.degrees_sqrt is not None


def test_synthetic_blocks_structure():
    src, dst, n = io.synthetic_blocks(1000, 6.0, block_size=100, seed=0,
                                      shuffle=False)
    assert n == 1000
    # edges stay within their block when unshuffled
    assert (np.abs(src // 100 - dst // 100) == 0).all()
    src2, dst2, _ = io.synthetic_blocks(1000, 6.0, block_size=100, seed=0,
                                        shuffle=True)
    assert not (np.abs(src2 // 100 - dst2 // 100) == 0).all()


def test_load_edges_any_formats(tmp_path):
    """Real-dataset adapter: ogb edge_index npz/npy, scipy CSR npz,
    src/dst npz, ogb raw directory, reference txt (io.load_edges_any)."""
    import gzip
    import scipy.sparse as sp

    from hcspmm_tpu.graphs import io

    src = np.array([0, 1, 2, 3, 3], dtype=np.int64)
    dst = np.array([1, 2, 0, 0, 2], dtype=np.int64)
    n = 5  # node 4 isolated -> num-node-list / num_nodes must win

    def check(s, d, nn, expect_n=n):
        assert nn == expect_n
        assert sorted(zip(s.tolist(), d.tolist())) == sorted(
            zip(src.tolist(), dst.tolist()))

    # ogb-style edge_index npz (+num_nodes)
    p = tmp_path / "g1.npz"
    np.savez(p, edge_index=np.stack([src, dst]), num_nodes=n)
    check(*io.load_edges_any(str(p)))
    # bare npy [2, E] (num nodes inferred = max id + 1)
    p = tmp_path / "g2.npy"
    np.save(p, np.stack([src, dst]))
    check(*io.load_edges_any(str(p)), expect_n=4)
    # npy [E, 2]
    p = tmp_path / "g3.npy"
    np.save(p, np.stack([src, dst]).T)
    check(*io.load_edges_any(str(p)), expect_n=4)
    # scipy CSR via save_npz
    p = tmp_path / "g4.npz"
    a = sp.csr_matrix((np.ones(len(src)), (src, dst)), shape=(n, n))
    sp.save_npz(p, a)
    s, d, nn = io.load_edges_any(str(p))
    check(s, d, nn)
    # src/dst npz
    p = tmp_path / "g5.npz"
    np.savez(p, src=src, dst=dst, num_nodes=n)
    check(*io.load_edges_any(str(p)))
    # ogb raw directory with gzipped csvs
    raw = tmp_path / "ogbn_toy" / "raw"
    raw.mkdir(parents=True)
    with gzip.open(raw / "edge.csv.gz", "wt") as f:
        for a_, b_ in zip(src, dst):
            f.write(f"{a_},{b_}\n")
    with gzip.open(raw / "num-node-list.csv.gz", "wt") as f:
        f.write(f"{n}\n")
    check(*io.load_edges_any(str(tmp_path / "ogbn_toy")))
    # reference npz still routes through the parity loader
    p = tmp_path / "g6.npz"
    io.save_edges_npz(str(p), src.astype(np.int32), dst.astype(np.int32), n)
    check(*io.load_edges_any(str(p)))
    # reference txt (1-indexed dst,src)
    p = tmp_path / "g7.txt"
    with open(p, "w") as f:
        for a_, b_ in zip(src, dst):
            f.write(f"{b_ + 1},{a_ + 1}\n")
    check(*io.load_edges_any(str(p)), expect_n=4)


def test_dataset_from_file_end_to_end(tmp_path):
    from hcspmm_tpu.graphs.dataset import GraphDataset

    rng = np.random.RandomState(0)
    e = rng.randint(0, 50, size=(2, 400))
    p = tmp_path / "g.npz"
    np.savez(p, edge_index=e, num_nodes=50)
    ds = GraphDataset.from_file(str(p), dim=8, num_classes=3)
    assert ds.num_nodes == 50 and ds.x.shape == (50, 8)
    assert ds.row_pointers[-1] == ds.nnz


def test_real_digits_knn_dataset_and_training():
    """Real-dataset path end-to-end: sklearn digits
    (real features + labels) under the k-NN graph, through the full plan
    -> SpMM -> 2-layer GCN training on CPU."""
    import numpy as np

    from hcspmm_tpu.config import PlanConfig
    from hcspmm_tpu.graphs.dataset import GraphDataset
    from hcspmm_tpu.models.net import Net
    from hcspmm_tpu.ops.spmm import HybridSpMM
    from hcspmm_tpu.train.loop import train

    ds = GraphDataset.real("digits-knn:4")
    assert ds.num_nodes == 1797 and ds.num_classes == 10
    assert ds.x.shape == (1797, 64)
    assert not np.all(ds.y == 1)  # REAL labels, not the all-ones fixture
    op = HybridSpMM(ds.row_pointers, ds.column_index, ds.num_nodes,
                    PlanConfig(impl="triton"), interpret=True)
    net = Net(model="gcn", num_features=64, hidden=16, num_classes=10,
              num_layers=2)
    res = train(net, op, ds.x, ds.y, epochs=3, warmup_epochs=1,
                scan_chunk=1)
    assert np.isfinite(res["final_loss"])


def test_real_edge_list_file_roundtrip(tmp_path):
    """Committed real graphs (data/*_A.txt) load through the reference
    text semantics (1-indexed "dst,src", dataset.py:46-61)."""
    import os

    import numpy as np

    from hcspmm_tpu.graphs import io, real

    for name in ("karate", "lesmis"):
        path = os.path.join(os.path.dirname(__file__), "..", "data",
                            f"{name}_A.txt")
        src, dst, n = io.load_edges_any(path)
        s2, d2, n2 = real.networkx_edges(name)
        assert n == n2
        a = set(zip(src.tolist(), dst.tolist()))
        b = set(zip(s2.tolist(), d2.tolist()))
        assert a == b, name
        # full plan + oracle SpMM on the real graph
        rp, ci = io.to_csr(src, dst, n)
        from hcspmm_tpu.ops.spmm import HybridSpMM, spmm_reference_dense
        from hcspmm_tpu.config import PlanConfig

        op = HybridSpMM(rp, ci, n, PlanConfig(impl="triton"),
                        interpret=True)
        x = np.random.RandomState(0).randn(n, 8).astype(np.float32)
        import jax.numpy as jnp

        z = np.asarray(op(jnp.asarray(x)))
        zref = spmm_reference_dense(rp, ci, n, x)
        assert np.abs(z - zref).max() < 1e-4 * max(1, np.abs(zref).max())
