"""LOI selector semantics + calibration fitting."""

import numpy as np

from hcspmm_tpu.config import LOICoefficients
from hcspmm_tpu.format import loi


def test_intended_rule_reference_values():
    coeffs = LOICoefficients()
    # size > 32 (reference semantics: unique-1) must go sparse regardless.
    t = loi.decide_hybrid_type(
        unique_counts=np.array([40]), edge_counts=np.array([50]),
        block_partition=np.array([5]), mode="intended", coeffs=coeffs,
    )
    assert t.tolist() == [0]
    # tiny dense window: few unique cols, high occupancy -> dense.
    # size_ref=7, num=1 -> density = 100/128; score = 7*0.198 - 6.578*0.78 - 3.15 < 0
    t = loi.decide_hybrid_type(
        unique_counts=np.array([8]), edge_counts=np.array([100]),
        block_partition=np.array([1]), mode="intended", coeffs=coeffs,
    )
    assert t.tolist() == [1]
    # wide but empty-ish window -> sparse (score positive).
    # size_ref=31, num=4 -> density = 33/512; score = 31*0.198 - small - 3.15 > 0
    t = loi.decide_hybrid_type(
        unique_counts=np.array([32]), edge_counts=np.array([33]),
        block_partition=np.array([4]), mode="intended", coeffs=coeffs,
    )
    assert t.tolist() == [0]


def test_degenerate_mode_routes_everything_sparse():
    """The live reference line (.cu:262) is a truthiness test: any nonzero
    score -> 0.  Real windows essentially never score exactly 0.0."""
    rng = np.random.RandomState(0)
    uniq = rng.randint(1, 64, 100)
    nnz = uniq + rng.randint(0, 100, 100)
    blocks = (uniq + 7) // 8
    t = loi.decide_hybrid_type(uniq, nnz, blocks, mode="degenerate")
    assert (t == 0).all()


def test_empty_windows_are_sparse_encoded():
    t = loi.decide_hybrid_type(
        np.array([0]), np.array([0]), np.array([0]), mode="all_dense"
    )
    assert t.tolist() == [0]


def test_fit_logistic_recovers_separator():
    """Fit on synthetically-labelled windows; >90% accuracy like §IV-C."""
    rng = np.random.RandomState(1)
    uniq, nnz = loi.make_training_windows(2000, seed=1)
    blocks = (uniq + 7) // 8
    density = nnz / (np.maximum(blocks, 1) * 16 * 8)
    # ground truth: sparse iff 0.1*uniq - 4*density - 1 > 0 (plus noise)
    score = 0.1 * uniq - 4.0 * density - 1.0
    labels = (score + rng.randn(len(uniq)) * 0.05 > 0).astype(np.float64)
    feats = np.stack([uniq.astype(np.float64), density], 1)
    coeffs = loi.fit_logistic(feats, labels)
    pred = (coeffs.w_cols * uniq + coeffs.w_density * density + coeffs.bias) > 0
    acc = (pred == labels.astype(bool)).mean()
    assert acc > 0.9, acc
    assert coeffs.w_cols > 0 and coeffs.w_density < 0


def test_calibrate_with_fake_timers():
    """Timer-driven calibration: dense wins at high occupancy."""
    def t_dense(uniq, nnz):
        return (uniq + 7) // 8 * 1.0  # cost ~ #blocks

    def t_sparse(uniq, nnz):
        return nnz * 0.05             # cost ~ nnz

    coeffs = loi.calibrate(t_dense, t_sparse, num_samples=512, seed=0)
    uniq, nnz = loi.make_training_windows(512, seed=0)
    blocks = (uniq + 7) // 8
    density = nnz / (np.maximum(blocks, 1) * 16 * 8)
    labels = (nnz * 0.05 < blocks * 1.0)
    pred = (coeffs.w_cols * uniq + coeffs.w_density * density + coeffs.bias) > 0
    assert (pred == labels).mean() > 0.85


def test_explicit_coefficients_override_defaults():
    """Refit coefficients passed explicitly (PlanConfig.loi /
    analyze_windows(loi_coeffs=...)) are honored verbatim; None means the
    reference's values."""
    import numpy as np

    from hcspmm_tpu.config import LOICoefficients
    from hcspmm_tpu.format.windows import analyze_windows
    from hcspmm_tpu.graphs import io

    src, dst, nn = io.synthetic_graph(600, 8, seed=1, span=64)
    rp, ci = io.to_csr(src, dst, nn)
    wa_none = analyze_windows(rp, ci, nn, loi_mode="intended")
    wa_ref = analyze_windows(rp, ci, nn, loi_mode="intended",
                             loi_coeffs=LOICoefficients())
    np.testing.assert_array_equal(wa_none.hybrid_type, wa_ref.hybrid_type)
    # a refit that favours the dense path everywhere it may
    dense_fit = LOICoefficients(w_cols=0.0, w_density=0.0, bias=-1.0,
                                max_cols=1 << 20)
    wa_fit = analyze_windows(rp, ci, nn, loi_mode="intended",
                             loi_coeffs=dense_fit)
    assert wa_fit.hybrid_type.sum() > wa_ref.hybrid_type.sum()
    assert wa_fit.hybrid_type.sum() == (wa_fit.edge_counts > 0).sum()
