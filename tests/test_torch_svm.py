"""The port's SVM stack vs the JAX package's, on the CPU.

``models/svm.py`` is a numpy copy: bit for bit on seeded data.

The batched SMO (``models/svm_device.py``) is torch ops where the JAX
package vmaps a ``lax.while_loop``. Its maximal-violating-pair selection
meets exact ties by construction (after an unclipped step the two updated
points' gradients are equal in exact arithmetic), and the last bit of a dot
product breaks them; XLA and torch add the d products of a dot in different
orders. So the two follow the same path, step for step, where every dot
product is exact in float32: features on a small integer lattice. There
both give equal iteration counts per lane and ``w``/``b`` within 1e-5 (the
final ``w`` and ``b`` are sums of non-integers, added in other orders). On
Gaussian features the paths part at the first such tie, and each solver is
held to the float64 host solver within SOLUTION_TOL: the solvers stop
anywhere inside the stopping rule's ε = 1e-3 band (the JAX solver's own
lanes lie up to 1.1e-3 from the float64 weights on these data).
"""

import numpy as np
import pytest
import torch

from robust_speech_analysis_framework_tpu.models import svm as jax_svm
from robust_speech_analysis_framework_tpu.models.svm_device import (
    smo_linear_batch as jax_smo_linear_batch,
)
from robust_speech_analysis_framework_tpu_torch.models import svm, svm_device
from tests.test_torch_train import one_torch_thread  # noqa: F401  (autouse fixture)

SOLUTION_TOL = 5e-3


@pytest.fixture
def data():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(90, 25))
    y = (X[:, 0] + 0.5 * X[:, 1] - 0.3 * X[:, 4] + rng.normal(0, 0.6, 90) > 0).astype(int)
    return X, y


# --- models/svm.py: a copy, bit for bit ------------------------------------------------------


def test_scaler_and_anova_bit_equal(data):
    X, y = data
    X = X.copy()
    X[:, 3] = 1.0  # a constant feature
    np.testing.assert_array_equal(svm.StandardScaler().fit_transform(X),
                                  jax_svm.StandardScaler().fit_transform(X))
    ours, theirs = svm.f_classif(X, y)[0], jax_svm.f_classif(X, y)[0]
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("k", [1, 10, 25, 40])
def test_select_k_best_bit_equal(data, k):
    X, y = data
    ours = svm.SelectKBest(svm.f_classif, k=k).fit(X, y)
    theirs = jax_svm.SelectKBest(jax_svm.f_classif, k=k).fit(X, y)
    np.testing.assert_array_equal(ours.get_support(), theirs.get_support())
    np.testing.assert_array_equal(ours.transform(X), theirs.transform(X))


@pytest.mark.parametrize("C", [1.0, 0.05])
def test_host_smo_bit_equal(data, C):
    X, y = data
    y_pm = np.where(y == 1, 1.0, -1.0)
    for ours, theirs in zip(svm._smo_linear(X, y_pm, C), jax_svm._smo_linear(X, y_pm, C)):
        np.testing.assert_array_equal(ours, theirs)


def test_platt_bit_equal(data):
    X, y = data
    f = X[:, 0] * 2.0 + 0.3
    assert svm.fit_platt_sigmoid(f, y) == jax_svm.fit_platt_sigmoid(f, y)


@pytest.mark.parametrize("probability", [True, False])
def test_linear_svc_and_pipeline_bit_equal(data, probability):
    X, y = data
    ours = svm.LinearSVC(C=0.5, probability=probability, random_state=3).fit(X, y)
    theirs = jax_svm.LinearSVC(C=0.5, probability=probability, random_state=3).fit(X, y)
    np.testing.assert_array_equal(ours.coef_, theirs.coef_)
    assert ours.intercept_ == theirs.intercept_
    np.testing.assert_array_equal(ours.predict(X), theirs.predict(X))
    if probability:
        np.testing.assert_array_equal(ours.predict_proba(X), theirs.predict_proba(X))
    p_ours = svm.SVMPipeline(k=7, probability=probability).fit(X, y)
    p_theirs = jax_svm.SVMPipeline(k=7, probability=probability).fit(X, y)
    np.testing.assert_array_equal(p_ours.get_support(), p_theirs.get_support())
    np.testing.assert_array_equal(p_ours.decision_function(X), p_theirs.decision_function(X))


def test_linear_svc_rejects_more_than_two_classes(data):
    X, _ = data
    with pytest.raises(ValueError, match="binary"):
        svm.LinearSVC().fit(X, np.arange(len(X)) % 3)


# --- the batched SMO ---------------------------------------------------------------------------


def _lanes(seed: int, lattice: bool, L: int = 9, n: int = 29, d: int = 14):
    """L-1 ragged problems (rows 8..n, features 3..d, zero padding) and one
    all-padding lane; features on the integer lattice {-2..2} or Gaussian."""
    rng = np.random.default_rng(seed)
    X = np.zeros((L, n, d), np.float32)
    y = np.ones((L, n), np.float32)
    valid = np.zeros((L, n), bool)
    for lane in range(L - 1):
        nl, dl = int(rng.integers(8, n + 1)), int(rng.integers(3, d + 1))
        x = (rng.integers(-2, 3, size=(nl, dl)) if lattice else rng.normal(size=(nl, dl)))
        x = x.astype(np.float32)
        y_l = np.where(x[:, 0] + x[:, 1] + rng.normal(size=nl) > 0, 1.0, -1.0)
        y_l[:2] = (1.0, -1.0)  # both classes in every lane
        X[lane, :nl, :dl], y[lane, :nl], valid[lane, :nl] = x, y_l, True
    return X, y, valid


@pytest.mark.parametrize("C", [1.0, 0.1])
@pytest.mark.parametrize("seed", [0, 1])
def test_smo_follows_jax_step_for_step_on_exact_products(seed, C):
    X, y, valid = _lanes(seed, lattice=True)
    w_j, b_j, it_j = jax_smo_linear_batch(X, y, valid, C=C)
    w, b, it = svm_device.smo_linear_batch(X, y, valid, C=C, device="cpu")
    np.testing.assert_array_equal(it, it_j)
    assert it[-1] == 1  # the all-padding lane stops at once
    np.testing.assert_allclose(w, w_j, atol=1e-5)
    np.testing.assert_allclose(b, b_j, atol=1e-5)
    assert (w[-1] == 0).all()


def test_smo_stops_at_max_iter_as_jax():
    X, y, valid = _lanes(2, lattice=True)
    _, _, it_j = jax_smo_linear_batch(X, y, valid, max_iter=5)
    w, b, it = svm_device.smo_linear_batch(X, y, valid, max_iter=5, device="cpu")
    np.testing.assert_array_equal(it, it_j)
    assert it.max() == 5 and svm_device.smo_linear_batch.steps == 5


@pytest.mark.parametrize("C", [1.0, 0.1])
def test_smo_solution_on_gaussian_features(C):
    """Both float32 solvers within SOLUTION_TOL of the float64 host SMO."""
    X, y, valid = _lanes(3, lattice=False)
    w_j, b_j, _ = jax_smo_linear_batch(X, y, valid, C=C)
    w, b, it = svm_device.smo_linear_batch(X, y, valid, C=C, device="cpu")
    for lane in range(len(X) - 1):
        rows = valid[lane]
        w64, b64, _ = svm._smo_linear(X[lane, rows].astype(np.float64),
                                      y[lane, rows].astype(np.float64), C)
        for w_, b_ in ((w[lane], b[lane]), (w_j[lane], b_j[lane])):
            np.testing.assert_allclose(w_, w64, atol=SOLUTION_TOL)
            assert abs(b_ - b64) <= SOLUTION_TOL
    assert (it < 100_000).all()


def test_padding_is_exact_on_exact_products():
    """More padding rows and zero feature columns change nothing."""
    X, y, valid = _lanes(4, lattice=True)
    L, n, d = X.shape
    Xp = np.zeros((L, n + 7, d + 5), np.float32)
    Xp[:, :n, :d] = X
    yp = np.ones((L, n + 7), np.float32)
    yp[:, :n] = y
    vp = np.zeros((L, n + 7), bool)
    vp[:, :n] = valid
    w, b, it = svm_device.smo_linear_batch(X, y, valid, device="cpu")
    w_p, b_p, it_p = svm_device.smo_linear_batch(Xp, yp, vp, device="cpu")
    np.testing.assert_array_equal(it_p, it)
    np.testing.assert_allclose(w_p[:, :d], w, atol=1e-6)
    assert (w_p[:, d:] == 0).all()
    np.testing.assert_allclose(b_p, b, atol=1e-6)


def test_host_syncs_do_not_change_the_result(monkeypatch):
    """Reading "any lane stepping" every step or every 16 gives the same bits;
    the counters say how many steps and reads the loop took."""
    X, y, valid = _lanes(5, lattice=False)
    w, b, it = svm_device.smo_linear_batch(X, y, valid, device="cpu")
    steps, syncs = svm_device.smo_linear_batch.steps, svm_device.smo_linear_batch.syncs
    assert it.max() <= steps < it.max() + svm_device.SYNC_EVERY
    assert syncs == steps // svm_device.SYNC_EVERY
    monkeypatch.setattr(svm_device, "SYNC_EVERY", 1)
    w1, b1, it1 = svm_device.smo_linear_batch(X, y, valid, device="cpu")
    np.testing.assert_array_equal(it1, it)
    np.testing.assert_array_equal(w1, w)
    np.testing.assert_array_equal(b1, b)
    assert svm_device.smo_linear_batch.steps == it.max() == svm_device.smo_linear_batch.syncs


def test_smo_ties_take_the_first_index():
    """Duplicate rows tie exactly at every step: the first index wins, as in
    ``jnp.argmax``, so both solvers agree on a problem made of ties."""
    x = np.array([[1.0, 0.0], [1.0, 0.0], [-1.0, 0.0], [-1.0, 0.0]], np.float32)
    X, y = x[None], np.array([[1.0, 1.0, -1.0, -1.0]], np.float32)
    valid = np.ones((1, 4), bool)
    w_j, b_j, it_j = jax_smo_linear_batch(X, y, valid)
    w, b, it = svm_device.smo_linear_batch(X, y, valid, device="cpu")
    np.testing.assert_array_equal(it, it_j)
    np.testing.assert_allclose(w, w_j, atol=1e-7)
    np.testing.assert_allclose(b, b_j, atol=1e-7)


def test_smo_is_float32_and_returns_host_arrays():
    X, y, valid = _lanes(6, lattice=True)
    w, b, it = svm_device.smo_linear_batch(X.astype(np.float64), y, valid, device="cpu")
    assert w.dtype == b.dtype == np.float32 and it.dtype == np.int32
    assert w.shape == (X.shape[0], X.shape[2]) and b.shape == it.shape == (X.shape[0],)
    assert isinstance(w, np.ndarray) and not torch.is_tensor(w)
