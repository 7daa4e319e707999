"""Batched linear C-SVC SMO solver on the device.

Counterpart of ``robust_speech_analysis_framework_tpu/models/svm_device.py``,
where the solver is a ``jax.vmap`` of a ``lax.while_loop``: XLA work, not a
Pallas kernel, so here it is plain torch ops. Every (fold × grid point ×
calibration fold) fit of a CV run is one lane of a single solve: each
iteration steps every lane at once, over (L, n, d) tensors.

The solver is the maximal-violating-pair SMO with the libsvm stopping rule
of the host implementation (models/svm.py:_smo_linear), in float32 as the
JAX package's. Semantics kept from the vmapped ``while_loop``:

* A lane steps while its own condition holds (not done, fewer than
  ``max_iter`` iterations); the loop runs while any lane steps, and every
  update (``alpha``, ``grad``, the iteration count, ``done``) is masked with
  the lane's predicate, so a finished lane is frozen as ``vmap`` freezes it
  and each lane's ``n_iter``, ``w`` and ``b`` are those of JAX.
* ``argmax``/``argmin`` ties take the first index, as ``jnp.argmax`` does;
  masked entries are ``NEG = -1e30``.
* Every product is an elementwise product and a sum, never a matmul, so
  the iterates are IEEE float32 whatever the process-wide TF32 flags.

The loop is stepped from the host, which reads "is any lane still stepping"
once every ``SYNC_EVERY`` steps (a frozen lane's step changes nothing, so
the result equals a check after every step); on the card those steps are
one CUDA graph, replayed. The last solve's step and synchronisation counts
(the loop's reads, not the final fetch) are left in
``smo_linear_batch.steps`` and ``.syncs``.

Padding is exact: rows pad with ``valid=False`` (excluded from pair
selection; zero feature rows contribute nothing to ``w``), features pad
with zero columns (their ``w`` entries stay 0), and a lane whose rows are
all padding has no violating pair and stops at its first iteration. The
JAX package's canonical shape buckets and ``jax.export`` cache serve XLA's
compile cache and are not carried.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

NEG = -1e30  # the masked value of the pair selection (JAX ``:151``)
SYNC_EVERY = 16  # steps between two reads of "is any lane stepping" on the host


def _up_low(alpha: torch.Tensor, y: torch.Tensor, valid: torch.Tensor, C: float):
    pos, neg = y > 0, y < 0
    up = valid & ((pos & (alpha < C)) | (neg & (alpha > 0)))
    low = valid & ((pos & (alpha > 0)) | (neg & (alpha < C)))
    return up, low


def _pick(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[l, idx[l]] for every lane l; ``a`` (L, n) or (L, n, d)."""
    if a.dim() == 2:
        return a.gather(1, idx[:, None])[:, 0]
    return a.gather(1, idx[:, None, None].expand(-1, 1, a.shape[2]))[:, 0]


def _step(X, y, valid, sq, alpha, grad, it, done, C: float, tol: float, max_iter: int):
    """One SMO iteration of every lane, in place, masked to the lanes whose
    loop condition holds (JAX's ``cond``/``body``)."""
    active = (~done) & (it < max_iter)
    yg = -y * grad
    up, low = _up_low(alpha, y, valid, C)
    i = torch.where(up, yg, NEG).argmax(dim=1)
    j = torch.where(low, yg, -NEG).argmin(dim=1)
    m_val, M_val = _pick(yg, i), _pick(yg, j)
    has_pair = up.any(dim=1) & low.any(dim=1)
    converged = (~has_pair) | (m_val - M_val <= tol)

    Xi, Xj = _pick(X, i), _pick(X, j)
    Kij = (Xi * Xj).sum(dim=1)
    eta = torch.clamp_min(_pick(sq, i) + _pick(sq, j) - 2.0 * Kij, 1e-12)
    lam = (m_val - M_val) / eta
    y_i, y_j = _pick(y, i), _pick(y, j)
    a_i, a_j = _pick(alpha, i), _pick(alpha, j)
    lam = torch.minimum(lam, torch.where(y_i > 0, C - a_i, a_i))
    lam = torch.minimum(lam, torch.where(y_j > 0, a_j, C - a_j))
    # host-solver semantics: a non-positive feasible step means a
    # numerically stuck state, and the lane stops (``if lam <= 0: break``)
    take = (~converged) & (lam > 0)
    lam = torch.where(take, lam, 0.0)

    new_alpha = alpha.scatter_add(1, i[:, None], (y_i * lam)[:, None])
    new_alpha = new_alpha.scatter_add(1, j[:, None], (-(y_j * lam))[:, None])
    Ki = (X * Xi[:, None, :]).sum(dim=2)
    Kj = (X * Xj[:, None, :]).sum(dim=2)
    # one rounding, as XLA's CPU backend contracts ``grad + (lam·y)·ΔK`` into
    # a fused multiply-add: the product of two float32 values is exact in
    # float64
    step = (lam[:, None] * y).double() * (Ki - Kj).double()
    new_grad = (grad.double() + step).float()

    keep = active[:, None]
    alpha.copy_(torch.where(keep, new_alpha, alpha))
    grad.copy_(torch.where(keep, new_grad, grad))
    it.add_(active.to(it.dtype))
    done.copy_(torch.where(active, done | (~take), done))


def _finish(X, y, valid, alpha, grad, C: float):
    """(w, b) from the final duals: the free support vectors' mean intercept,
    else the midpoint of the violating-pair bounds."""
    yg = -y * grad
    up, low = _up_low(alpha, y, valid, C)
    m_val = torch.where(up, yg, NEG).amax(dim=1)
    M_val = torch.where(low, yg, -NEG).amin(dim=1)
    m_val = torch.where(up.any(dim=1), m_val, 0.0)
    M_val = torch.where(low.any(dim=1), M_val, 0.0)
    free = valid & (alpha > 1e-12) & (alpha < C - 1e-12)
    n_free = free.sum(dim=1)
    b_free = torch.where(free, yg, 0.0).sum(dim=1) / torch.clamp_min(n_free, 1)
    b = torch.where(n_free > 0, b_free, (m_val + M_val) / 2.0)
    w = ((alpha * y)[:, :, None] * X).sum(dim=1)
    return w, b


def smo_linear_batch(
    X: np.ndarray,
    y_pm: np.ndarray,
    valid: np.ndarray,
    C: float = 1.0,
    tol: float = 1e-3,
    max_iter: int = 100_000,
    device: DeviceLike = "cuda",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Solve L independent linear C-SVC duals at once on ``device``.

    Args:
      X: (L, n, d) float32: zero rows where invalid, zero columns for
        feature padding.
      y_pm: (L, n) ±1 labels (the value at invalid rows is ignored).
      valid: (L, n) bool row mask.

    Returns host arrays ``(w, b, n_iter)`` of shapes (L, d), (L,), (L,).
    """
    dev = resolve_device(device)
    X = torch.as_tensor(np.ascontiguousarray(X, np.float32)).to(dev)
    y = torch.as_tensor(np.ascontiguousarray(y_pm, np.float32)).to(dev)
    valid = torch.as_tensor(np.ascontiguousarray(valid, bool)).to(dev)
    L, n, _ = X.shape
    C, tol = float(C), float(tol)

    sq = (X * X).sum(dim=2)
    alpha = torch.zeros((L, n), dtype=torch.float32, device=dev)
    grad = torch.full((L, n), -1.0, dtype=torch.float32, device=dev)
    it = torch.zeros(L, dtype=torch.int32, device=dev)
    done = torch.zeros(L, dtype=torch.bool, device=dev)

    def step():
        _step(X, y, valid, sq, alpha, grad, it, done, C, tol, max_iter)

    def stepping() -> bool:
        return bool(((~done) & (it < max_iter)).any())

    loop = _loop_graph if dev.type == "cuda" else _loop_eager
    steps, syncs = loop(step, stepping, max_iter)
    w, b = _finish(X, y, valid, alpha, grad, C)
    smo_linear_batch.steps, smo_linear_batch.syncs = steps, syncs
    return w.cpu().numpy(), b.cpu().numpy(), it.cpu().numpy()


def _loop_eager(step, stepping, max_iter: int) -> Tuple[int, int]:
    """Step until no lane steps, reading that every SYNC_EVERY steps;
    returns (steps, reads)."""
    steps = syncs = 0
    while steps < max_iter:
        step()
        steps += 1
        if steps % SYNC_EVERY == 0:
            syncs += 1
            if not stepping():
                break
    return steps, syncs


def _loop_graph(step, stepping, max_iter: int) -> Tuple[int, int]:
    """:func:`_loop_eager` with the SYNC_EVERY steps between two reads
    replayed as one CUDA graph: the same kernels on the same buffers (the
    state is updated in place), so the same bits, without the host's
    launch overhead on every small kernel. The first chunk runs eagerly on
    a side stream, the warm-up that capture needs, and counts as steps."""
    chunk = min(SYNC_EVERY, max_iter)

    def run_chunk():
        for _ in range(chunk):
            step()

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run_chunk()
    torch.cuda.current_stream().wait_stream(side)
    steps, syncs = chunk, 1
    if steps >= max_iter or not stepping():
        return steps, syncs
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run_chunk()
    while steps < max_iter:
        graph.replay()
        steps += chunk
        syncs += 1
        if not stepping():
            break
    return steps, syncs


smo_linear_batch.steps = smo_linear_batch.syncs = 0
