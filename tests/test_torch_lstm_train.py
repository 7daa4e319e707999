"""Port's LSTM training functions (plain PyTorch versions of K3, K4 with its
gate pre-pass and its sweep over activated gates, the dWh kernel, and K5) vs
the JAX package, on the CPU.

The same seeded numpy inputs go through the JAX package's Pallas training
kernels in interpret mode, ``jax.vjp`` of its scan reference, and the port.
Tolerances: atol 1e-5 for hs, cs and dgates (float32 recurrences over 37
steps, summed in other orders); dWh, a sum over T·B products, rtol and atol
1e-4, as the JAX package's own test of its backward kernel states.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from robust_speech_analysis_framework_tpu.models.cnn_lstm import _lstm_scan as jax_frozen_scan
from robust_speech_analysis_framework_tpu.ops.pallas import lstm as jax_lstm
from robust_speech_analysis_framework_tpu_torch.ops.cuda import lstm as port_lstm

ATOL = 1e-5
DWH_TOL = 1e-4
T, G, B, H = 37, 2, 3, 8  # T is not a multiple of the Pallas time block (8)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    gates = (rng.normal(size=(T, G, B, 4 * H)) * 0.5).astype(np.float32)
    wh = (rng.normal(size=(G, H, 4 * H)) * 0.3).astype(np.float32)
    dhout = rng.normal(size=(T, G, B, H)).astype(np.float32)
    return gates, wh, dhout


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_fwd_res_matches_pallas_interpret(inputs):
    gates, wh, _ = inputs
    hs, cs = jax_lstm._lstm_fwd_res_pallas(jnp.asarray(gates), jnp.asarray(wh), 8, True)
    ours_hs, ours_cs = port_lstm.lstm_scan_fwd_res_reference_grouped(*_t(gates, wh))
    np.testing.assert_allclose(ours_hs.numpy(), np.asarray(hs), atol=ATOL)
    np.testing.assert_allclose(ours_cs.numpy(), np.asarray(cs), atol=ATOL)


def test_bwd_matches_pallas_interpret(inputs):
    """Plain K4 (dWh included) against the TPU backward kernel in interpret
    mode, which pads T to its block and sweeps the padded tail."""
    gates, wh, dhout = inputs
    hs, cs = jax_lstm._lstm_fwd_res_pallas(jnp.asarray(gates), jnp.asarray(wh), 8, True)
    ref_dg, ref_dwh = jax_lstm._lstm_bwd_pallas(
        jnp.asarray(gates), hs, cs, jnp.asarray(wh), jnp.asarray(dhout), 8, True)
    dg, dwh = port_lstm.lstm_scan_bwd_reference_grouped(
        *_t(gates, np.asarray(hs), np.asarray(cs), wh, dhout))
    np.testing.assert_allclose(dg.numpy(), np.asarray(ref_dg), atol=ATOL)
    np.testing.assert_allclose(dwh.numpy(), np.asarray(ref_dwh), rtol=DWH_TOL, atol=DWH_TOL)


def _jax_gate_acts(gates, hs, wh):
    """i, f, g, o of every step as the TPU backward kernel's step recomputes
    them: z = gates_t + h_{t-1} @ Wh with h_{-1} = 0, then the activations."""
    hprev = jnp.concatenate([jnp.zeros_like(hs[:1]), hs[:-1]], axis=0)
    z = jnp.asarray(gates) + jnp.einsum("tgbk,gkj->tgbj", hprev, jnp.asarray(wh))
    h_dim = hs.shape[-1]
    return jnp.concatenate([
        jax.nn.sigmoid(z[..., : 2 * h_dim]),
        jnp.tanh(z[..., 2 * h_dim : 3 * h_dim]),
        jax.nn.sigmoid(z[..., 3 * h_dim :]),
    ], axis=-1)


@pytest.mark.parametrize("t_len", [T, 1], ids=["ragged", "single-step"])
def test_gate_acts_match_jax_step(inputs, t_len):
    """The plain pre-pass against the JAX step's activations (1e-6), at every
    t including t = 0 (no h_{t-1} term), and against the TPU forward kernel's
    own hs and cs: c_t = f c_{t-1} + i g, h_t = o tanh(c_t)."""
    gates, wh, _ = inputs
    gates = gates[:t_len]
    hs, cs = jax_lstm._lstm_fwd_res_pallas(jnp.asarray(gates), jnp.asarray(wh), 8, True)
    acts = port_lstm.lstm_gate_acts_reference_grouped(*_t(gates, np.asarray(hs), wh))
    assert acts.shape == gates.shape and acts.dtype == torch.float32
    np.testing.assert_allclose(acts.numpy(), np.asarray(_jax_gate_acts(gates, hs, wh)),
                               rtol=0, atol=1e-6)
    i, f, g_, o = (a.numpy() for a in acts.split(H, dim=-1))
    np.testing.assert_allclose(i[0], 1 / (1 + np.exp(-gates[0, ..., :H].astype(np.float64))),
                               rtol=0, atol=1e-6)
    cprev = np.concatenate([np.zeros_like(cs[:1]), np.asarray(cs)[:-1]])
    np.testing.assert_allclose(f * cprev + i * g_, np.asarray(cs), atol=ATOL)
    np.testing.assert_allclose(o * np.tanh(np.asarray(cs)), np.asarray(hs), atol=ATOL)


def test_sweep_from_acts_equals_plain_sweep(inputs):
    """Pre-pass then sweep is K4's plain version split in two: the same
    products and activations in the same order, so dgates are equal bit for
    bit; and they match the TPU backward kernel in interpret mode."""
    gates, wh, dhout = inputs
    hs, cs = jax_lstm._lstm_fwd_res_pallas(jnp.asarray(gates), jnp.asarray(wh), 8, True)
    g_t, h_t, c_t, w_t, d_t = _t(gates, np.asarray(hs), np.asarray(cs), wh, dhout)
    acts = port_lstm.lstm_gate_acts_reference_grouped(g_t, h_t, w_t)
    dg = port_lstm.lstm_sweep_from_acts_reference_grouped(acts, c_t, w_t, d_t)
    ref_dg, _ = port_lstm.lstm_scan_bwd_reference_grouped(g_t, h_t, c_t, w_t, d_t)
    assert torch.equal(dg, ref_dg)
    jax_dg, _ = jax_lstm._lstm_bwd_pallas(
        jnp.asarray(gates), hs, cs, jnp.asarray(wh), jnp.asarray(dhout), 8, True)
    np.testing.assert_allclose(dg.numpy(), np.asarray(jax_dg), atol=ATOL)


def test_sweep_from_acts_single_step():
    """T = 1: dh = dc = 0 on entry and c_{-1} = 0, so dz is dhout times the
    o and cell factors, and the forget gate's dz is zero."""
    rng = np.random.default_rng(7)
    acts = torch.from_numpy(rng.uniform(0.1, 0.9, size=(1, 2, 3, 32)).astype(np.float32))
    cs = torch.from_numpy(rng.normal(size=(1, 2, 3, 8)).astype(np.float32))
    wh = torch.from_numpy((rng.normal(size=(2, 8, 32)) * 0.3).astype(np.float32))
    dhout = torch.from_numpy(rng.normal(size=(1, 2, 3, 8)).astype(np.float32))
    dg = port_lstm.lstm_sweep_from_acts_reference_grouped(acts, cs, wh, dhout)
    i, f, g_, o = acts[0].split(8, dim=-1)
    tc = torch.tanh(cs[0])
    dct = dhout[0] * o * (1.0 - tc * tc)
    ref = torch.cat([dct * g_ * i * (1.0 - i), torch.zeros_like(f),
                     dct * i * (1.0 - g_ * g_), dhout[0] * tc * o * (1.0 - o)], dim=-1)
    torch.testing.assert_close(dg[0], ref, rtol=0, atol=1e-7)


def test_bwd_matches_jax_vjp_of_scan(inputs):
    gates, wh, dhout = inputs
    _, vjp = jax.vjp(jax_lstm.lstm_scan_reference_grouped, jnp.asarray(gates), jnp.asarray(wh))
    ref_dg, ref_dwh = vjp(jnp.asarray(dhout))
    g_t, w_t, d_t = _t(gates, wh, dhout)
    hs, cs = port_lstm.lstm_scan_fwd_res_grouped(g_t, w_t)
    dg, dwh = port_lstm.lstm_scan_bwd_grouped(g_t, hs, cs, w_t, d_t)
    np.testing.assert_allclose(dg.numpy(), np.asarray(ref_dg), atol=ATOL)
    np.testing.assert_allclose(dwh.numpy(), np.asarray(ref_dwh), rtol=DWH_TOL, atol=DWH_TOL)


def test_dwh_is_the_shifted_product(inputs):
    """dWh = Σ_{t≥1, b} h_{t-1}ᵀ dz_t, written out in float64 numpy."""
    gates, wh, dhout = inputs
    hs, cs = port_lstm.lstm_scan_fwd_res_grouped(*_t(gates, wh))
    dg, dwh = port_lstm.lstm_scan_bwd_grouped(*_t(gates), hs, cs, *_t(wh, dhout))
    h64, d64 = hs.double().numpy(), dg.double().numpy()
    ref = np.zeros((G, H, 4 * H))
    for t in range(1, T):
        for g in range(G):
            ref[g] += h64[t - 1, g].T @ d64[t, g]
    np.testing.assert_allclose(port_lstm.lstm_dwh_grouped(hs, dg).numpy(), ref,
                               rtol=DWH_TOL, atol=DWH_TOL)
    torch.testing.assert_close(port_lstm.lstm_dwh_grouped(hs, dg), dwh, rtol=0, atol=0)


DWH_SPLIT_CASES = [  # n_rows = (T-1)·B, G, H
    (0, 2, 128), (1, 2, 8), (3, 2, 8), (31, 1, 64), (32, 1, 64), (33, 1, 64), (97, 3, 24),
    (567, 1, 40), (997, 2, 64), (3149, 2, 64), (5083, 2, 128), (32749, 2, 128),
    (32760, 2, 128), (32760, 2, 64), (65472, 2, 128), (4095, 140, 128),
]


@pytest.mark.parametrize("n_rows,g,h", DWH_SPLIT_CASES)
def test_dwh_split_plan(n_rows, g, h):
    """The slices cover every row exactly once, are whole chunks but for the
    last, are never more than the chunks, and their blocks fit one wave of
    the SMs where one slice's blocks do."""
    slices, rows = port_lstm._dwh_split(n_rows, g, h, 132)
    covered = np.zeros(n_rows, np.int64)
    for s in range(slices):
        covered[s * rows : min(n_rows, (s + 1) * rows)] += 1
    assert (covered == 1).all()
    assert slices >= 1 and rows % port_lstm.DWH_CHUNK == 0
    assert slices <= max(1, -(-n_rows // port_lstm.DWH_CHUNK))
    assert n_rows == 0 or (slices - 1) * rows < n_rows  # no empty slice
    tiles = -(-4 * h // port_lstm.DWH_COLS) * g
    assert slices == 1 or slices * tiles <= 132
    if (n_rows, g, h) == (32760, 2, 128):  # the training shape: 128 blocks
        assert (slices, rows) == (16, 2048)


@pytest.mark.parametrize("t_len,g,b,h", [
    (1, 2, 3, 16), (2, 2, 3, 8), (37, 2, 3, 8), (64, 1, 9, 40), (33, 2, 5, 24),
    (48, 2, 67, 64), (300, 3, 1, 64), (120, 2, 17, 128),
])
def test_dwh_split_emulated(t_len, g, b, h):
    """Plain partial sums per slice of the rows, added in slice order as the
    kernel's second pass adds them, equal the plain dWh to 1e-5 of its scale
    (and are all zeros at T = 1)."""
    rng = np.random.default_rng(t_len * b + h)
    hs = torch.from_numpy(rng.uniform(-1, 1, size=(t_len, g, b, h)).astype(np.float32))
    dg = torch.from_numpy(rng.normal(size=(t_len, g, b, 4 * h)).astype(np.float32))
    n_rows = (t_len - 1) * b
    slices, rows = port_lstm._dwh_split(n_rows, g, h, 132)
    # row n = (t - 1)·B + b pairs hs[t-1, :, b] with dgates[t, :, b]
    a = hs[:-1].permute(1, 0, 2, 3).reshape(g, n_rows, h)
    d = dg[1:].permute(1, 0, 2, 3).reshape(g, n_rows, 4 * h)
    dwh = torch.zeros(g, h, 4 * h)
    for s in range(slices):
        lo, hi = s * rows, min(n_rows, (s + 1) * rows)
        part = torch.bmm(a[:, lo:hi].transpose(1, 2), d[:, lo:hi])
        dwh = part if s == 0 else dwh + part
    ref = port_lstm.lstm_dwh_reference_grouped(hs, dg)
    scale = max(1.0, float(ref.abs().max())) if n_rows else 1.0
    assert float((dwh - ref).abs().max()) <= 1e-5 * scale
    if t_len == 1:
        assert not dwh.any() and slices == 1


ACTS_PLAN_CASES = [  # n_rows = T·B, G, H, SMs
    (1, 1, 8, 132), (5, 2, 8, 132), (111, 2, 24, 132), (128, 1, 40, 132), (129, 3, 64, 132),
    (700, 1, 64, 132), (3216, 3, 128, 132), (32768, 2, 128, 132), (8704, 16, 128, 132),
    (8704, 16, 64, 132), (4800, 16, 64, 7), (291, 16, 128, 132), (65536, 140, 128, 132),
]


@pytest.mark.parametrize("n_rows,g,h,n_sms", ACTS_PLAN_CASES)
def test_gate_acts_plan(n_rows, g, h, n_sms):
    """The pre-pass's blocks take every (row tile, column tile, direction)
    exactly once, no block is empty, the grid is one wave (one block an SM:
    each holds more than half an SM's shared memory), and the training
    shape gets the plan the kernel's comment states."""
    plan = port_lstm._acts_plan(n_rows, g, h, n_sms)
    items = g * plan.col_tiles * plan.row_tiles
    assert plan.row_tiles * port_lstm.ACTS_ROWS >= n_rows > (plan.row_tiles - 1) * port_lstm.ACTS_ROWS
    assert plan.col_tiles * port_lstm.ACTS_COLS >= 4 * h > (plan.col_tiles - 1) * port_lstm.ACTS_COLS
    covered = np.zeros((g, plan.col_tiles, plan.row_tiles), np.int64)
    for block in range(plan.grid):
        run = range(block * plan.per, min(items, (block + 1) * plan.per))
        assert len(run) >= 1
        for w in run:
            cg, rt = divmod(w, plan.row_tiles)
            covered[cg // plan.col_tiles, cg % plan.col_tiles, rt] += 1
    assert (covered == 1).all()
    assert 1 <= plan.grid <= n_sms
    assert 2 * plan.smem_bytes > 232448 >= plan.smem_bytes
    if (n_rows, g, h) == (32768, 2, 128):  # T=4096 B=8
        assert plan == (128, 16, 256, 4, 186368)


@pytest.mark.parametrize("h", [8, 24, 40, 64, 128])
def test_gate_acts_smem_fits_a_block(h):
    """Wh's column tile, the ring of hs chunks and the gate inputs fit the
    227 KB a block may hold at every hidden size the kernels take."""
    plan = port_lstm._acts_plan(1000, 2, h)
    k_rows = -(-h // port_lstm.ACTS_K) * port_lstm.ACTS_K
    assert plan.smem_bytes == 4 * (k_rows * 128 + 3 * 128 * 36 + 128 * 128) <= 232448


def _emulated_gate_acts(gates, hs, wh, n_sms):
    """The pre-pass as its kernel orders the arithmetic, in float32: item by
    item of the plan, a tile of 128 rows (row n = t·B + b reads hs[t-1],
    zeros at t = 0 and past T·B) by 128 columns, each sum over k ascending
    (zero-padded to whole chunks of 32) with one fused multiply-add a term
    (float64 product and sum, rounded once to float32), the gate input
    added last, then the column's activation. Returns the output and how
    many times each element was written."""
    t_len, g, b, four_h = gates.shape
    h = four_h // 4
    n_rows = t_len * b
    plan = port_lstm._acts_plan(n_rows, g, h, n_sms)
    k_rows = -(-h // port_lstm.ACTS_K) * port_lstm.ACTS_K
    rows = port_lstm.ACTS_ROWS
    # (G, n_rows, ·) views: row n of gates is (t, b); of hs, (t-1, b)
    g_rows = gates.permute(1, 0, 2, 3).reshape(g, n_rows, four_h)
    h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]]).permute(1, 0, 2, 3).reshape(g, n_rows, h)
    out = torch.full((g, n_rows, four_h), float("nan"))
    writes = torch.zeros((g, n_rows, four_h), dtype=torch.int64)
    items = g * plan.col_tiles * plan.row_tiles
    for block in range(plan.grid):
        for w in range(block * plan.per, min(items, (block + 1) * plan.per)):
            cg, rt = divmod(w, plan.row_tiles)
            d, j0, n0 = cg // plan.col_tiles, (cg % plan.col_tiles) * port_lstm.ACTS_COLS, rt * rows
            n1, j1 = min(n_rows, n0 + rows), min(four_h, j0 + port_lstm.ACTS_COLS)
            a = torch.zeros(rows, k_rows, dtype=torch.float64)
            a[: n1 - n0, :h] = h_prev[d, n0:n1].double()
            wt = torch.zeros(k_rows, j1 - j0, dtype=torch.float64)
            wt[:h] = wh[d, :, j0:j1].double()
            acc = torch.zeros(rows, j1 - j0, dtype=torch.float32)
            for k in range(k_rows):
                acc = (a[:, k : k + 1] * wt[k] + acc.double()).float()
            z = g_rows[d, n0:n1, j0:j1] + acc[: n1 - n0]
            cols = torch.arange(j0, j1)
            tanh = (cols // h == 2)[None]
            out[d, n0:n1, j0:j1] = torch.where(tanh, torch.tanh(z), torch.sigmoid(z))
            writes[d, n0:n1, j0:j1] += 1
    back = lambda x: x.reshape(g, t_len, b, four_h).permute(1, 0, 2, 3)
    return back(out), back(writes)


@pytest.mark.parametrize("t_len,g,b,h,n_sms", [
    (1, 2, 3, 16, 132), (2, 2, 1, 8, 132), (37, 2, 3, 8, 132), (37, 2, 3, 24, 132),
    (64, 1, 9, 40, 132), (300, 3, 1, 64, 132), (48, 3, 67, 16, 132), (97, 2, 3, 64, 5),
    (40, 2, 7, 32, 3),
])
def test_gate_acts_emulated(t_len, g, b, h, n_sms):
    """A float32 emulation of the pre-pass's tiles and order equals the
    plain version to 1e-5 of its scale, writes every element exactly once
    and nothing else (T = 1: the gate inputs alone); at a few SMs the
    blocks walk runs that cross column groups."""
    rng = np.random.default_rng(t_len * b + h)
    gates = torch.from_numpy((rng.normal(size=(t_len, g, b, 4 * h)) * 2).astype(np.float32))
    hs = torch.from_numpy(rng.uniform(-1, 1, size=(t_len, g, b, h)).astype(np.float32))
    wh = torch.from_numpy((rng.uniform(-1, 1, size=(g, h, 4 * h)) / h**0.5).astype(np.float32))
    got, writes = _emulated_gate_acts(gates, hs, wh, n_sms)
    ref = port_lstm.lstm_gate_acts_reference_grouped(gates, hs, wh)
    assert (writes == 1).all()
    scale = max(1.0, float(ref.abs().max()))
    assert float((got - ref).abs().max()) <= 1e-5 * scale
    if t_len == 1:
        first = port_lstm.lstm_gate_acts_reference_grouped(gates, torch.zeros_like(hs), wh)
        assert torch.equal(ref, first)


def test_autograd_function_matches_autograd_of_plain_forward(inputs):
    gates, wh, dhout = inputs
    g1, w1 = (x.clone().requires_grad_() for x in _t(gates, wh))
    g2, w2 = (x.clone().requires_grad_() for x in _t(gates, wh))
    hs1 = port_lstm.lstm_recurrence_grouped(g1, w1)
    hs2 = port_lstm.lstm_scan_reference_grouped(g2, w2)
    torch.testing.assert_close(hs1, hs2, rtol=0, atol=0)
    d = torch.from_numpy(dhout)
    hs1.backward(d)
    hs2.backward(d)
    torch.testing.assert_close(g1.grad, g2.grad, rtol=0, atol=ATOL)
    torch.testing.assert_close(w1.grad, w2.grad, rtol=DWH_TOL, atol=DWH_TOL)


def test_autograd_function_gradcheck_float64():
    """K5's backward is the derivative of its forward (finite differences in
    float64; the plain versions accept float64 on the CPU)."""
    rng = np.random.default_rng(5)
    gates = torch.from_numpy(rng.normal(size=(6, 2, 2, 16)) * 0.5).requires_grad_()
    wh = torch.from_numpy(rng.normal(size=(2, 4, 16)) * 0.3).requires_grad_()
    assert torch.autograd.gradcheck(port_lstm.lstm_recurrence_grouped, (gates, wh))
    assert torch.autograd.gradcheck(port_lstm.lstm_recurrence, (gates[:, 0], wh[0]))


def test_single_direction_matches_jax_custom_vjp(inputs):
    """K5 at G = 1 against the JAX package's ``lstm_recurrence`` (its CPU
    branch: jax.vjp of the scan)."""
    gates, wh, dhout = inputs
    g0, w0, d0 = gates[:, 0], wh[0], dhout[:, 0]

    def loss(g, w):
        return jnp.sum(jax_lstm.lstm_recurrence(g, w) * d0)

    ref_dg, ref_dwh = jax.grad(loss, argnums=(0, 1))(jnp.asarray(g0), jnp.asarray(w0))
    g_t, w_t = (x.clone().requires_grad_() for x in _t(g0, w0))
    (port_lstm.lstm_recurrence(g_t, w_t) * torch.from_numpy(d0)).sum().backward()
    np.testing.assert_allclose(g_t.grad.numpy(), np.asarray(ref_dg), atol=ATOL)
    np.testing.assert_allclose(w_t.grad.numpy(), np.asarray(ref_dwh), rtol=DWH_TOL, atol=DWH_TOL)


def test_ragged_tail_matches_frozen_scan(inputs):
    """The port runs the recurrence on past a sequence's length (like the
    TPU kernel); the JAX CPU path freezes state there. With dL/dh zero past
    the length, as the model's attention mask makes it, both give the same
    gradients for every gate and for Wh."""
    gates, wh, dhout = inputs
    lengths = np.array([37, 20, 5], np.int32)
    alive = (np.arange(T)[:, None] < lengths[None, :])[:, :, None]  # (T, B, 1)
    d0 = np.where(alive, dhout[:, 0], 0.0).astype(np.float32)
    _, vjp = jax.vjp(lambda g, w: jax_frozen_scan(g, w, jnp.asarray(lengths)),
                     jnp.asarray(gates[:, 0]), jnp.asarray(wh[0]))
    ref_dg, ref_dwh = vjp(jnp.asarray(d0))
    g_t, w_t = (x.clone().requires_grad_() for x in _t(gates[:, 0], wh[0]))
    (port_lstm.lstm_recurrence(g_t, w_t) * torch.from_numpy(d0)).sum().backward()
    np.testing.assert_allclose(g_t.grad.numpy(), np.asarray(ref_dg), atol=ATOL)
    np.testing.assert_allclose(w_t.grad.numpy(), np.asarray(ref_dwh), rtol=DWH_TOL, atol=DWH_TOL)
    assert not g_t.grad.numpy()[~np.broadcast_to(alive, g_t.grad.shape)].any()


def test_single_step_sequence():
    """T = 1: no h_{t-1} term, so dWh is zero; dgates still match JAX."""
    rng = np.random.default_rng(6)
    gates = (rng.normal(size=(1, 2, 3, 32)) * 0.5).astype(np.float32)
    wh = (rng.normal(size=(2, 8, 32)) * 0.3).astype(np.float32)
    dhout = rng.normal(size=(1, 2, 3, 8)).astype(np.float32)
    _, vjp = jax.vjp(jax_lstm.lstm_scan_reference_grouped, jnp.asarray(gates), jnp.asarray(wh))
    ref_dg, _ = vjp(jnp.asarray(dhout))
    g_t, w_t, d_t = _t(gates, wh, dhout)
    hs, cs = port_lstm.lstm_scan_fwd_res_grouped(g_t, w_t)
    dg, dwh = port_lstm.lstm_scan_bwd_grouped(g_t, hs, cs, w_t, d_t)
    np.testing.assert_allclose(dg.numpy(), np.asarray(ref_dg), atol=ATOL)
    assert dwh.shape == (2, 8, 32) and not dwh.any()


@pytest.mark.parametrize("kernel", ["K3", "K4", "dWh", "acts"])
def test_wrappers_send_cpu_tensors_to_plain_versions(inputs, kernel):
    gates, wh, dhout = inputs
    g_t, w_t, d_t = _t(gates, wh, dhout)
    hs, cs = port_lstm.lstm_scan_fwd_res_reference_grouped(g_t, w_t)
    wrapper, args, plain = {
        "K3": (port_lstm.lstm_scan_fwd_res_grouped, (g_t, w_t),
               port_lstm.lstm_scan_fwd_res_reference_grouped),
        "K4": (port_lstm.lstm_scan_bwd_grouped, (g_t, hs, cs, w_t, d_t),
               port_lstm.lstm_scan_bwd_reference_grouped),
        "dWh": (port_lstm.lstm_dwh_grouped, (hs, g_t), port_lstm.lstm_dwh_reference_grouped),
        "acts": (port_lstm.lstm_gate_acts_grouped, (g_t, hs, w_t),
                 port_lstm.lstm_gate_acts_reference_grouped),
    }[kernel]
    before = wrapper.launches
    out, ref = wrapper(*args), plain(*args)
    assert wrapper.launches == before  # no kernel launch on the CPU
    for a, b in zip(out if isinstance(out, tuple) else (out,),
                    ref if isinstance(ref, tuple) else (ref,)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_training_wrappers_reject_bad_inputs(inputs):
    gates, wh, dhout = inputs
    g_t, w_t, d_t = _t(gates, wh, dhout)
    hs, cs = port_lstm.lstm_scan_fwd_res_grouped(g_t, w_t)
    with pytest.raises(ValueError, match="dhout"):
        port_lstm.lstm_scan_bwd_grouped(g_t, hs, cs, w_t, d_t[:-1])
    with pytest.raises(ValueError, match="cs"):
        port_lstm.lstm_scan_bwd_grouped(g_t, hs, cs.double(), w_t, d_t)
    with pytest.raises(TypeError):
        port_lstm.lstm_scan_fwd_res_grouped(g_t.half(), w_t.half())
    with pytest.raises(ValueError):
        port_lstm.lstm_scan_fwd_res_grouped(g_t, w_t[:, :, :-4])
    with pytest.raises(ValueError, match="hs"):
        port_lstm.lstm_gate_acts_grouped(g_t, hs[:-1], w_t)
    with pytest.raises(ValueError, match="hs"):
        port_lstm.lstm_gate_acts_grouped(g_t, hs.double(), w_t)
    with pytest.raises(ValueError, match="hs"):
        port_lstm.lstm_gate_acts_grouped(g_t, hs.to("meta"), w_t)
    with pytest.raises(TypeError):
        port_lstm.lstm_gate_acts_grouped(g_t.half(), hs.half(), w_t.half())
    with pytest.raises(ValueError):
        port_lstm.lstm_gate_acts_grouped(g_t, hs, w_t[:, :, :-4])
    with pytest.raises(ValueError):
        port_lstm.lstm_gate_acts_grouped(g_t[:, 0], hs[:, 0], w_t[0])


def test_wh_transpose_packing():
    """The layout the reverse sweep reads for dz @ Whᵀ:
    packed[g, j, p, r] = wh[g, p // 4, (p % 4) * H + 4j + r]."""
    rng = np.random.default_rng(2)
    wh = torch.from_numpy(rng.normal(size=(2, 8, 32)).astype(np.float32))
    packed = port_lstm._pack_wh_t(wh)
    assert packed.shape == (2, 2, 32, 4)
    for p in range(32):
        for j in range(2):
            for r in range(4):
                assert packed[1, j, p, r] == wh[1, p // 4, (p % 4) * 8 + 4 * j + r]
