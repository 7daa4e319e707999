"""Port's LSTM recurrence (plain PyTorch version of the CUDA kernel) vs JAX.

Same seeded numpy inputs go through the JAX package's scan references, the
Pallas kernel in interpret mode, and the port. Tolerance: atol 1e-5 (float32
recurrences over 37 steps; the summation orders differ).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from robust_speech_analysis_framework_tpu.ops.pallas import lstm as jax_lstm
from robust_speech_analysis_framework_tpu_torch.ops.cuda import lstm as port_lstm

ATOL = 1e-5
T, G, B, H = 37, 2, 3, 8  # T is not a multiple of the Pallas time block


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    gates = (rng.normal(size=(T, G, B, 4 * H)) * 0.5).astype(np.float32)
    wh = (rng.normal(size=(G, H, 4 * H)) * 0.3).astype(np.float32)
    return gates, wh


def test_grouped_reference_matches_jax(inputs):
    gates, wh = inputs
    ref = np.asarray(jax_lstm.lstm_scan_reference_grouped(jnp.asarray(gates), jnp.asarray(wh)))
    ours = port_lstm.lstm_scan_reference_grouped(torch.from_numpy(gates), torch.from_numpy(wh))
    np.testing.assert_allclose(ours.numpy(), ref, atol=ATOL)


def test_single_reference_matches_jax(inputs):
    gates, wh = inputs
    ref = np.asarray(jax_lstm.lstm_scan_reference(jnp.asarray(gates[:, 0]), jnp.asarray(wh[0])))
    ours = port_lstm.lstm_scan_reference(torch.from_numpy(gates[:, 0]), torch.from_numpy(wh[0]))
    np.testing.assert_allclose(ours.numpy(), ref, atol=ATOL)


def test_grouped_reference_matches_pallas_interpret(inputs):
    """The Pallas kernel in interpret mode (block 8, padded tail) gives the
    same hs as the port's plain version."""
    gates, wh = inputs
    hs, _ = jax_lstm._lstm_fwd_res_pallas(jnp.asarray(gates), jnp.asarray(wh), 8, True)
    ours = port_lstm.lstm_scan_reference_grouped(torch.from_numpy(gates), torch.from_numpy(wh))
    np.testing.assert_allclose(ours.numpy(), np.asarray(hs), atol=ATOL)


@pytest.mark.parametrize("grouped", [True, False], ids=["K1", "K2"])
def test_wrapper_sends_cpu_tensors_to_plain_version(inputs, grouped):
    gates, wh = inputs
    if grouped:
        wrapper, plain = port_lstm.lstm_scan_grouped, port_lstm.lstm_scan_reference_grouped
        g_t, w_t = torch.from_numpy(gates), torch.from_numpy(wh)
    else:
        wrapper, plain = port_lstm.lstm_scan, port_lstm.lstm_scan_reference
        g_t, w_t = torch.from_numpy(gates[:, 0]), torch.from_numpy(wh[0])
    before = wrapper.launches
    out = wrapper(g_t, w_t)
    assert wrapper.launches == before  # no kernel launch on the CPU
    torch.testing.assert_close(out, plain(g_t, w_t), rtol=0, atol=0)


def test_wrapper_rejects_bad_inputs(inputs):
    gates, wh = inputs
    g_t, w_t = torch.from_numpy(gates), torch.from_numpy(wh)
    with pytest.raises(TypeError):
        port_lstm.lstm_scan_grouped(g_t.double(), w_t.double())
    with pytest.raises(ValueError):
        port_lstm.lstm_scan_grouped(g_t, w_t[:, :, :-1])
    with pytest.raises(ValueError):
        port_lstm.lstm_scan_grouped(g_t[0], w_t)


def _packed_index(h, k4, m, p, r):
    """Where ``_pack_wh`` takes packed[g, 8*k4 + m, p, r] from: (row, column)
    of Wh, the row possibly past H (a zero row)."""
    nk = -(-h // 32)
    lane, group = p % 8, p // 8
    return lane * 4 * nk + 4 * k4 + r, (m % 4) * h + 2 * group + m // 4


def test_wh_packing_and_batch_tile():
    """The layout the kernel reads, at H = 8, and the batch tile it is given."""
    rng = np.random.default_rng(1)
    wh = torch.from_numpy(rng.normal(size=(2, 8, 32)).astype(np.float32))
    packed = port_lstm._pack_wh(wh)
    assert packed.shape == (2, 8, 32, 4)
    for p in range(32):
        for m in range(8):
            for r in range(4):
                row, col = _packed_index(8, 0, m, p, r)
                assert packed[1, m, p, r] == (wh[1, row, col] if row < 8 else 0.0)
    scan, sweep = port_lstm.SCAN_LARGEST_TILE, port_lstm.SWEEP_LARGEST_TILE
    assert (scan, sweep) == (2, 4)
    assert port_lstm._pick_batch_tile(2, 1, 132, scan) == 1
    assert port_lstm._pick_batch_tile(2, 8, 132, scan) == 1
    assert port_lstm._pick_batch_tile(1, 128, 132, scan) == 1
    assert port_lstm._pick_batch_tile(2, 128, 132, scan) == 2
    # past the largest tile the grid runs in more than one wave
    assert port_lstm._pick_batch_tile(2, 264, 132, scan) == 2
    assert port_lstm._pick_batch_tile(2, 4096, 132, scan) == 2
    assert port_lstm._pick_batch_tile(2, 128, 132, sweep) == 2
    assert port_lstm._pick_batch_tile(2, 264, 132, sweep) == 4
    assert port_lstm._pick_batch_tile(2, 4096, 132, sweep) == 4


@pytest.mark.parametrize("h", [8, 24, 40, 64, 128])
def test_wh_packing_lane_assignment(h):
    """``_pack_wh`` by its index formula, and one step of the kernel's matvec
    emulated from the packed array: each of a group's 8 lanes sums its eighth
    of k (of H rounded up to a multiple of 32, zero-padded) against the
    group's 8 columns, and the 8 partial sums add up to ``h @ Wh``."""
    rng = np.random.default_rng(h)
    nk = -(-h // 32)
    wh = torch.from_numpy(rng.normal(size=(2, h, 4 * h)) / h**0.5)  # float64: the sums are exact to 1e-6
    packed = port_lstm._pack_wh(wh)
    assert packed.shape == (2, 8 * nk, 4 * h, 4) and packed.is_contiguous()

    k4, m, p, r = np.meshgrid(np.arange(nk), np.arange(8), np.arange(4 * h), np.arange(4),
                              indexing="ij")
    row, col = _packed_index(h, k4, m, p, r)
    padded = torch.cat([wh, wh.new_zeros(2, 32 * nk - h, 4 * h)], dim=1)
    expected = padded[:, torch.from_numpy(row), torch.from_numpy(col)]  # (2, nk, 8, 4H, 4)
    torch.testing.assert_close(packed, expected.reshape(2, 8 * nk, 4 * h, 4), rtol=0, atol=0)

    hvec = torch.from_numpy(rng.normal(size=(2, h)))
    h_pad = torch.cat([hvec, hvec.new_zeros(2, 32 * nk - h)], dim=1)
    # lane l of every group holds h_pad[l*4NK : (l+1)*4NK] as NK float4
    slices = h_pad.reshape(2, 8, nk, 4)
    z = torch.zeros(2, 4 * h, dtype=torch.float64)
    for group in range(h // 2):
        partial = torch.zeros(2, 8, 8, dtype=torch.float64)  # [g, lane, column m]
        for lane in range(8):
            w = packed[:, :, 8 * group + lane, :].reshape(2, nk, 8, 4)  # [g, k4, m, r]
            partial[:, lane] = torch.einsum("gkr,gkmr->gm", slices[:, lane], w)
        total = partial.sum(dim=1)  # the shuffles' sum over the 8 lanes: lane m keeps column m
        for m_ in range(8):
            z[:, (m_ % 4) * h + 2 * group + m_ // 4] = total[:, m_]
    torch.testing.assert_close(z, torch.einsum("gk,gkj->gj", hvec, wh), rtol=0, atol=1e-6)
