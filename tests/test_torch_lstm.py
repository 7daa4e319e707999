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


def test_wh_packing_and_batch_tile():
    """The layout the kernel reads: packed[g, k4, p, r] = wh[g, 4*k4 + r, col(p)]."""
    rng = np.random.default_rng(1)
    wh = torch.from_numpy(rng.normal(size=(2, 8, 32)).astype(np.float32))
    packed = port_lstm._pack_wh(wh)
    assert packed.shape == (2, 2, 32, 4)
    for p in range(32):
        col = (p % 4) * 8 + p // 4
        for k in range(8):
            assert packed[1, k // 4, p, k % 4] == wh[1, k, col]
    assert port_lstm._pick_batch_tile(2, 1, 132) == 1
    assert port_lstm._pick_batch_tile(2, 128, 132) == 2
    assert port_lstm._pick_batch_tile(2, 4096, 132) == 8

