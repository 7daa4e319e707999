"""Tests of the port that need the card. They import no JAX, so they also run
on a machine without it (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Without a CUDA device every test here skips.
"""

import numpy as np
import pytest
import torch

from robust_speech_analysis_framework_tpu_torch.models.cnn_lstm import build_cnn_lstm
from robust_speech_analysis_framework_tpu_torch.ops.cuda import lstm as lstm_ops

pytestmark = pytest.mark.cuda

ATOL = 1e-5  # fp32 kernel vs fp32 plain version: summation order only


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("t,b,h", [(37, 3, 8), (300, 17, 128)])
def test_kernel_matches_plain_version(cuda_device, t, b, h):
    rng = np.random.default_rng(0)
    gates = torch.from_numpy((rng.normal(size=(t, 2, b, 4 * h)) * 0.5).astype(np.float32))
    wh = torch.from_numpy((rng.normal(size=(2, h, 4 * h)) / h**0.5).astype(np.float32))
    gates, wh = gates.to(cuda_device), wh.to(cuda_device)
    before = (lstm_ops.lstm_scan_grouped.launches, lstm_ops.lstm_scan.launches)
    out = lstm_ops.lstm_scan_grouped(gates, wh)
    out1 = lstm_ops.lstm_scan(gates[:, 0].contiguous(), wh[0])
    torch.cuda.synchronize()
    assert (lstm_ops.lstm_scan_grouped.launches, lstm_ops.lstm_scan.launches) == (
        before[0] + 1, before[1] + 1)
    ref = lstm_ops.lstm_scan_reference_grouped(gates, wh)
    torch.testing.assert_close(out, ref, rtol=0, atol=ATOL)
    torch.testing.assert_close(out1, ref[:, 0], rtol=0, atol=ATOL)


def test_kernel_rejects_unsupported_hidden_size(cuda_device):
    gates = torch.zeros(4, 2, 1, 4 * 6, device=cuda_device)
    with pytest.raises(ValueError, match="H % 8"):
        lstm_ops.lstm_scan_grouped(gates, torch.zeros(2, 6, 24, device=cuda_device))


def test_cnn_lstm_on_card_matches_cpu(cuda_device):
    """Ragged batch through the model on the card (two kernel launches) and
    on the CPU (plain path); logits agree within 1e-4."""
    model = build_cnn_lstm(input_dim=24, cnn_out_channels=16, lstm_hidden_dim=16,
                           seed=1, device=cuda_device)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(3, 64, 24)).astype(np.float32))
    lengths = torch.tensor([64, 41, 7], dtype=torch.int32)
    before = lstm_ops.lstm_scan_grouped.launches
    with torch.inference_mode():
        card = model(x.to(cuda_device), lengths.to(cuda_device)).cpu()
        cpu = model.cpu()(x, lengths)
    assert lstm_ops.lstm_scan_grouped.launches == before + 2
    torch.testing.assert_close(card, cpu, rtol=0, atol=1e-4)
