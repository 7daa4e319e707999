"""The period march kernel's shared-memory plan and the argument checks of its
profile entry, on the CPU (``ops/cuda/jitter.py``).

The kernel (``csrc/period_march.cu``) keeps a ring of float64 samples and
their running sums of squares, the warps' slice sums and a row queue in
shared memory; ``march_plan`` sizes them from the sample rate, ``srr`` and
``f0_min``, and ``march_smem_bytes`` counts the bytes as the kernel's own
``period_march_smem_bytes`` does (``tests/test_torch_cuda.py`` holds the two
equal on the card). A plan a block cannot hold raises ``ValueError`` before
any launch. Everything here is exact integer arithmetic.
"""

import numpy as np
import pytest
import torch

from robust_speech_analysis_framework_tpu_torch.ops.cuda import jitter as march_ops

SR, HOP = 16000, 160


def test_march_smem_bytes_counts_each_buffer():
    # the ring and its running sums of squares, 8 B a sample each; a total a
    # chunk; 8 warps' slice sums, 2 × (32 · 8 + 32) doubles each; argmax
    # slots and the winners' (corr, e), 2 parities × 8 warps × 16 B each;
    # the queue, 32 B a row; 2 staging chunks padded by a float every 32, 4
    # B a float; the search slots (2 × 8) and 8 control words, 4 B each
    assert march_ops.march_smem_bytes(8192, 1024, 64) == (
        8 * (2 * 8192 + 8 + 8 * 576) + 256 + 256 + 32 * 64 + 4 * 2 * 1056 + 96)
    assert march_ops.march_smem_bytes(8192, 1024, 64) == 179104
    # each buffer in its own unit
    base = march_ops.march_smem_bytes(4096, 1024, 2)
    assert march_ops.march_smem_bytes(8192, 1024, 2) - base == 16 * 4096 + 8 * 4
    assert march_ops.march_smem_bytes(4096, 1024, 4) - base == 32 * 2
    assert march_ops.march_smem_bytes(4096, 512, 2) - base == 8 * 4 - 4 * 2 * 528


def test_march_plan_at_the_opensmile_settings():
    plan = march_ops.march_plan(SR, 0.25, 40.0, HOP)
    assert (plan.w0, plan.hi, plan.gw) == march_ops.march_geometry(SR, 0.25, 40.0) == (
        401, 502, 911)
    assert (plan.ring, plan.chunk, plan.queue) == (8192, 1024, 64)
    assert plan.smem_bytes == march_ops.march_smem_bytes(8192, 1024, 64) == 179104
    assert plan.smem_bytes <= march_ops.SMEM_LIMIT


@pytest.mark.parametrize("sr,srr,f0_min,hop", [
    (16000, 0.25, 40.0, 160), (16000, 0.1, 40.0, 160), (16000, 0.5, 40.0, 160),
    (16000, 0.25, 25.0, 160), (16000, 0.25, 75.0, 80), (8000, 0.25, 40.0, 80),
    (44100, 0.25, 40.0, 441), (48000, 0.25, 40.0, 480), (16000, 0.25, 40.0, 1),
])
def test_march_plan_holds_a_window_and_four_chunks_of_lead(sr, srr, f0_min, hop):
    plan = march_ops.march_plan(sr, srr, f0_min, hop)
    for v in (plan.ring, plan.chunk, plan.queue):
        assert v & (v - 1) == 0  # indexed by masks and shifts
    # the least power of two that holds a window and four chunks
    assert plan.ring >= plan.gw + 4 * plan.chunk > plan.ring // 2
    assert march_ops.march_band_max(sr, srr, f0_min) <= march_ops.MAX_BAND
    assert plan.smem_bytes == march_ops.march_smem_bytes(
        plan.ring, plan.chunk, plan.queue) <= march_ops.SMEM_LIMIT


def test_march_plan_grows_with_the_window():
    small = march_ops.march_plan(SR, 0.25, 80.0, HOP)
    wide = march_ops.march_plan(SR, 0.25, 10.0, HOP)
    assert small.gw < wide.gw and small.ring <= wide.ring <= march_ops.SMEM_LIMIT // 16
    assert small.smem_bytes <= wide.smem_bytes
    assert wide.ring == 1 << int(np.ceil(np.log2(wide.gw + 4 * march_ops.CHUNK)))


@pytest.mark.parametrize("sr,srr,f0_min,hop", [
    (96000, 0.25, 10.0, 960),  # a ring of 32768 float64 samples and its sums: 512 KiB
    (16000, 0.25, 1.0, 160),  # 8,004-lag bands: past 8 lags a thread
    (48000, 0.25, 20.0, 480),  # a ring of 16384 samples and its sums: 256 KiB
    (16000, 0.25, 40.0, 0),  # no hop
])
def test_march_plan_raises_where_a_block_cannot_hold_it(sr, srr, f0_min, hop):
    with pytest.raises(ValueError, match="period march"):
        march_ops.march_plan(sr, srr, f0_min, hop)


def test_march_band_bound_covers_every_f0():
    # the widest band over F0 from f0_min up, with the float32 rounding of
    # the kernel's geometry, stays within the bound the plan checks
    for sr, srr, f0_min in ((16000, 0.25, 40.0), (16000, 0.5, 25.0), (44100, 0.1, 60.0)):
        widest = 0
        for f in np.linspace(f0_min, 4 * f0_min, 4001, dtype=np.float32):
            t0 = np.float32(sr) / max(f, np.float32(f0_min))
            lo = max(int(t0 * np.float32(1 - srr)), 8)
            hi = int(t0 * np.float32(1 + srr)) + 1
            widest = max(widest, hi - lo + 1)
        assert widest <= march_ops.march_band_max(sr, srr, f0_min) <= widest + 3


def _inputs():
    x = torch.zeros(2, 400)
    f0 = torch.zeros(2, 3)
    n = torch.tensor([400, 400], dtype=torch.int32)
    return x, f0, n, (float(SR), HOP, 0.25, 40.0, 25)


def test_profile_entry_checks_types_and_shapes():
    x, f0, n, args = _inputs()
    with pytest.raises(TypeError):
        march_ops.march_periods_profile(x.double(), f0, n, n, *args)
    with pytest.raises(TypeError):
        march_ops.march_periods_profile(x, f0, n.long(), n, *args)
    with pytest.raises(ValueError):
        march_ops.march_periods_profile(x, f0[:1], n, n, *args)
    with pytest.raises(ValueError):
        march_ops.march_periods_profile(x[0], f0, n, n, *args)
    with pytest.raises(ValueError):
        march_ops.march_periods_profile(x, f0, n[:1], n, *args)


def test_profile_entry_runs_on_the_card_only():
    x, f0, n, args = _inputs()
    with pytest.raises(ValueError, match="CUDA tensors only"):
        march_ops.march_periods_profile(x, f0, n, n, *args)
    with pytest.raises(ValueError, match="unsupported device"):
        march_ops.march_periods_profile(x.to("meta"), f0.to("meta"), n.to("meta"),
                                        n.to("meta"), *args)
    with pytest.raises(ValueError, match="inputs on"):
        march_ops.march_periods_profile(x, f0.to("meta"), n, n, *args)


def test_profile_breakdown_unpacks_the_buffer():
    prof = torch.tensor([[1000, 10, 20, 30, 40, 50, 60, (7 << 32) | 3],
                         [5, 0, 0, 0, 0, 0, 0, 0]], dtype=torch.int64)
    bd = march_ops.profile_breakdown(prof)
    assert bd["total"].tolist() == [1000, 5]
    assert [int(bd[name][0]) for name in march_ops.PHASES] == [10, 20, 30, 40, 50, 60]
    assert bd["voiced_steps"].tolist() == [7, 0] and bd["unvoiced_steps"].tolist() == [3, 0]
    assert march_ops.profile_breakdown(prof.numpy())["voiced_steps"].tolist() == [7, 0]
