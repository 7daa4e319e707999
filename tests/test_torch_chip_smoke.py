"""``chip_smoke.py``'s launch bookkeeping on the CPU: the kernel wrappers it
counts, the table of what one unit of work launches, and the check that
holds a phase's counts to that table."""

import types

import pytest

import chip_smoke
from robust_speech_analysis_framework_tpu_torch.models.wavlm import WavLMConfig
from robust_speech_analysis_framework_tpu_torch.ops.cuda import wav2vec2 as w2v_ops

KERNELS = {
    "lstm_scan_grouped", "lstm_scan", "lstm_scan_fwd_res_grouped", "lstm_scan_bwd_grouped",
    "lstm_gate_acts_grouped", "lstm_dwh_grouped", "viterbi_forward_costs", "viterbi_path",
    "march_periods", "conv0_norm_gelu", "feature_conv", "pos_conv_gelu", "relpos_softmax",
    "relpos_shift_softmax",
}


def test_the_counter_finds_every_kernel_wrapper():
    wrappers = chip_smoke.kernel_wrappers()
    assert set(wrappers) == KERNELS
    assert wrappers["pos_conv_gelu"] is w2v_ops.pos_conv_gelu


def test_a_new_wrapper_is_counted_without_an_edit(monkeypatch):
    def conv_stack_kernel():
        conv_stack_kernel.launches += 1

    conv_stack_kernel.launches = 0
    monkeypatch.setattr(w2v_ops, "conv_stack_kernel", conv_stack_kernel, raising=False)
    with chip_smoke.count_launches() as counts:
        conv_stack_kernel()
        conv_stack_kernel()
    assert counts == dict.fromkeys(KERNELS, 0) | {"conv_stack_kernel": 2}


def test_count_launches_zeroes_every_wrapper_and_reads_the_block(monkeypatch):
    wrappers = chip_smoke.kernel_wrappers()
    for fn in wrappers.values():
        monkeypatch.setattr(fn, "launches", 5)
    with chip_smoke.count_launches() as counts:
        assert all(fn.launches == 0 for fn in wrappers.values())
        wrappers["relpos_softmax"].launches += 3
    assert counts == dict.fromkeys(KERNELS, 0) | {"relpos_softmax": 3}


def test_every_kernel_in_the_table_is_a_wrapper():
    tabled = {k for per in chip_smoke.UNIT_LAUNCHES.values() for k in per}
    assert tabled <= set(chip_smoke.kernel_wrappers())
    widths = {w for per in chip_smoke.UNIT_LAUNCHES.values() for w in per.values()
              if isinstance(w, str)}
    assert widths and all(hasattr(WavLMConfig(), w) for w in widths)
    assert set(chip_smoke.MD_UNITS) <= set(chip_smoke.UNIT_LAUNCHES)


UNITS = {"cnnlstm-step": 4, "cnnlstm-eval": 3, "wavlm-batch": 2, "w2v2-batch": 1,
         "w2v2-batch-bf16": 5, "opensmile-sub-batch": 2, "mshds-pitch-pass": 8}


def test_the_table_sums_a_phases_units():
    want = chip_smoke.expected_launches(UNITS, types.SimpleNamespace(num_layers=24))
    assert want == {
        "lstm_scan_fwd_res_grouped": 8, "lstm_scan_bwd_grouped": 8, "lstm_gate_acts_grouped": 8,
        "lstm_dwh_grouped": 8, "lstm_scan_grouped": 6, "conv0_norm_gelu": 1,
        "feature_conv": 18, "pos_conv_gelu": 3, "relpos_softmax": 48, "viterbi_forward_costs": 10,
        "viterbi_path": 10, "march_periods": 2}


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_the_check_accepts_the_tables_count_and_refuses_one_off(kernel):
    config = types.SimpleNamespace(num_layers=3)
    counts = dict.fromkeys(KERNELS, 0) | chip_smoke.expected_launches(UNITS, config)
    chip_smoke.check_launches("test", counts, UNITS, config)
    for off in (1, -1):
        if counts[kernel] + off < 0:
            continue
        with pytest.raises(AssertionError, match=kernel):
            chip_smoke.check_launches("test", dict(counts, **{kernel: counts[kernel] + off}),
                                      UNITS, config)
