"""Port's corpus buffer, frame gathers and resampling vs the JAX package.

The same seeded numpy inputs go through both packages on the CPU.
Tolerances:

* ``corpus_buffer`` (both upload paths: int16 for 16-bit PCM, float32
  otherwise) and the gathers: bit-equal;
* ``resample_poly`` / ``resample_buffer``: atol 2e-6 × the input's largest
  magnitude (one float32 convolution of 161–201 taps, summed in another
  order by XLA and by PyTorch); against the float64 numpy version 1e-5 ×
  the largest magnitude (float32 against float64).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from robust_speech_analysis_framework_tpu.audio import resample as jax_resample
from robust_speech_analysis_framework_tpu.ops import framing as jax_framing
from robust_speech_analysis_framework_tpu_torch.audio import resample as port_resample
from robust_speech_analysis_framework_tpu_torch.ops import framing as port_framing

RESAMPLE_TOL = 2e-6


def _pcm(n: int, seed: int) -> np.ndarray:
    """Seeded noise quantised to 16-bit PCM (every sample n/32768)."""
    x = 0.3 * np.random.default_rng(seed).normal(size=n)
    return np.clip(np.round(x * 32768.0), -32768, 32767) / 32768.0


def _waves(kind: str):
    lengths = (1000, 37, 4096, 16000)
    if kind == "pcm":
        return [_pcm(n, i) for i, n in enumerate(lengths)]
    return [np.random.default_rng(i).normal(size=n) for i, n in enumerate(lengths)]


@pytest.mark.parametrize("kind", ["pcm", "float"])
@pytest.mark.parametrize("pad,align", [(128, 8), (4096, 8), (300, 5)])
def test_corpus_buffer_bit_equal_to_jax(kind, pad, align):
    xs = _waves(kind)
    ref = jax_framing.corpus_buffer(xs, pad=pad, align=align)
    ours = port_framing.corpus_buffer(xs, pad=pad, align=align, device="cpu")
    assert ours.x_cat.dtype == torch.float32 and ours.x_cat.device.type == "cpu"
    np.testing.assert_array_equal(ours.x_cat.numpy(), np.asarray(ref.x_cat))
    np.testing.assert_array_equal(ours.offsets, ref.offsets)
    assert ours.pad == ref.pad
    for a, b in zip(ours.xs, ref.xs):
        np.testing.assert_array_equal(a, b)
    for i, x in enumerate(xs):  # each file at an aligned offset, then >= pad zeros
        off = int(ours.offsets[i])
        assert off % align == 0
        assert not ours.x_cat[off + len(x) : off + len(x) + pad].any()


def test_pcm_corpus_goes_up_as_int16(monkeypatch):
    """16-bit PCM is uploaded at half the bytes; other audio as float32."""
    uploaded = []
    real = torch.Tensor.to

    def spy(self, *args, **kwargs):
        uploaded.append(self.dtype)
        return real(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "to", spy)
    port_framing.corpus_buffer(_waves("pcm"), device="cpu")
    assert uploaded[0] == torch.int16
    uploaded.clear()
    port_framing.corpus_buffer(_waves("float"), device="cpu")
    assert uploaded[0] == torch.float32


def test_gathers_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=10000).astype(np.float32)
    total32 = -(-(len(x) + 1200) // 32) * 32
    x32 = np.pad(x, (0, total32 - len(x))).reshape(-1, 32)
    for n, win in ((53, 480), (37, 17), (16, 481), (7, 128), (1, 33)):
        starts = rng.integers(0, 9000, size=n).astype(np.int32)
        ref = np.asarray(jax_framing._gather_frames_xla(jnp.asarray(x), jnp.asarray(starts), win))
        ours = port_framing.gather_frames(torch.from_numpy(x), torch.from_numpy(starts).long(), win)
        np.testing.assert_array_equal(ours.numpy(), ref)
        ref32 = np.asarray(jax_framing.rows32_gather(jnp.asarray(x32), jnp.asarray(starts), win))
        ours32 = port_framing.rows32_gather(torch.from_numpy(x32), torch.from_numpy(starts).long(),
                                            win)
        np.testing.assert_array_equal(ours32.numpy(), ref32)


def test_gather_past_the_buffer_raises():
    """The port reads no clamped window: a start past the end is an error
    (the JAX package's callers raise before they get there)."""
    x = torch.zeros(100)
    with pytest.raises(IndexError):
        port_framing.gather_frames(x, torch.tensor([90]), 20)


@pytest.mark.parametrize("up,down", [(5, 8), (1, 2), (3, 2), (2, 3), (1, 3)])
def test_resample_poly_matches_jax_and_numpy(up, down):
    rng = np.random.default_rng(up * 10 + down)
    x = rng.normal(size=(2, 3001)).astype(np.float32)
    ref = np.asarray(jax_resample.resample_poly(jnp.asarray(x), up, down))
    ours = port_resample.resample_poly(torch.from_numpy(x), up, down).numpy()
    assert ours.shape == ref.shape == (2, -(-3001 * up // down))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=RESAMPLE_TOL * np.abs(x).max())
    host = port_resample.resample_poly_np(x.astype(np.float64), up, down)
    np.testing.assert_allclose(ours, host, rtol=0, atol=1e-5 * np.abs(x).max())
    one = port_resample.resample_poly(torch.from_numpy(x[0]), up, down).numpy()
    np.testing.assert_allclose(one, ours[0], rtol=0, atol=RESAMPLE_TOL * np.abs(x).max())


def test_resample_poly_identity_ratio():
    x = torch.arange(7.0)
    assert port_resample.resample_poly(x, 3, 3) is x


@pytest.mark.parametrize("preemphasis", [0.0, float(np.exp(-2 * np.pi * 50 / 10000))])
def test_resample_buffer_matches_jax(preemphasis):
    xs = [_pcm(n, i) for i, n in enumerate((16000, 8003, 24011))]
    ref = jax_framing.resample_buffer(jax_framing.corpus_buffer(xs, pad=4096, align=8), 5, 8,
                                      preemphasis=preemphasis)
    ours = port_framing.resample_buffer(
        port_framing.corpus_buffer(xs, pad=4096, align=8, device="cpu"), 5, 8,
        preemphasis=preemphasis)
    np.testing.assert_array_equal(ours.offsets, ref.offsets)
    assert ours.pad == ref.pad == 4096 * 5 // 8 - 5
    assert [len(x) for x in ours.xs] == [len(x) for x in ref.xs] == [10000, 5002, 15007]
    assert all(isinstance(x, port_framing._LengthOnly) and not x.any() for x in ours.xs)
    np.testing.assert_allclose(ours.x_cat.numpy(), np.asarray(ref.x_cat), rtol=0,
                               atol=RESAMPLE_TOL)
    # a file's region equals resampling that file alone (the pad keeps files
    # apart; its first sample's preemphasis sees the blur tail of the file before)
    alone = port_resample.resample_poly(torch.from_numpy(xs[1].astype(np.float32)), 5, 8)
    if preemphasis:
        alone = alone - preemphasis * torch.cat([alone.new_zeros(1), alone[:-1]])
    off = int(ours.offsets[1])
    np.testing.assert_allclose(ours.x_cat[off + 1 : off + 5002].numpy(), alone[1:].numpy(),
                               rtol=0, atol=RESAMPLE_TOL)


def test_resample_buffer_rejects_unaligned_offsets():
    buf = port_framing.corpus_buffer([np.zeros(1001), np.zeros(500)], pad=16, align=1,
                                     device="cpu")
    with pytest.raises(ValueError, match="not aligned"):
        port_framing.resample_buffer(buf, 5, 8)
