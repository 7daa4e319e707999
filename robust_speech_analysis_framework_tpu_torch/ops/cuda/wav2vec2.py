"""Wav2Vec2's hand-written CUDA kernels and their plain PyTorch versions:
the feature encoder's first block, its strided convs conv_1 … conv_6 (WavLM's
too) and the positional conv embedding.

The first block is conv_0 over the raw waveform (one input channel, C
outputs, 10 taps, stride 5, no bias), the norm of each (row, channel) over
the row's valid frames, the ``gn_scale`` / ``gn_bias`` affine and the exact
(erf) GELU. The JAX package leaves it to XLA (``models/wav2vec2.py``: conv_0
and its masked channel norm); there is no Pallas kernel behind it.

* :func:`conv0_norm_gelu`: → (B, C, T) float32, T = (L − 10) // 5 + 1. On
  CUDA one call is a memset and two launches of ``csrc/feature_conv0.cu``
  in one scratch buffer that the .cu file sizes and lays out: the
  statistics of each row from its patches' moments in float64, then one
  pass that computes the conv, the norm, the affine and the GELU and writes
  the output once. A C whose records do not fit a block's shared memory
  raises the launch's CUDA error.
* :func:`conv0_norm_gelu_reference`: the same block as the encoder ran it
  before the kernel, the conv in the compute dtype (cuDNN's or the CPU's,
  IEEE float32 for float32) and :func:`channel_norm_gelu` over its output.
  ``ShardedWav2Vec2`` at mp > 1 calls :func:`channel_norm_gelu` after
  gathering its conv's slices.

The feature encoder's other convs are C_in → C_out channels, K taps at
stride s, VALID, with a bias where the config has one and, in Wav2Vec2's
group mode, GELU after; WavLM's layer mode normalises each frame before its
GELU. The JAX package leaves them to XLA (``models/wav2vec2.py``'s
``nn.Conv`` over (B, L, C), the layout the kernel keeps); it has no WavLM.

* :func:`feature_conv`: (B, T, C_in) → (B, T_out, C_out) float32,
  contiguous. On CUDA one launch of ``csrc/feature_conv.cu``: time-major, a
  conv is a GEMM of the overlapping input rows (T_out × K C_in, a row every
  s C_in floats) with the weights laid out once a call as (K C_in, C_out);
  bias and GELU fused. The tile, and a split of the reduction where one wave
  of tiles would leave SMs idle, come from :func:`feature_conv_plan`.
* :func:`feature_conv_reference`: the conv as the encoders ran it before the
  kernel: :func:`..device.conv1d` in the compute dtype over the (B, C, T)
  view, GELU if asked, a (B, T, C) view of the result in that dtype.

The positional conv embedding is a grouped conv over the hidden states (C
channels in G groups, K taps, K // 2 frames of zero padding a side), its
bias and the exact GELU, (B, T, C) in and out; the JAX package leaves it to
XLA too (its grouped ``nn.Conv``), and WavLM reuses it.

* :func:`pos_conv_gelu`: → (B, T, C) float32, contiguous. On CUDA one
  launch of ``csrc/pos_conv.cu`` after the weights are laid out as (G, Kp,
  C/G in, C/G out), K padded by zero taps to Kp, a multiple of 4; a block
  computes a tile of frames (:func:`pos_conv_tile`) of one group and row.
* :func:`pos_conv_gelu_reference`: the positional conv as the encoder ran
  it before the kernel: the conv in the compute dtype through
  :func:`..device.conv1d`, the extra frame of an even kernel dropped, GELU,
  a (B, T, C) view. ``ShardedWav2Vec2`` at mp > 1 calls it per device.

The wrappers make the whole choice, by one rule (:func:`_uses_kernel`):
float32 (``cdt``, the compute dtype) on CUDA tensors launches the kernel or
raises; CPU tensors, or any other ``cdt``, take the plain version at ``cdt``;
any other device raises. There is no fallback between them.
``conv0_norm_gelu.launches`` counts the first block's calls (two launches
each), ``feature_conv.launches`` and ``pos_conv_gelu.launches`` their
kernels' launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ...device import conv1d
from ._build import call as _call
from ._build import load as _load

TAPS, STRIDE = 10, 5  # the kernel's conv: every Wav2Vec2 config's conv_0
POS_TAPS = 4  # taps a weight stage of the positional conv's kernel: K is padded to a multiple
POS_LANES = 8  # threads across a group's output channels: C/G a multiple of 8 ...
POS_MAX_GROUP = 64  # ... and at most 64 (a thread's 8 frames x C/G/8 sums in registers)
POS_TILES = tuple(range(32, 257, 32))  # frames (threads) a block
SMEM_BLOCK, SMEM_SM = 232_448, 233_472  # H100: a block's dynamic shared memory; an SM's
# the strided convs' (rows, channels) a block, and the blocks an SM its launch bounds ask for
FEAT_TILES = {(64, 128): 3, (64, 64): 6}
FEAT_BK, FEAT_STAGES = 16, 4  # their reduction floats a stage, stages in the cp.async ring
FEAT_MAX_SPLITS = 8  # splits of the reduction at most
# the plan's costs, fitted to every plan's time at both encoders' batches and one chunk
# (H100): copies a FMA, as a tile side over which a plan's cost grows by 1; the share of a
# round that a last, partial round costs; warp-stages that a split plan pays besides
FEAT_TILE_COST, FEAT_TAIL, FEAT_SPLIT_COST = 2.0, 0.75, 16.0
MAX_ROWS = 65_535  # the launch grid's second and third dimensions


def masked_channel_norm(
    x: torch.Tensor, lengths: Optional[torch.Tensor], eps: float
) -> torch.Tensor:
    """Per-(sample, channel) normalization over valid time frames.

    ``x`` is (B, C, T). Equivalent to torch GroupNorm(num_groups=C, C) on
    each unpadded sequence; GroupNorm over the padded tensor would count the
    padding.
    """
    if lengths is None:
        mean = x.mean(dim=2, keepdim=True)
        var = x.var(dim=2, unbiased=False, keepdim=True)
    else:
        t = torch.arange(x.shape[2], device=x.device)
        mask = (t[None, None, :] < lengths[:, None, None]).to(x.dtype)
        n = mask.sum(dim=2, keepdim=True).clamp(min=1.0)
        mean = (x * mask).sum(dim=2, keepdim=True) / n
        var = (((x - mean) * mask) ** 2).sum(dim=2, keepdim=True) / n
    return (x - mean) * torch.rsqrt(var + eps)


def channel_norm_gelu(
    h: torch.Tensor, lengths: Optional[torch.Tensor], gn_scale: torch.Tensor,
    gn_bias: torch.Tensor, eps: float,
) -> torch.Tensor:
    """The first block after its conv: ``h`` (B, C, T) → :func:`masked_channel_norm`,
    the ``gn_scale`` / ``gn_bias`` affine and GELU, in float32 whatever
    ``h``'s dtype (a bfloat16 mean and variance over ~16k frames would lose
    the small-variance channels)."""
    h = masked_channel_norm(h.float(), lengths, eps)
    return F.gelu(h * gn_scale[:, None] + gn_bias[:, None])


def conv0_norm_gelu_reference(
    wav: torch.Tensor, weight: torch.Tensor, gn_scale: torch.Tensor, gn_bias: torch.Tensor,
    lengths: Optional[torch.Tensor], eps: float, stride: int = STRIDE,
    cdt: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain block: ``wav`` (B, L), ``weight`` (C, 1, K), ``lengths`` the
    valid frames of the conv's output (B,) or None (every frame) → (B, C, T)
    float32. The conv runs in ``cdt`` (:func:`..device.conv1d`), the rest in
    float32 (:func:`channel_norm_gelu`)."""
    h = conv1d(wav[:, None, :], weight, None, cdt, stride=stride)
    return channel_norm_gelu(h, lengths, gn_scale, gn_bias, eps)


def _uses_kernel(device: torch.device, cdt: torch.dtype) -> bool:
    """Whether a wrapper launches its kernel on ``device`` at compute dtype
    ``cdt``: float32 on CUDA does; the CPU, or any other ``cdt``, takes the
    plain version; float32 on any other device raises."""
    if device.type == "cpu" or cdt != torch.float32:
        return False
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    return True


def _check(wav, weight, gn_scale, gn_bias, lengths, stride) -> None:
    if wav.ndim != 2 or weight.ndim != 3 or weight.shape[1] != 1:
        raise ValueError(f"expected wav (B, L) and weight (C, 1, K), got {tuple(wav.shape)}, "
                         f"{tuple(weight.shape)}")
    c = weight.shape[0]
    if gn_scale.shape != (c,) or gn_bias.shape != (c,):
        raise ValueError(f"expected gn_scale and gn_bias of ({c},), got "
                         f"{tuple(gn_scale.shape)}, {tuple(gn_bias.shape)}")
    if lengths is not None and lengths.shape != (wav.shape[0],):
        raise ValueError(f"expected lengths of ({wav.shape[0]},), got {tuple(lengths.shape)}")
    tensors = [wav, weight, gn_scale, gn_bias] + ([] if lengths is None else [lengths])
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"inputs on {[str(t.device) for t in tensors]}")
    if wav.shape[1] < weight.shape[2]:
        raise ValueError(f"a waveform of {wav.shape[1]} samples is shorter than the "
                         f"conv's {weight.shape[2]} taps")


def conv0_norm_gelu(
    wav: torch.Tensor, weight: torch.Tensor, gn_scale: torch.Tensor, gn_bias: torch.Tensor,
    lengths: Optional[torch.Tensor], eps: float, stride: int = STRIDE,
    cdt: torch.dtype = torch.float32,
) -> torch.Tensor:
    """conv_0 → masked channel norm → affine → GELU: (B, L) → (B, C, T)
    float32, as :func:`conv0_norm_gelu_reference` at ``cdt``. Inference
    only: the kernel has no backward."""
    _check(wav, weight, gn_scale, gn_bias, lengths, stride)
    if not _uses_kernel(wav.device, cdt):
        return conv0_norm_gelu_reference(wav, weight, gn_scale, gn_bias, lengths, eps, stride,
                                         cdt)
    b, n = wav.shape
    c, _, k = weight.shape
    if k != TAPS or stride != STRIDE:
        raise ValueError(f"the kernel takes a conv of {TAPS} taps at stride {STRIDE}, "
                         f"got {k} taps at stride {stride}")
    if b > MAX_ROWS:
        raise ValueError(f"the kernel takes at most {MAX_ROWS} rows, got {b}")
    tensors = (wav, weight, gn_scale, gn_bias)
    if not all(t.dtype == torch.float32 for t in tensors):
        raise TypeError(f"expected float32, got {[t.dtype for t in tensors]}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("conv0_norm_gelu has no backward on CUDA: call it under "
                           "torch.no_grad() or torch.inference_mode()")
    dev = wav.device
    t = (n - k) // stride + 1
    if b == 0:
        return torch.empty((0, c, t), device=dev, dtype=torch.float32)
    fn = _load("feature_conv0").conv0_norm_gelu_scratch_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_longlong
    scratch = torch.empty(fn(b, t, c), device=dev, dtype=torch.uint8)
    out = torch.empty((b, c, t), device=dev, dtype=torch.float32)
    frames = scratch if lengths is None else lengths.to(torch.int32).contiguous()  # not read if None
    _call("feature_conv0", "conv0_norm_gelu_f32", dev, wav.contiguous(), frames,
          weight.contiguous(), gn_scale.contiguous(), gn_bias.contiguous(), scratch, out, b, n,
          t, c, int(lengths is not None), float(eps))
    conv0_norm_gelu.launches += 1
    return out


conv0_norm_gelu.launches = 0


def feature_conv_reference(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                           stride: int, gelu: bool,
                           cdt: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain strided conv: ``x`` (B, T, C_in), ``weight`` (C_out, C_in, K),
    ``bias`` (C_out,) or None → the VALID conv (operands and result in
    ``cdt``), GELU'd if ``gelu``, as a (B, T_out, C_out) view of a (B, C_out,
    T_out) tensor in ``cdt``."""
    h = conv1d(x.transpose(1, 2), weight, bias, cdt, stride=stride)
    return (F.gelu(h) if gelu else h).transpose(1, 2)


def feature_conv_smem_bytes(bm: int, bn: int) -> int:
    """A block's dynamic shared memory, as ``csrc/feature_conv.cu`` sizes it:
    a ring of ``FEAT_STAGES`` stages, each ``bm`` rows of A (``FEAT_BK``
    floats, padded by 4) and ``FEAT_BK`` rows of ``bn`` weights."""
    return 4 * FEAT_STAGES * (bm * (FEAT_BK + 4) + FEAT_BK * bn)


def feature_conv_plans(m: int, c_out: int, kc: int, n_sms: int) -> Dict[Tuple[int, int, int],
                                                                         float]:
    """Every (rows, channels, splits) plan of the kernel for ``m`` output rows
    (B T_out) of ``c_out`` channels over ``kc`` = K C_in on a card of
    ``n_sms`` SMs, with its modelled cost. A thread computes 8 × 8 outputs at
    every tile, and a scheduler (four an SM) issues one of its warps' FMAs a
    cycle: a round of resident blocks lasts as many warp-stages as its
    busiest scheduler holds warps, a last partial round ``FEAT_TAIL`` of
    that, and the call its rounds. Over several rounds a smaller tile copies
    more a FMA (``FEAT_TILE_COST``). A split of the reduction, planned only
    where the tiles alone do not fill a round and leaving no split empty,
    adds its partials' traffic, the last block's sum and the arrivals'
    memset (``FEAT_SPLIT_COST``)."""
    n_stages = -(-kc // FEAT_BK)
    costs = {}
    for (bm, bn), blocks_sm in FEAT_TILES.items():
        threads = bm * bn // 64
        per_sm = min(blocks_sm, SMEM_SM // (feature_conv_smem_bytes(bm, bn) + 1024))
        tiles = -(-m // bm) * -(-c_out // bn)

        def round_cost(blocks: int) -> int:  # warp-stages of a round of ``blocks`` blocks
            return -(-(-(-blocks // n_sms) * threads) // 128)

        for splits in range(1, min(FEAT_MAX_SPLITS, n_stages) + 1):
            per = -(-n_stages // splits)
            if (splits - 1) * per >= n_stages or (splits > 1 and tiles >= n_sms * per_sm):
                continue
            full, rest = divmod(tiles * splits, n_sms * per_sm)
            cost = (full * round_cost(n_sms * per_sm) + FEAT_TAIL * round_cost(rest)) * per
            if full:
                cost *= 1 + FEAT_TILE_COST / bm + FEAT_TILE_COST / bn
            if splits > 1:  # the last block's sum, and every partial out and in at 64 B/cycle an SM
                cost += (FEAT_SPLIT_COST + (splits + 1) * bm * bn / 16_384
                         + splits * tiles * bm * bn / (8_192 * n_sms))
            costs[(bm, bn, splits)] = cost
    return costs


@functools.lru_cache(maxsize=1024)  # a pure function of four ints, called once a conv
def feature_conv_plan(m: int, c_out: int, kc: int, n_sms: int) -> Tuple[int, int, int]:
    """The cheapest of :func:`feature_conv_plans`; of equal cost, fewer
    splits, then the smaller tile (more blocks to spread)."""
    costs = feature_conv_plans(m, c_out, kc, n_sms)
    return min(costs, key=lambda p: (costs[p], p[2], p[0] * p[1]))


def _check_feat(x, weight, bias, stride) -> None:
    if x.ndim != 3 or weight.ndim != 3 or weight.shape[1] != x.shape[2]:
        raise ValueError(f"expected x (B, T, C_in) and weight (C_out, C_in, K), got "
                         f"{tuple(x.shape)}, {tuple(weight.shape)}")
    if bias is not None and bias.shape != (weight.shape[0],):
        raise ValueError(f"expected bias of ({weight.shape[0]},), got {tuple(bias.shape)}")
    if stride < 1:
        raise ValueError(f"stride {stride} is not positive")
    if x.shape[1] < weight.shape[2]:
        raise ValueError(f"{x.shape[1]} frames are fewer than the conv's {weight.shape[2]} taps")
    tensors = [x, weight] + ([] if bias is None else [bias])
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"inputs on {[str(t.device) for t in tensors]}")


def _feature_conv_weights(weight: torch.Tensor) -> torch.Tensor:
    """(C_out, C_in, K) → (K C_in, C_out), contiguous: row k C_in + c is tap
    k of input channel c, as the kernel's rows of A hold them."""
    c_out, c_in, k = weight.shape
    return weight.permute(2, 1, 0).contiguous().view(k * c_in, c_out)


def _launch_feature_conv(x: torch.Tensor, wt: torch.Tensor, bias: Optional[torch.Tensor],
                         out: torch.Tensor, stride: int, plan: Tuple[int, int, int],
                         gelu: bool) -> None:
    b, t, c_in = x.shape
    _, t_out, c_out = out.shape
    bm, bn, splits = plan
    if splits > 1:
        tiles = -(-b * t_out // bm) * -(-c_out // bn)
        partials = torch.empty(tiles * splits * bm * bn, device=x.device, dtype=torch.float32)
        arrivals = torch.zeros(tiles, device=x.device, dtype=torch.int32)
    else:
        partials = arrivals = out  # not read
    _call("feature_conv", "feature_conv_f32", x.device, x, wt, out if bias is None else bias,
          out, partials, arrivals, b, t, t_out, c_in, c_out, stride, wt.shape[0] // c_in, bm, bn,
          splits, int(bias is not None), int(gelu))


def feature_conv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                 stride: int, gelu: bool, cdt: torch.dtype = torch.float32) -> torch.Tensor:
    """The feature encoder's strided conv (+ bias) (+ GELU): (B, T, C_in) →
    (B, T_out, C_out), T_out = (T − K) // stride + 1, as
    :func:`feature_conv_reference` at ``cdt``. The kernel returns a contiguous
    float32 tensor; it reads ``x`` contiguous, so a transposed view is copied
    once. Inference only: the kernel has no backward."""
    _check_feat(x, weight, bias, stride)
    if not _uses_kernel(x.device, cdt):
        return feature_conv_reference(x, weight, bias, stride, gelu, cdt)
    b, t, c_in = x.shape
    c_out, _, k = weight.shape
    tensors = (x, weight) + (() if bias is None else (bias,))
    if not all(a.dtype == torch.float32 for a in tensors):
        raise TypeError(f"expected float32, got {[a.dtype for a in tensors]}")
    if c_in % 4 or c_out % 4:
        raise ValueError(f"the kernel takes C_in and C_out multiples of 4, got {c_in}, {c_out}")
    t_out = (t - k) // stride + 1
    if b * t_out >= 2 ** 31:
        raise ValueError(f"the kernel takes fewer than 2^31 output frames, got {b * t_out}")
    if torch.is_grad_enabled() and any(a.requires_grad for a in tensors):
        raise RuntimeError("feature_conv has no backward on CUDA: call it under "
                           "torch.no_grad() or torch.inference_mode()")
    out = torch.empty((b, t_out, c_out), device=x.device, dtype=torch.float32)
    if b == 0:
        return out
    x = x.contiguous()
    bias = None if bias is None else bias.contiguous()
    if x.data_ptr() % 16 or (bias is not None and bias.data_ptr() % 16):
        raise ValueError("the kernel reads x and bias 16-byte aligned")
    n_sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = feature_conv_plan(b * t_out, c_out, k * c_in, n_sms)
    _launch_feature_conv(x, _feature_conv_weights(weight), bias, out, stride, plan, gelu)
    feature_conv.launches += 1
    return out


feature_conv.launches = 0


def pos_conv_gelu_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                            groups: int, cdt: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain positional conv: ``x`` (B, T, C), ``weight`` (C, C/groups, K),
    ``bias`` (C,) → GELU of the conv (padding K // 2, the operands and result
    in ``cdt``) as float32, a (B, T, C) view of a (B, C, T) tensor."""
    k = weight.shape[2]
    h = conv1d(x.transpose(1, 2), weight, bias, cdt, padding=(k // 2,), groups=groups).float()
    # Even kernel + symmetric padding yields one extra frame; drop it.
    return F.gelu(h[:, :, : x.shape[1]]).transpose(1, 2)


def pos_conv_smem_bytes(cg: int, kp: int, tile: int) -> int:
    """A block's dynamic shared memory, as ``csrc/pos_conv.cu`` sizes it: the
    input window (cg channels of tile + kp frames) and two weight stages of
    ``POS_TAPS`` taps of cg × cg."""
    return 4 * (cg * (tile + kp) + 2 * POS_TAPS * cg * cg)


def pos_conv_tile(b: int, t: int, groups: int, cg: int, kp: int, n_sms: int) -> int:
    """The kernel's frame tile (its threads a block) for ``b`` rows of ``t``
    frames, ``groups`` groups of ``cg`` channels and ``kp`` taps on a card of
    ``n_sms`` SMs. A warp's work is the same at every tile, and its FMAs
    keep a scheduler (four an SM) nearly busy alone: a round of resident
    blocks lasts as many warp times as the busiest scheduler holds warps,
    and the call its rounds (a sweep of every tile on the H100 at both
    encoders' shapes bears this out). The cheapest tile wins; of equal cost,
    the one with more warps resident, then the larger."""
    best = None
    for tile in POS_TILES:
        smem = pos_conv_smem_bytes(cg, kp, tile)
        if smem > SMEM_BLOCK:
            continue
        per_sm = min(SMEM_SM // (smem + 1024), 2048 // tile)
        blocks = b * groups * -(-t // tile)
        rounds = -(-blocks // (n_sms * per_sm))
        warps = per_sm * tile // 32
        key = (rounds * -(-warps // 4), -warps, -tile)
        if best is None or key < best[0]:
            best = (key, tile)
    if best is None:
        raise ValueError(f"no frame tile of the positional conv's kernel fits a block's shared "
                         f"memory at {cg} channels a group and {kp} taps")
    return best[1]


def _check_pos(x, weight, bias, groups) -> None:
    if x.ndim != 3 or weight.ndim != 3:
        raise ValueError(f"expected x (B, T, C) and weight (C, C/groups, K), got "
                         f"{tuple(x.shape)}, {tuple(weight.shape)}")
    c = x.shape[2]
    if groups < 1 or c % groups:
        raise ValueError(f"{groups} groups do not divide {c} channels")
    if weight.shape[:2] != (c, c // groups) or weight.shape[2] < 1:
        raise ValueError(f"expected weight ({c}, {c // groups}, K), got {tuple(weight.shape)}")
    if bias.shape != (c,):
        raise ValueError(f"expected bias of ({c},), got {tuple(bias.shape)}")
    tensors = (x, weight, bias)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"inputs on {[str(t.device) for t in tensors]}")
    if not all(t.dtype == torch.float32 for t in tensors):
        raise TypeError(f"expected float32, got {[t.dtype for t in tensors]}")


def _pos_conv_weights(weight: torch.Tensor, groups: int) -> torch.Tensor:
    """(C, C/G, K) → (G, Kp, C/G in, C/G out), contiguous, taps K..Kp zero."""
    c, cg, k = weight.shape
    wt = weight.reshape(groups, cg, cg, k).permute(0, 3, 2, 1)
    kp = -(-k // POS_TAPS) * POS_TAPS
    return F.pad(wt, (0, 0, 0, 0, 0, kp - k)) if kp != k else wt.contiguous()


def _launch_pos_conv(x: torch.Tensor, wt: torch.Tensor, bias: torch.Tensor, out: torch.Tensor,
                     pad: int, tile: int) -> None:
    b, t, c = x.shape
    _call("pos_conv", "pos_conv_gelu_f32", x.device, x, wt, bias, out, b, t, c, wt.shape[2],
          wt.shape[1], pad, tile)


def pos_conv_gelu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  groups: int, cdt: torch.dtype = torch.float32) -> torch.Tensor:
    """GELU of the grouped positional conv: (B, T, C) → (B, T, C) float32,
    as :func:`pos_conv_gelu_reference` at ``cdt``. Inference only: the
    kernel has no backward."""
    _check_pos(x, weight, bias, groups)
    if not _uses_kernel(x.device, cdt):
        return pos_conv_gelu_reference(x, weight, bias, groups, cdt)
    b, t, c = x.shape
    cg, k = c // groups, weight.shape[2]
    if cg % POS_LANES or cg > POS_MAX_GROUP:
        raise ValueError(f"the kernel takes groups of 8, 16, ..., {POS_MAX_GROUP} channels, "
                         f"got {cg}")
    if b > MAX_ROWS or groups > MAX_ROWS:
        raise ValueError(f"the kernel takes at most {MAX_ROWS} rows and groups, got {b}, {groups}")
    if not x.is_contiguous():
        raise ValueError("the kernel reads contiguous (B, T, C) hidden states")
    bias = bias.contiguous()
    if x.data_ptr() % 16 or bias.data_ptr() % 16:
        raise ValueError("the kernel reads x and bias 16-byte aligned")
    if torch.is_grad_enabled() and any(a.requires_grad for a in (x, weight, bias)):
        raise RuntimeError("pos_conv_gelu has no backward on CUDA: call it under "
                           "torch.no_grad() or torch.inference_mode()")
    out = torch.empty((b, t, c), device=x.device, dtype=torch.float32)
    if b * t == 0:
        return out
    wt = _pos_conv_weights(weight, groups)
    n_sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    _launch_pos_conv(x, wt, bias, out, k // 2, pos_conv_tile(b, t, groups, cg, wt.shape[1], n_sms))
    pos_conv_gelu.launches += 1
    return out


pos_conv_gelu.launches = 0
