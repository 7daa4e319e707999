"""Port's Viterbi path finder (plain PyTorch versions of K6/K7) vs JAX.

Same seeded numpy inputs go through the JAX package's Pallas kernels in
interpret mode and through the port, for both weight schemes: openSMILE's
(w_vv = wTvv, w_same = wTuu, w_diff = wTvuv, explicit local costs) and
Praat's (w_same = 0, local = −strength). Tolerances: forward costs rtol
1e-6 / atol 1e-4 (float32 min-plus sums over up to 333 steps); paths agree
on ≥ 99.5 % of frames on rounded costs, the JAX test's bound for two
summation orders; the chosen states lie on a globally optimal path within
1e-5 of the brute-force optimum.
"""

import itertools

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from robust_speech_analysis_framework_tpu.ops.pallas import viterbi as jax_viterbi
from robust_speech_analysis_framework_tpu_torch.ops.cuda import _build
from robust_speech_analysis_framework_tpu_torch.ops.cuda import viterbi as port_viterbi

SCHEMES = {"opensmile": (10.0, 0.0, 10.0), "praat": (0.35 * 0.5, 0.0, 0.14 * 0.5)}


def _case(seed, b, t, c, scheme):
    """(lf, v, local) float32 numpy, (B, T, C); costs rounded to 0.01."""
    rng = np.random.default_rng(seed)
    freqs = np.where(rng.random((b, t, c)) < 0.3, 0.0, rng.uniform(60, 500, (b, t, c)))
    lf = np.log2(np.where(freqs > 0, freqs, 1.0)).astype(np.float32)
    v = (freqs > 0).astype(np.float32)
    if scheme == "praat":
        local = -np.round(rng.uniform(-0.5, 1.0, (b, t, c)), 2)
    else:
        local = np.round(rng.uniform(0.0, 3.0, (b, t, c)), 2)
    return lf, v, local.astype(np.float32)


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
@pytest.mark.parametrize("shape", [(3, 37, 7), (3, 333, 15)], ids=["C7", "C15"])
def test_forward_costs_match_pallas_interpret(shape, scheme):
    lf, v, local = _case(0, *shape, scheme)
    w = SCHEMES[scheme]
    ref = np.asarray(jax_viterbi._forward_costs(
        jnp.asarray(lf), jnp.asarray(v), jnp.asarray(local), *w, 128, True))
    ours = port_viterbi.viterbi_forward_costs(*_torch(lf, v, local), *w)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
@pytest.mark.parametrize("shape", [(3, 37, 7), (3, 333, 15)], ids=["C7", "C15"])
def test_path_matches_pallas_interpret(shape, scheme):
    lf, v, local = _case(1, *shape, scheme)
    w = SCHEMES[scheme]
    ref = np.asarray(jax_viterbi.viterbi_path_pallas(
        jnp.asarray(lf), jnp.asarray(v), jnp.asarray(local), *w, True))
    ours = port_viterbi.viterbi_path(*_torch(lf, v, local), *w)
    assert ours.dtype == torch.int64 and ours.shape == shape[:2]
    assert (ours.numpy() == ref).mean() >= 0.995


def _brute_best_through(lf, v, local, w):
    """best[t][j] = the least total cost of a path through state j at t."""
    t_len, c = local.shape
    w_vv, w_same, w_diff = w

    def trans(t, i, j):
        if v[t - 1, i] > 0 and v[t, j] > 0:
            return w_vv * abs(lf[t - 1, i] - lf[t, j])
        return w_same if (v[t - 1, i] > 0) == (v[t, j] > 0) else w_diff

    best = np.full((t_len, c), np.inf)
    for path in itertools.product(range(c), repeat=t_len):
        cost = local[0, path[0]] + sum(
            trans(k, path[k - 1], path[k]) + local[k, path[k]] for k in range(1, t_len))
        for t in range(t_len):
            best[t, path[t]] = min(best[t, path[t]], cost)
    return best


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_path_matches_brute_force(seed, scheme):
    lf, v, local = _case(10 + seed, 1, 5, 3, scheme)
    w = SCHEMES[scheme]
    best = _brute_best_through(lf[0].astype(np.float64), v[0], local[0].astype(np.float64), w)
    path = port_viterbi.viterbi_path(*_torch(lf, v, local), *w).numpy()[0]
    np.testing.assert_allclose(best[np.arange(5), path], best.min(), atol=1e-5)


def test_forward_costs_first_frame_and_recurrence():
    """c[0] = local[0]; c[t] = min_i(c[t−1][i] + trans) + local[t], by hand."""
    lf, v, local = _case(5, 2, 4, 3, "opensmile")
    w_vv, w_same, w_diff = SCHEMES["opensmile"]
    c = port_viterbi.viterbi_forward_costs(*_torch(lf, v, local), w_vv, w_same, w_diff).numpy()
    np.testing.assert_array_equal(c[:, 0], local[:, 0])
    for b in range(2):
        for t in range(1, 4):
            for j in range(3):
                cand = []
                for i in range(3):
                    if v[b, t - 1, i] > 0 and v[b, t, j] > 0:
                        tr = np.float32(w_vv) * np.abs(lf[b, t - 1, i] - lf[b, t, j])
                    elif (v[b, t - 1, i] > 0) == (v[b, t, j] > 0):
                        tr = np.float32(w_same)
                    else:
                        tr = np.float32(w_diff)
                    cand.append(np.float32(c[b, t - 1, i] + tr))
                assert c[b, t, j] == np.float32(min(cand) + local[b, t, j])


def _chain_from_rows(trans, local, first, frames, c_states):
    """The kernel's chain, in plain torch, over rows as its producers lay
    them out: the states padded to CP = 8, 16 or 32 with trans = +inf and
    local = 0, a row per state j of the step's frame holding trans from
    every state i of the frame before and then local[j], consumed in chunks
    of 64, 32 or 16 steps with the state handed from slot to slot.
    trans (B, S, C, C) from i (axis -2) to j, local (B, S, C), first (B, C)
    → costs after each of the S steps, (B, S, C)."""
    cp = 8 if c_states <= 8 else 16 if c_states <= 16 else 32
    assert frames == {8: 64, 16: 32, 32: 16}[cp]
    b, steps = local.shape[:2]
    inf = torch.tensor(float("inf"))
    rows = torch.full((b, steps, cp, cp + 4), 0.0)
    rows[..., :cp] = inf
    rows[:, :, :c_states, :c_states] = trans.transpose(-1, -2)  # [j][i]
    rows[:, :, :c_states, cp] = local
    c = torch.full((b, cp), float("inf"))
    c[:, :c_states] = first
    out = torch.empty(b, steps, c_states)
    for s0 in range(0, steps, frames):
        slots = [c]
        for f in range(min(frames, steps - s0)):
            row = rows[:, s0 + f]
            cand = slots[-1][:, None, :] + row[:, :, :cp]  # [j][i]: c[i] + trans[i][j]
            slots.append(cand.amin(dim=-1) + row[:, :, cp])
        out[:, s0 : s0 + len(slots) - 1] = torch.stack(slots[1:], dim=1)[..., :c_states]
        c = slots[-1]
    return out


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
@pytest.mark.parametrize("c_states,t_len", [(1, 129), (7, 200), (15, 70), (32, 37)])
def test_viterbi_from_transitions(c_states, t_len, scheme):
    """A chain that takes the precomputed transitions chunk by chunk, padded
    and laid out as the kernel reads them, equals the plain forward costs
    bit for bit: forward, and in reverse, where step s goes from frame
    T-s to frame T-1-s with the same table read from the other side and
    its cost lands at frame T-1-s (flip(e))."""
    lf, v, local = _torch(*_case(20 + c_states, 2, t_len, c_states, scheme))
    w = SCHEMES[scheme]
    frames = 64 if c_states <= 8 else 32 if c_states <= 16 else 16
    trans = port_viterbi._transitions(lf, v, *w)
    fwd = _chain_from_rows(trans, local[:, 1:], local[:, 0], frames, c_states)
    ref = port_viterbi.viterbi_forward_costs_reference(lf, v, local, *w)
    assert torch.equal(torch.cat([local[:, :1], fwd], dim=1), ref)
    # reverse: from state i of frame t+1 to state j of frame t is the forward
    # table's [t][j][i], since |a - b| and the voicing rule are symmetric
    back = trans.flip(1).transpose(-1, -2)
    assert torch.equal(back, port_viterbi._transitions(lf.flip(1), v.flip(1), *w))
    rev = _chain_from_rows(back, local.flip(1)[:, 1:], local[:, -1], frames, c_states)
    e = port_viterbi.viterbi_forward_costs_reference(lf.flip(1), v.flip(1), local.flip(1), *w)
    flipped = torch.cat([local[:, -1:], rev], dim=1).flip(1)  # cost of step s at frame T-1-s
    assert torch.equal(flipped, e.flip(1))
    path = port_viterbi._path_from_costs(ref, flipped, local)
    assert torch.equal(path, port_viterbi.viterbi_path_reference(lf, v, local, *w))


@pytest.mark.parametrize("kernel", ["K6", "K7"])
def test_wrappers_send_cpu_tensors_to_plain_version(kernel):
    lf, v, local = _torch(*_case(2, 2, 20, 7, "opensmile"))
    w = SCHEMES["opensmile"]
    wrapper, plain = {
        "K6": (port_viterbi.viterbi_forward_costs, port_viterbi.viterbi_forward_costs_reference),
        "K7": (port_viterbi.viterbi_path, port_viterbi.viterbi_path_reference),
    }[kernel]
    counts = (port_viterbi.viterbi_forward_costs.launches, port_viterbi.viterbi_path.launches)
    torch.testing.assert_close(wrapper(lf, v, local, *w), plain(lf, v, local, *w), rtol=0, atol=0)
    assert (port_viterbi.viterbi_forward_costs.launches,
            port_viterbi.viterbi_path.launches) == counts  # no kernel on the CPU


@pytest.mark.parametrize("bad", ["states", "dtype", "shape", "empty"])
def test_wrappers_reject_what_the_kernel_does_not_take(bad):
    lf, v, local = _torch(*_case(3, 1, 6, 4, "praat"))
    if bad == "states":
        lf = v = local = torch.zeros(1, 6, 33)
    elif bad == "dtype":
        local = local.double()
    elif bad == "shape":
        v = v[:, :5]
    else:
        lf = v = local = torch.zeros(1, 0, 4)
    with pytest.raises((ValueError, TypeError)):
        port_viterbi.viterbi_path(lf, v, local, *SCHEMES["praat"])


def test_c_arguments_keep_floats_as_floats():
    """Weights reach the kernel as C floats, sizes as C ints, tensors as
    pointers (a float passed as an int would truncate the weight)."""
    import ctypes

    assert _build._ctype(torch.zeros(1)) is ctypes.c_void_p
    assert _build._ctype(0.35) is ctypes.c_float
    assert _build._ctype(7) is ctypes.c_int


def test_single_frame_pitch_skips_the_path_finder():
    """T = 1 takes argmin of the local costs (as the JAX chain), not K7."""
    from robust_speech_analysis_framework_tpu_torch.ops.shs_pitch import shs_pitch_batch

    rng = np.random.default_rng(4)
    mag = torch.from_numpy(rng.random((2, 1, 257)).astype(np.float32))
    f0, voc = shs_pitch_batch(mag, 16000, torch.ones(2, 1))
    assert f0.shape == voc.shape == (2, 1) and torch.isfinite(f0).all()
