"""Port's CNN-LSTM vs the JAX package's, on the CPU.

JAX ``CNNLSTM`` (input 12, cnn 8, lstm 6, 2 layers) with perturbed weights and
random BatchNorm statistics → ``flatten_params`` → the port's weight carry →
port ``CNNLSTM``. Logits must match (atol 1e-4: float32 convs, BatchNorm and
two biLSTM layers summed in other orders).

With ``lengths`` the JAX CPU path freezes LSTM state past each length while
the port (like the TPU kernel) does not, so biLSTM outputs differ past a
sequence's end; logits and valid frames agree because nothing reads those
frames.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from robust_speech_analysis_framework_tpu.models.cnn_lstm import (
    CNNLSTM as JaxCNNLSTM,
    get_activation_fn as jax_activation,
    stability_probe as jax_stability_probe,
)
from robust_speech_analysis_framework_tpu.models.torch_port import port_torch_cnn_lstm
from robust_speech_analysis_framework_tpu.train.checkpoints import flatten_params
from robust_speech_analysis_framework_tpu_torch.models.cnn_lstm import (
    CNNLSTM,
    build_cnn_lstm,
    get_activation_fn,
    stability_probe,
)
from robust_speech_analysis_framework_tpu_torch.models.weights import (
    cnn_lstm_state_dict_from_flat,
    infer_architecture,
)

ATOL = 1e-4
DIMS = dict(input_dim=12, cnn_out_channels=8, lstm_hidden_dim=6)
LENGTHS = np.array([40, 23, 9], np.int32)


def _jax_model_and_vars(activation: str, seed: int):
    model = JaxCNNLSTM(**DIMS, activation_fn=activation)
    variables = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 16, 12)), train=False)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32),
        variables["params"],
    )
    stats = jax.tree.map(
        lambda a: (rng.uniform(0.5, 1.5, size=a.shape) if a.ndim else a).astype(np.float32),
        variables["batch_stats"],
    )
    for block in stats.values():
        for bn in block.values():
            bn["mean"] = (rng.normal(size=bn["mean"].shape) * 0.2).astype(np.float32)
    return model, {"params": params, "batch_stats": stats}


def _port_model(variables, activation: str) -> CNNLSTM:
    model = CNNLSTM(**DIMS, activation_fn=activation)
    model.load_state_dict(cnn_lstm_state_dict_from_flat(flatten_params(variables)))
    return model.eval()


@pytest.fixture(scope="module")
def batch():
    return np.random.default_rng(7).normal(size=(3, 40, 12)).astype(np.float32)


@pytest.mark.parametrize("activation", ["silu", "gelu"])
@pytest.mark.parametrize("masked", [True, False], ids=["lengths", "no_lengths"])
def test_logits_match_jax(batch, activation, masked):
    jmodel, variables = _jax_model_and_vars(activation, seed=1 if masked else 2)
    lengths = LENGTHS if masked else None
    ref = np.asarray(jmodel.apply(
        variables, jnp.asarray(batch), train=False,
        lengths=None if lengths is None else jnp.asarray(lengths),
    ))
    model = _port_model(variables, activation)
    with torch.no_grad():
        ours = model(
            torch.from_numpy(batch), None if lengths is None else torch.from_numpy(lengths)
        ).numpy()
    np.testing.assert_allclose(ours, ref, atol=ATOL)


def test_logits_ignore_padding_content(batch):
    _, variables = _jax_model_and_vars("silu", seed=3)
    model = _port_model(variables, "silu")
    noisy = batch.copy()
    for i, n in enumerate(LENGTHS):
        noisy[i, n:] = 5.0
    lengths = torch.from_numpy(LENGTHS)
    with torch.no_grad():
        a = model(torch.from_numpy(batch), lengths)
        b = model(torch.from_numpy(noisy), lengths)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_stability_probe_matches_jax():
    _, variables = _jax_model_and_vars("silu", seed=4)
    ours = stability_probe(_port_model(variables, "silu")).numpy()
    np.testing.assert_allclose(ours, np.asarray(jax_stability_probe(variables)), atol=1e-7)


def test_state_dict_has_reference_checkpoint_names(batch):
    """The port's state_dict() goes through the JAX package's reference-.pt
    porter (which reads the reference PyTorch names) to the same logits."""
    jmodel, variables = _jax_model_and_vars("gelu", seed=5)
    model = _port_model(variables, "gelu")
    sd = model.state_dict()
    assert "res_block1.shortcut.0.weight" in sd and "res_block2.conv1.weight" in sd
    assert "lstm.weight_hh_l1_reverse" in sd and "attention_pooling.attention_weights.bias" in sd
    assert not any(k.startswith("res_block2.shortcut") for k in sd)  # 8 → 8 channels
    assert infer_architecture(sd) == {**DIMS, "lstm_layers": 2, "num_classes": 2}
    back = port_torch_cnn_lstm(sd)
    x = jnp.asarray(batch)
    lengths = jnp.asarray(LENGTHS)
    np.testing.assert_allclose(
        np.asarray(jmodel.apply(back, x, train=False, lengths=lengths)),
        np.asarray(jmodel.apply(variables, x, train=False, lengths=lengths)),
        atol=1e-5,
    )


def test_gelu_is_exact_erf_form():
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    ref = np.asarray(jax_activation("gelu")(jnp.asarray(x)))
    ours = get_activation_fn("gelu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-6)
    with pytest.raises(ValueError):
        get_activation_fn("relu")


def test_builder_is_seeded_and_inference_only():
    a = build_cnn_lstm(**DIMS, seed=3, device="cpu")
    b = build_cnn_lstm(**DIMS, seed=3, device="cpu")
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert not a.training
    # train mode runs, and moves the BatchNorm running statistics as Flax
    # does: ra = 0.99 * ra + 0.01 * batch, with the biased batch variance
    seen = {}
    a.res_block1.conv1.register_forward_hook(lambda m, i, o: seen.update(x=o.detach()))
    before_mean = a.res_block1.bn1.running_mean.clone()
    before_var = a.res_block1.bn1.running_var.clone()
    a.train()
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 8, 12)).astype(np.float32))
    logits = a(x, generator=torch.Generator().manual_seed(0))
    assert logits.shape == (2, 2) and torch.isfinite(logits).all()
    batch_mean = seen["x"].mean(dim=(0, 2))
    batch_var = seen["x"].var(dim=(0, 2), unbiased=False)
    torch.testing.assert_close(a.res_block1.bn1.running_mean,
                               0.99 * before_mean + 0.01 * batch_mean, rtol=0, atol=1e-6)
    torch.testing.assert_close(a.res_block1.bn1.running_var,
                               0.99 * before_var + 0.01 * batch_var, rtol=0, atol=1e-6)
