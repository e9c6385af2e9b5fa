"""Weights between the packages: JAX params -> port -> JAX, and reference .pt files."""

import numpy as np
import pytest
import torch

from torch_port_util import (  # noqa: F401
    SMALL, flat, jax_models, module_time_limit, port_models, time_limit,
)
from vectorquantizedcpc_tpu.training.torch_import import import_encoder, import_vocoder
from vectorquantizedcpc_tpu_torch.models.vocoder import Vocoder
from vectorquantizedcpc_tpu_torch.weights import (
    load_cpc_checkpoint,
    load_vocoder_checkpoint,
)

TIME_LIMIT_S = 60  # each test's own limit (torch_port_util.time_limit)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    conf, enc, vq, voc = jax_models(SMALL, seed=3)
    pconf, encoder, vocoder = port_models(SMALL, enc, vq, voc)
    return (enc, vq, voc), pconf, encoder, vocoder


def _assert_trees_equal(a, b):
    fa, fb = flat(a), flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_from_jax_params_round_trips_exactly(models):
    (enc, vq, voc), _, encoder, vocoder = models
    enc2, vq2 = import_encoder(encoder.state_dict())
    _assert_trees_equal(enc, enc2)
    _assert_trees_equal(vq, vq2)
    _assert_trees_equal(voc, import_vocoder(vocoder.state_dict()))


def _foreign_names(sd):
    """The same vocoder under other rnnms attribute names, as a checkpoint of
    the external package may hold them."""
    rename = {"rnnms.prenet.": "core.conditioner.gru.", "rnnms.rnn.": "core.ar.cell.",
              "rnnms.embedding.": "core.ar.emb.", "rnnms.fc1.": "core.ar.head_a.",
              "rnnms.fc2.": "core.ar.head_b."}
    out = {}
    for k, v in sd.items():
        for old, new in rename.items():
            if k.startswith(old):
                k = new + k[len(old):]
        out[k] = v
    return out


@pytest.mark.parametrize("fmt", ["raw", "legacy", "lightning"])
def test_vocoder_checkpoint_formats(models, tmp_path, fmt):
    _, pconf, _, vocoder = models
    sd = _foreign_names(vocoder.state_dict())
    ckpt = {
        "raw": sd,
        "legacy": {"vocoder": sd},
        "lightning": {
            "state_dict": {**{f"model.{k}": v for k, v in sd.items()},
                           "encoder.conv.weight": torch.zeros(1)},
            "epoch": 3,
        },
    }[fmt]
    torch.save(ckpt, tmp_path / "voc.pt")
    loaded = Vocoder(pconf.training_vocoder.model.network)
    loaded.load_state_dict(load_vocoder_checkpoint(tmp_path / "voc.pt"), strict=True)
    for k, v in vocoder.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


def test_cpc_checkpoint(models, tmp_path):
    _, _, encoder, _ = models
    torch.save({"encoder": encoder.state_dict(), "cpc": {}, "epoch": 5}, tmp_path / "c.pt")
    sd = load_cpc_checkpoint(tmp_path / "c.pt")
    assert sd.keys() == encoder.state_dict().keys()
    assert all(torch.equal(sd[k], v) for k, v in encoder.state_dict().items())
