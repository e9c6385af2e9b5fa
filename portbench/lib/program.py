"""The program's config and its models, as the drivers build them from the seed.

The drivers import the program's entry points themselves
(``ContinuousBatcher``, the trainers, the datasets); this module holds what
they share: the ``ConfGlobal`` of a configuration file and the models drawn
on the card from the seed.
"""

import json
from typing import Dict, Optional

from .inputs import fill_from_seed, sub_seed

# A trained codebook sits at the scale of the encoder's outputs (about 0.4
# per channel with these initialisations), so the frozen encoder's codebook
# is drawn there: +-0.7 uniform has that spread.
FROZEN_CODEBOOK_BOUND = 0.7


def port_conf(config: dict, extra: Optional[Dict[str, object]] = None):
    """The program's ``ConfGlobal`` of the configuration file's keys, then ``extra``."""
    from vectorquantizedcpc_tpu_torch.configs import load_conf

    keys = dict(config["conf"], **(extra or {}))
    return load_conf([f"{k}={json.dumps(v)}" for k, v in keys.items()])


def seeded_vocoder(conf, seed: int, device):
    """(Vocoder on ``device`` drawn from the seed, its float32 state)."""
    from vectorquantizedcpc_tpu_torch.models.vocoder import Vocoder

    vocoder = Vocoder(conf.training_vocoder.model.network).to(device)
    return vocoder, fill_from_seed(vocoder, sub_seed(seed, "vocoder"))


def seeded_encoder(conf, seed: int, device, frozen: bool):
    """(Encoder on ``device`` drawn from the seed, its float32 state). A
    frozen encoder's codebook is drawn at the latents' scale; a trained
    one's as the reference initialises it, with the LSTM's second bias at 0
    (the trainer trains one bias)."""
    from vectorquantizedcpc_tpu_torch.models.encoder import Encoder

    encoder = Encoder(conf.model.encoder).to(device)
    bound = FROZEN_CODEBOOK_BOUND if frozen else 1.0 / 512
    return encoder, fill_from_seed(encoder, sub_seed(seed, "encoder"), bound,
                                   zero=("rnn.bias_hh_l0",))
