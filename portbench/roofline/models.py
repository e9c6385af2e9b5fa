"""Model FLOPs of both models from the config's widths (multiply-adds count 2).

The widths are the configuration file's ``conf`` keys. A product of an
(m x k) input with a (k x n) weight is 2 m k n; element-wise work, the
normalisations and the softmaxes are left out. Training counts three
times the forward of what is trained (forward, and the backward's two
products) and once the forward of what is frozen.
"""


def widths(conf: dict) -> dict:
    g = conf.get
    return {
        "mel": g("dim_mel_freq", 80), "ch": g("model.encoder.channels", 512),
        "z": g("dim_latent", 64), "c": g("dim_cpc_context", 256),
        "codes": g("size_latent_codebook", 512),
        "spk": g("training_vocoder.model.network.dim_speaker_embedding", 64),
        "voc_latent": g("training_vocoder.model.network.rnnms.dim_voc_latent", 256),
        "prenet_layers": g("training_vocoder.model.network.rnnms.prenet.num_layers", 2),
        "embed_ar": g("training_vocoder.model.network.rnnms.wave_ar.size_i_embed_ar", 256),
        "h": g("training_vocoder.model.network.rnnms.wave_ar.size_h_rnn", 896),
        "fc": g("training_vocoder.model.network.rnnms.wave_ar.size_h_fc", 256),
        "classes": 2 ** g("bit_mulaw", 8), "hop": g("data.dataset.mel_stft_stride", 160),
        "k_steps": g("training.cpc.n_prediction_steps", 12) // 2,
        "negatives": g("training.cpc.n_negatives", 17),
    }


def prenet_per_frame(w: dict) -> float:
    """The PreNet's bidirectional GRU layers, per conditioning frame."""
    h = w["voc_latent"] // 2
    d, total = w["z"] + w["spk"], 0.0
    for _ in range(w["prenet_layers"]):
        total += 2 * (2 * d * 3 * h + 2 * h * 3 * h)
        d = 2 * h
    return total


def decode_per_sample(w: dict) -> float:
    """The AR network per sample: the GRU's input and recurrent products, FC1, FC2."""
    h = w["h"]
    return 2.0 * ((w["embed_ar"] + w["voc_latent"]) * 3 * h + h * 3 * h + h * w["fc"]
                  + w["fc"] * w["classes"])


def served_per_sample(w: dict) -> float:
    """Converting one sample: the decode plus its share of the conditioning."""
    return decode_per_sample(w) + prenet_per_frame(w) / w["hop"]


def encoder_per_latent(w: dict) -> float:
    """The encoder's conv, SegFC stack, output projection and VQ distances, per latent frame."""
    ch = w["ch"]
    return 2.0 * (4 * w["mel"] * ch + 4 * ch * ch + ch * w["z"] + w["z"] * w["codes"])


def vocoder_train_step(w: dict, batch: int, samples: int) -> float:
    """One vocoder training step: the trained vocoder three times, the frozen encoder once."""
    frames = samples // w["hop"]
    trained = samples * decode_per_sample(w) + frames * prenet_per_frame(w)
    return batch * (3 * trained + (frames // 2) * encoder_per_latent(w))


def cpc_train_step(w: dict, clips: int, frames: int) -> float:
    """One CPC training step over ``clips`` clips of ``frames`` mel frames."""
    t = frames // 2
    length = t - w["k_steps"]
    lstm = 2.0 * (w["z"] + w["c"]) * 4 * w["c"]
    per_clip = t * (encoder_per_latent(w) + lstm)
    per_clip += w["k_steps"] * length * (2.0 * w["c"] * w["z"]
                                         + (1 + w["negatives"]) * 2.0 * w["z"])
    return 3 * clips * per_clip
