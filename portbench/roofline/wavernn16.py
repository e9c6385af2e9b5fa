"""Model FLOPs of WaveRNN-896's dual softmax vocoder from the config's widths.

A served sample: the GRU's input product (the two byte inputs and the
conditioning, 2 + V -> 3H), its recurrent product (H -> 3H), c_t's column
into the fine half's gates (H/2 x 3), and the two heads (H/2 -> H/2 ->
256 each); plus its share of the PreNet's conditioning (``models.py``).
Multiply-adds count 2.
"""

from .models import prenet_per_frame

CLASSES = 256  # each softmax's classes: one byte


def decode_per_sample(w: dict) -> float:
    h = w["h"]
    half = h // 2
    return 2.0 * ((2 + w["voc_latent"]) * 3 * h + h * 3 * h + 3 * half
                  + 2 * (half * half + half * CLASSES))


def served_per_sample(w: dict) -> float:
    """Converting one 16-bit sample: the decode plus its share of the conditioning."""
    return decode_per_sample(w) + prenet_per_frame(w) / w["hop"]
