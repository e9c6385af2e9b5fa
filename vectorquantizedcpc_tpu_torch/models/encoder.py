"""VQ-CPC encoder: strided Conv1d -> segmental FC stack -> VQ (inference).

The reference Encoder's layers under its ``state_dict`` names
(reference model.py:33-57)::

    conv     Conv1d(80 -> 512, k=4, s=2, p=1, no bias)   time / 2
    encoder  LN, ReLU, 4 x [Linear(512, 512, no bias), LN, ReLU], Linear(512 -> 64)
    codebook VQ-EMA buffers
    rnn      LSTM(64 -> 256) context network

``encode`` returns the quantized latents and their codes. The LSTM is held
so that checkpoints load with ``strict=True``; conversion never uses the
context it computes.
"""

from typing import Tuple

import torch
from torch import nn

from ..configs import ConfEncoder
from .vq import VQEmbeddingEMA


class Encoder(nn.Module):
    def __init__(self, conf: ConfEncoder):
        super().__init__()
        ch = conf.channels
        self.conv = nn.Conv1d(conf.in_channels, ch, 4, 2, 1, bias=False)
        layers = [nn.LayerNorm(ch), nn.ReLU()]
        for _ in range(4):
            layers += [nn.Linear(ch, ch, bias=False), nn.LayerNorm(ch), nn.ReLU()]
        layers.append(nn.Linear(ch, conf.z_dim))
        self.encoder = nn.Sequential(*layers)
        self.codebook = VQEmbeddingEMA(conf.n_embeddings, conf.z_dim)
        self.rnn = nn.LSTM(conf.z_dim, conf.c_dim, batch_first=True)

    def frontend(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, Freq, T) -> pre-VQ latents (B, T // 2, z_dim), in float32.

        Padding (1, 1) gives floor(T / 2) frames for odd T too. TF32 is
        off for the convolution, which cuDNN would otherwise run in TF32.
        """
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            x = self.conv(mel.float())
        return self.encoder(x.transpose(1, 2))

    @torch.no_grad()
    def encode(self, mel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, Freq, T) mel -> (z (B, T // 2, z_dim), codes (B, T // 2))."""
        return self.codebook.encode(self.frontend(mel))
