"""VQ-CPC encoder: strided Conv1d -> segmental FC stack -> VQ -> LSTM context.

The reference Encoder's layers under its ``state_dict`` names
(reference model.py:33-57)::

    conv     Conv1d(80 -> 512, k=4, s=2, p=1, no bias)   time / 2
    encoder  LN, ReLU, 4 x [Linear(512, 512, no bias), LN, ReLU], Linear(512 -> 64)
    codebook VQ-EMA buffers
    rnn      LSTM(64 -> 256) context network

``encode`` returns the quantized latents, the LSTM's context series and
the codes, as the JAX package's ``encoder_encode`` does. Conversion asks
for the codes alone and skips the context; the code export dumps all three.
``forward`` is the training path (``encoder_forward``): it steps the VQ-EMA
buffers and returns the straight-through latents, the context, the
commitment loss and the perplexity.
The modules hold the parameters; the arithmetic is written out, so that it
rounds where the JAX package's ``_frontend`` rounds at each compute dtype.

Tensor parallel (``model``, a ``parallel/tensor.ModelGroup``, in
training): a tensor that ``parallel/tensor.shard_module_`` cut holds this
rank's slice. The conv and the SegFC Linears are column-parallel, gathered
before each LayerNorm, whose statistics need every channel; the output
projection is row-parallel, the ranks' partial products summed before the
bias; the VQ step and the LSTM are ``vq_apply_train``'s and
``lstm_apply``'s.
"""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import ConfEncoder
from ..parallel.tensor import (ModelGroup, column_product, copy_to_model, reduce_from_model,
                               split_on)
from .matmul import rows_matmul
from .rnn import lstm_apply
from .vq import VQEmbeddingEMA, vq_apply_train


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

    def frontend(
        self,
        mel: torch.Tensor,
        compute_dtype: torch.dtype = torch.float32,
        model: Optional[ModelGroup] = None,
    ) -> torch.Tensor:
        """(B, Freq, T) -> pre-VQ latents (B, T // 2, z_dim) at ``compute_dtype``.

        The conv is an unfold and one matmul, as the JAX package does it;
        padding (1, 1) gives floor(T / 2) frames for odd T too. Each conv
        and Linear runs at the compute dtype with outputs there, LayerNorm
        statistics are f32 with the output cast back, and the output bias
        is added at the compute dtype. At float32 every frame's arithmetic
        is the same at any batch size and length (``rows_matmul``); TF32
        must stay off for matmuls (PyTorch's default). With ``model`` the
        products take this rank's shards (the class docstring).
        """
        dt = compute_dtype
        x = mel.transpose(1, 2).to(dt)  # (B, T, Freq)
        t_out = x.shape[1] // 2
        xp = F.pad(x, (0, 0, 1, 1))
        cols = torch.cat([xp[:, j : j + 2 * t_out - 1 : 2] for j in range(4)], dim=-1)
        w = self.conv.weight  # (C, Freq, 4) -> (4 Freq, C), window-position-major
        x = column_product(cols, w.permute(2, 1, 0).reshape(-1, w.shape[0]).to(dt),
                           rows_matmul, split_on(model, w))
        for layer in self.encoder:
            if isinstance(layer, nn.LayerNorm):
                x = F.layer_norm(
                    x.float(), layer.normalized_shape, layer.weight, layer.bias, layer.eps
                ).to(dt)
            elif isinstance(layer, nn.Linear):
                rows = split_on(model, layer.weight, 1)
                if rows is not None:  # this rank's inputs times its rows, summed
                    k = layer.weight.shape[1]
                    x = copy_to_model(x, rows).narrow(-1, rows.rank * k, k)
                    x = reduce_from_model(rows_matmul(x, layer.weight.t().to(dt)), rows)
                else:
                    x = column_product(x, layer.weight.t().to(dt), rows_matmul,
                                       split_on(model, layer.weight))
                if layer.bias is not None:
                    x = x + layer.bias.to(dt)
            else:
                x = layer(x)
        return x

    def context(
        self,
        z: torch.Tensor,
        compute_dtype: torch.dtype = torch.float32,
        state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        model: Optional[ModelGroup] = None,
    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """The LSTM over latents (B, T', z_dim) -> ((B, T', c_dim), (h, c))."""
        return lstm_apply(
            z.to(compute_dtype), self.rnn.weight_ih_l0, self.rnn.weight_hh_l0,
            self.rnn.bias_ih_l0, self.rnn.bias_hh_l0, state, compute_dtype, model,
        )

    def forward(
        self,
        mels: torch.Tensor,
        compute_dtype: torch.dtype = torch.float32,
        group=None,
        model: Optional[ModelGroup] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Training path: (B, Freq, T) -> (z_st (B, T', z_dim) f32, c (B, T',
        c_dim) f32, vq_loss, perplexity), one EMA step of the codebook (on
        the statistics of every rank of the data ``group``, if given), the
        products over this rank's shards with ``model``."""
        z_pre = self.frontend(mels, compute_dtype, model)
        z, vq_loss, perplexity = vq_apply_train(self.codebook, z_pre.float(), group=group,
                                                model=model)
        c, _ = self.context(z, compute_dtype, model=model)
        return z, c.float(), vq_loss, perplexity

    @torch.no_grad()
    def encode(
        self,
        mel: torch.Tensor,
        compute_dtype: torch.dtype = torch.float32,
        return_context: bool = True,
        return_pre_vq: bool = False,
    ) -> tuple:
        """(B, Freq, T) mel -> (z, c, codes[, z_pre]), T' = T // 2.

        z (B, T', z_dim) and c (B, T', c_dim) are float32, codes (B, T')
        int64; ``return_pre_vq`` adds the pre-VQ latents in float32. Without
        ``return_context`` the LSTM does not run and c is left out. VQ runs
        in float32 whatever the compute dtype.
        """
        z_pre = self.frontend(mel, compute_dtype)
        z, codes = self.codebook.encode(z_pre.float())
        out: tuple = (z,)
        if return_context:
            out += (self.context(z, compute_dtype)[0].float(),)
        out += (codes,)
        if return_pre_vq:
            out += (z_pre.float(),)
        return out
