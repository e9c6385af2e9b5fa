#!/usr/bin/env python3
"""Drive the PyTorch port's voice conversion (bf16, int8, auto), serving, latent export, CPC and vocoder training, and its data plane on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases (any failure ends the run with a non-zero exit):

1. the card's name and power limit, the torch and CUDA versions;
2. build every CUDA kernel of the paths from the sources in the checkout;
3. hold each kernel against its plain PyTorch version on the card, at the
   full width of the default config: the AR decode greedy and sampled, in
   bf16 at B in {1, 3, 8, 32, 64} and in int8 at B in {1, 3, 8, 32, 64,
   128}, and in 4 chained segments in each mode; the GRU scans (plain and
   masked) at the serving PreNet's shape, and the masked grid forward at a
   PreNet of 256 and of 2,500 (wh staged in K chunks); the LSTM scan at
   the export's shape and the CPC training shape; the LSTM scan's training forward and backward (and autograd
   through them) at B 64 / 32 (a rank's share at mesh_data 2) / 3, T 70 /
   1, and the CPC selection forward and backward at the training shape, at
   a rank's S 4, at an L that is not a multiple of 8 and at Z 300, with every collision tied bit for bit; the grid LSTM kernels
   at H 512 and 37 at the export and training shapes, at B 3 (one partial
   row group) and B 1, and at H 1,600 (one row group, wh whole) and 2,048
   (K chunks), with autograd; the GRU scan's grid kernels (training forward, backward,
   and autograd through them) at the vocoder's T 5,120, B 32 and 16 (a
   rank's share at mesh_data 2), H 896, and at B 3, T 1, H 200 and H 2,500 (K chunks), the no-grad forward's bits equal
   to the training forward's; the dual softmax head's decode
   (``ops/dual_decode.py``, ``rnnms.output=dual16``) greedy and sampled at
   B in {1, 8, 64, 128}, its stamped variant's bits, and 4 chained
   segments;
4. convert 8 synthetic wavs end to end through the CLI entry point, on
   full-width random weights saved as reference-format checkpoints, at
   ``runtime.precision`` bfloat16, int8 and auto, and check the wavs and
   that each batch went through the kernel of the mode it resolved to;
4b. serve 48 requests of mixed lengths through ``ContinuousBatcher`` in
   sampled mode with 8 slots, check every wave, the launch counts and the
   seeding, then hold a greedy drain against single-shot decodes; serve
   the same requests with 32 and with 64 slots and check them again; serve
   them at int8 with 8, 32 and 64 slots (the int8 kernel only);
4c. export 40 synthetic mels of 50 to 1,000 frames through the encode CLI
   at the default bf16, check the dumps, that the context LSTM went
   through its kernel once per batch, and that the codes agree with an f32
   export; score the dumps with the ABX CLI;
4d. train the CPC encoder through the preprocess and train_cpc CLIs at
   full width in bf16 on a 16-speaker synthetic corpus, 20 steps through
   the step graph (``training/step_graph.py``) with ``runtime.profile_dir``
   set, check the losses, that the graph holds one launch of each training
   kernel a step and no other kernel, that its replays and eager warm-up
   steps add up to the steps, the one trace, load the checkpoint into
   ``Encoder`` and export through the encode CLI; hold one train step
   against the plain route on the card; 30 steps on one batch must lower
   the loss;
4e. train the vocoder on 4d's corpus and CPC checkpoint through the
   train_vocoder CLI at full width in bf16, B 32, 4 epochs x 3 steps in
   groups of 3 through the step graph with validation every 2, check the
   losses, the graph's launches as in 4d, the one trace, the validation
   wavs and their AR decode launches, the graph's pool beside the
   validation decodes' peak memory; load the checkpoint into ``Vocoder``
   and convert through the convert CLI; hold one train step against the
   plain route; 10 steps on one batch must lower the loss; resume the CLI
   at ``runtime.precision=int8`` for one more validation, which decodes
   through the int8 kernel;
4f. the grid kernels on the main paths: train_cpc at ``dim_cpc_context=512``
   through a step graph holding the grid LSTM forward and backward, the
   encode CLI at that width, a server whose PreNet is 256 wide per
   direction (the masked grid forward);
4g. the step graph against the eager step on the card, from the same
   weights on the same batches, negatives and learning rates: 10 CPC steps
   and 4 vocoder steps at B 32 x 5,120 samples, losses, weights, buffers
   and Adam's state the same bits in two eager runs and the graph; and
   the card's Adam (capturable, fused) against the plain Adam on one step;
4h. checkpoints: the JAX package's own checkpoints (the committed fixtures
   of ``tests/torch_port_jax_fixtures.py``, small widths) through the
   encode and convert CLIs, a server on their weights, train_cpc
   ``resume=`` for 2 epochs through the step graph and train_vocoder's
   auto-resume of a JAX run directory for 2 steps: the weights and Adam
   state on the card the fixture's bits after each load, each resume at the
   checkpoint's epoch or step, the kernels' launches; then both trainers at
   their default widths: the host ms the loop is blocked per save, sync and
   ``AsyncCheckpointer``, the step wall time with and without a save in
   flight, the snapshot's device memory, the async file loading to the sync
   file's tensors and a resume from it giving an uninterrupted run's bits;
4i. data parallelism at world size 1 on NCCL: 10 CPC and 4 vocoder steps
   through the step graph with the all_reduce inside the capture, the same
   bits as the trainers without a process group, each training kernel once
   a step in the graph, both step times in turns;
4j. two ranks on card 0 over gloo (``--dp-rank``: two processes of this
   script, started by torchrun), eager ``train_step``: 3 CPC steps (S 8, 4
   a rank) and 2 vocoder steps (B 32, 16 a rank) at bf16 through the
   kernels; both ranks the same bits, the result against one process on
   the global batches (losses, EMA buffers, shares of the weights), each
   rank's launches;
4k. phase 4b's requests through a 2-shard server on card 0 against a
   1-shard one, 8 slots, greedy bf16: the same classes, both served
   samples/s; then sampled twice with 2 shards: the same waves, the ragged
   PreNet's kernels once a drain and a decode launch per shard and step;
4l. the train_cpc CLI at ``runtime.mesh_data=2`` over NCCL on phase 4d's
   corpus, where two cards are (a printed line says it did not run
   otherwise);
4m. tensor parallelism: one model group of two ranks on card 0 over gloo
   (``--tp-rank``: two processes of this script, started by torchrun),
   eager bf16 ``train_step`` at full width: 3 CPC steps (S 8) and 2
   vocoder steps (B 32 x 5,120, the clip active), each rank on the whole
   batch with its shards; the replicated tensors the same bits on both
   ranks, the gathered states against one process (4j's bounds), each
   rank's launches and its bytes beside one process's;
4n. the tensor-parallel path at M 1, a model group of one rank on NCCL:
   10 CPC and 4 vocoder steps through the step graph with the model
   group's collectives inside the capture, the same bits as no group, each
   training kernel once a step in the graph, both step times in turns;
4o. the train_cpc CLI at ``runtime.mesh_model=2`` over NCCL, where two
   cards are (a printed line says it did not run otherwise);
4p. (run right after 4e) the native clip engine on 4d's features: built
   with this machine's g++; both datasets' ``sample_batch`` at their
   default batch shapes (CPC 8 x 8 x 80 x 140; vocoder 32 clips of 5,121
   mu-law samples and 32 x 80 x 32 mels) against the per-item stack, the
   same bits, host ms per batch each way over 21 batches; the batches
   4d and 4e took through ``sample_batch``; the train_cpc CLI at 4d's
   arguments with each assembly in turns, its logged steps/s;
   ``examples/full_pipeline_torch.py`` on the card and its converted wav;
5. time each kernel, its plain version and, where one exists, the PyTorch
   library call for the same function at the main paths' shapes, beside
   the least time the card could take; the AR step in both modes at B in
   {1, 8, 32, 64, 128} and the mode "auto" picks at each (the table of
   ``ops/ar_decode.py:_STEP_US``); the AR step's split by phase from the
   stamped kernel variant (launched only here) at B 1, 8 and 64 in both
   modes; the GRU grid kernels' split by phase at the vocoder's shape from
   their stamped variants (launched only here, giving the plain launches'
   bits); the cluster LSTM pair's split by phase at the export and
   training shapes from its stamped variants (launched only here, same
   bits), beside the split of the FMA kernels it replaced; the grid LSTM
   pair's split by phase at B 64, T 70, H 512 from its stamped variants
   (launched only here, same bits) and its plan; the grid LSTM
   pair at H 256 through its entry points, the one-family yardstick; the
   GRU scans beside cuDNN's GRU with their ratio; the grid
   LSTM pair at H 512 beside cuDNN's LSTM; the masked grid forward;
   each serving drain beside the request mix's slot-utilisation ceiling
   times the raw kernel rate at that many rows; the export's wall time;
   cuDNN's LSTM forward and backward beside the training pair; the grid
   LSTM pair device only beside its earlier times and bounds; the CPC
   train step in steps/s to the device with the kernels' share; the GRU
   training pair and GruScan's dwh product beside cuDNN's GRU, their
   bounds and the one-group kernels' times; both train steps on both paths,
   eager and the step graph, in turns: wall ms per step (median and spread
   of 3 runs), host us per step, the device's busy ms, idle share and
   operations per step from a trace read by ``utils/profiling``, the
   capture's time and the graph's pool, the eager vocoder step's peak
   memory; the train_cpc CLI's logged steps/s; the train_vocoder CLI's
   ``data_wait`` (4e's profiler report) beside the graph step, with 4p's
   assembly times; last, the LSTM pair, the
   kernels that must not move, the CPC step and the export beside their
   earlier figures.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA card the
script exits with code 2 and prints no result. It imports nothing of JAX.
"""

import argparse
import contextlib
import heapq
import io
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

# Published dense peaks of one H100 SXM (NVIDIA data sheet) at 700 W.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
# Prefix rule: where kernel and plain version first pick different classes,
# the plain version's score gap to the kernel's class is at most this.
MAX_GAP = 0.05
# The dual head's decode, kernel against plain version, by the same bounds:
# each of its products is one of the bf16 products above (448 deep, summed
# in f32 in another order: the kernel adds the coarse and the fine K halves
# of R h apart), and each draw an argmax of 256 scores, so a divergence is a
# near tie of the plain version's scores of the byte that differs (MAX_GAP)
# and the final h of a row that never diverged is within MAX_H_ERR.
DUAL_BATCHES = (1, 8, 64, 128)
# Final-h bound while no sample diverged: the two sum the 896-deep products
# in different orders (~1e-6 relative in f32); when that moves an h element
# across a bf16 rounding boundary the next step's product moves by one bf16
# ulp (2^-8 relative) of that element's term, which the gates damp.
MAX_H_ERR = 1e-2
# GRU scans, kernel against plain version: both sum the H-deep products in
# f32 in different orders (~1e-6 relative). Where that puts an h value on
# the other side of a bf16 rounding boundary, hs differs by one bf16 ulp,
# at most 2^-8 = 3.9e-3 for |h| < 1, and the next step's product by one ulp
# of that term, which the gates damp; h_T is f32 and sees only the damped
# effect. Bound for both: 1e-2.
MAX_GRU_ERR = 1e-2
# The serving PreNet shape: 48 requests of up to 100 codes (200 frames),
# H = 128 per direction (bench.py:523-541's mix).
GRU_G, GRU_T, GRU_H = 48, 200, 128
MIX_CODES = (25, 50, 100)
DEVICE = "cuda"
TIME_FRAMES = 100  # phase_time's decode: 100 frames (1 s of audio)
SERVE_SLOTS = (8, 32, 64)  # the JAX bench serves this mix at 32 and 64 (bench.py:530,716)
# The AR decode's comparisons by mode, and the batches its step is timed at
# (both modes; the table that "auto" interpolates, ops/ar_decode.py:_STEP_US).
COMPARE_BATCHES = {"bf16": (1, 3, 8, 32, 64, 128), "int8": (1, 3, 8, 32, 64, 128)}
TIME_BATCHES = (1, 8, 32, 64, 128)
# LSTM scans, kernel against plain version: the reasoning of MAX_GRU_ERR.
MAX_LSTM_ERR = 1e-2
LSTM_H = 256  # the context LSTM's width (dim_cpc_context)
# (B, T): the export's batch of 16 at T' = 256 (a 512-frame bucket), and
# the CPC training step's 64 clips of 70 latent frames.
LSTM_SHAPES = {"export": (16, 256), "training": (64, 70)}
# The grid LSTM kernels (ops/csrc/lstm_grid.cu): a 512-wide context
# (dim_cpc_context=512, phase 4f) and a width that is not a multiple of 8,
# at LSTM_SHAPES and LSTM_GRID_SMALL_B (one partial row group, one row);
# and wide widths at a short shape of their own: H 1,600, one row group
# whose blocks hold wh whole, and H 2,048, whose blocks stage wh in K
# chunks (both directions).
LSTM_GRID_H = (512, 37)
LSTM_GRID_SMALL_B = {"partial group": (3, 70), "one row": (1, 70)}
LSTM_WIDE_H = {1600: "one group", 2048: "K chunks"}
LSTM_STREAM_SHAPE = (16, 24)
GRU_WIDE_H = 256  # a PreNet of 256 per direction (dim_voc_latent=512): the masked grid
GRU_STREAM_H = 2500  # a masked grid forward whose blocks stage wh in K chunks
EXPORT_MELS = 40  # phase 4c: mels of 50 to 1,000 frames
MIN_CODE_AGREEMENT = 0.99  # bf16 export against f32 export, share of frames
# Where the two exports pick different codes, the bf16 code's squared
# distance to the f32 z_pre exceeds the f32 code's by at most this share (a
# near-tie); z_pre moves by the bf16 roundings of the frontend's five
# products. Both are tests/test_torch_encode.py's bounds against the JAX
# package's bf16 encode.
MAX_CODE_GAP = 1e-2
MAX_PRE_VQ_ERR = 5e-2
CUDNN_DTYPE = torch.float16  # the library yardstick's type: cuDNN's RNN takes fp16
# CPC training at the default config: S 8 x U 8 clips of 140 mel frames give
# T' = 70 latent frames; K = 6 steps, N = 17 negatives, L = 64 anchors, Z 64.
# "data parallel": a rank's share at runtime.mesh_data=2 (S 4, phase 4j).
TRAIN_LSTM_SHAPES = {"training": (64, 70), "data parallel": (32, 70),
                     "partial cluster": (3, 70), "one step": (64, 1)}
SELECT_SHAPES = {"training": (6, 8, 8, 17, 64, 64), "data parallel": (6, 4, 8, 17, 64, 64),
                 "odd L": (6, 8, 8, 17, 61, 64), "Z 300": (6, 8, 8, 17, 64, 300)}
# LSTM backward, kernel against plain version: bf16(da) one ulp apart where
# the f32 da sits on a rounding boundary (2^-8 relative), carried on by the
# gates: 1e-2 of the largest value plus 1e-3. Autograd's dwh and dxproj
# against the plain route: 2e-2 of the largest (dwh sums T B such terms).
MAX_LSTM_BWD_REL = 1e-2
MAX_LSTM_GRAD_REL = 2e-2
# The GRU grid kernels against their plain versions: the forward as
# MAX_GRU_ERR, relative to max(1, largest) since |hn| reaches ~3 (one bf16
# ulp there is 1.6e-2); the backward and autograd through it as the LSTM
# pair's MAX_LSTM_BWD_REL and MAX_LSTM_GRAD_REL: a gate gradient one bf16
# ulp apart where its f32 value sits on a rounding boundary, carried on by
# the recurrence, and summed T B deep into dwh and dbh.
# Selection, kernel against plain version: f32 dots of Z terms (forward),
# sums of at most 1 + N U terms (backward), in other orders: 1e-5 of the
# largest value.
MAX_SELECT_REL = 1e-5
TRAIN_SPEAKERS, TRAIN_UTTS, TRAIN_EPOCHS = 16, 8, 10  # 2 steps per epoch at S = 8
TRAIN_KERNELS = ("lstm_scan_train", "lstm_scan_bwd", "cpc_select", "cpc_select_bwd")
VOC_KERNELS = ("gru_scan_train", "gru_scan_bwd")
# One bf16 train step, kernels against the plain route on the card: they
# differ only where the kernels sum in another order (an h or da one bf16
# ulp apart): loss within 1e-3 relative, every gradient within 5e-2 of its
# largest element.
MAX_STEP_LOSS_REL = 1e-3
MAX_STEP_GRAD_REL = 5e-2
PEAK_F32_FLOPS = 67e12  # H100 SXM, outside the tensor cores
# The vocoder's AR GRU in training: B 32 clips of 32 mel frames x hop 160.
VOC_T, VOC_B, VOC_H = 5120, 32, 896
GRU_TRAIN_SHAPES = {"training": (VOC_T, VOC_B, VOC_H),
                    "data parallel": (VOC_T, VOC_B // 2, VOC_H),  # B 16 a rank, phase 4j
                    "partial tile": (9, 3, VOC_H),
                    "one step": (1, VOC_B, VOC_H), "H 200": (640, VOC_B, 200),
                    "K chunks": (48, 8, 2500)}
VOC_EPOCHS, VOC_VAL_EVERY = 4, 2  # 125 training utterances at B 32: 3 steps an epoch
VOC_DISPATCH = 3  # phase 4e's steps_per_dispatch: one group an epoch
# Phase 4g, the step graph against the eager step: the same bits; the
# card's Adam within 1e-6 of the largest element of each of the plain
# Adam's weights after one step.
GRAPH_CPC_STEPS, GRAPH_VOC_STEPS = 10, 4
MAX_ADAM_REL = 1e-6
# The GRU training pair before row groups (every block reading all rows)
# and GruScan's dwh as an f32 product, at VOC_T, VOC_B, VOC_H (PERF.md
# section 6; H100 80GB HBM3 at 700 W).
ONE_GROUP_MS = {"gru_scan_train": 34.701, "gru_scan_bwd": 48.821, "dwh": 16.931}
# The cluster LSTM pair before its redesign on the tensor cores (FMA loops,
# scalar remote stores, one cluster.sync a step) at LSTM_SHAPES: its stamped
# split, us per step on rank 0 of the first cluster, and the figures
# PERF.md section 6 held for it and for the kernels that must not move
# (H100 80GB HBM3 at 700 W; ms per call; the CPC step and export from
# PERF.md section 5).
FMA_LSTM_STAMPS = {
    "forward export": {"xproj": 0.312, "product": 5.199, "part sum": 0.129, "gate pass": 0.295,
                       "remote writes": 0.721, "barrier": 2.178, "total": 8.835},
    "training forward training": {"xproj": 0.327, "product": 5.214, "part sum": 0.166,
                                  "gate pass": 0.357, "remote writes": 1.155, "barrier": 1.350,
                                  "total": 8.569},
    "backward training": {"residuals": 0.351, "gate grads": 0.294, "remote writes": 5.073,
                          "barrier": 1.597, "product": 4.978, "part sum": 0.147, "total": 12.439},
}
EARLIER_MS = {"lstm_scan": 1.7029, "lstm_scan_train": 0.5012, "lstm_scan_bwd": 0.8480,
              "cpc_step": 13.614, "cpc_device_busy": 2.797}
# The grid LSTM pair before row groups (one grid barrier a step, every block
# staging all B rows; PERF.md section 6, H100 80GB HBM3 at 700 W, ms per
# call by CUDA events): at H 512 the training forward and the backward at B
# 64, T 70 and the inference forward at B 16, T 256; the training forward
# and backward at H 1,600, B 64, T 70 (K chunks then); at H 256 the
# inference, training forward and backward. And the kernels this slice must
# not move, as PERF.md section 6 holds them (ms; the selection pair device
# only).
EARLIER_GRID_MS = {"lstm_scan_grid": 0.6865, "lstm_scan_grid_bwd": 0.9991,
                   "lstm_scan_grid_inference": 1.1142, "h1600": (10.0392, 8.6950),
                   "h256": (1.0792, 0.5894, 0.7806)}
UNMOVED_MS = {"lstm_scan": 0.4188, "lstm_scan_train": 0.1367, "lstm_scan_bwd": 0.0917,
              "gru_scan_train": 20.156, "gru_scan_bwd": 21.835, "gru_scan_masked_grid": 0.5025,
              "cpc_select": 0.0183, "cpc_select_bwd": 0.0326}
EARLIER_EXPORT_FRAMES_S = 2998.8
# The selection pair before its redesign at SELECT_SHAPES["training"] (H100
# 80GB HBM3 at 700 W, PERF.md section 5): ms by the host loop (PERF.md
# section 6's earlier rows) and device only; and the limits asked of the
# redesign (required, goal: half the bound), ms device only.
EARLIER_SELECT_MS = {"cpc_select": (0.0589, 0.0615, 0.020, 0.0096),
                     "cpc_select_bwd": (0.1928, 0.1873, 0.040, 0.0171)}


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def randomize(module: torch.nn.Module, rng: np.random.Generator, fc2_gain: float = 8.0) -> None:
    """Weights from a numpy seed at torch's default init scales.

    Embeddings ~ N(0, 1); weights and biases ~ U(+-1/sqrt(fan_in));
    LayerNorms stay (1, 0). FC2 is ``fc2_gain`` times larger, so that the
    class scores have a clear maximum at most steps, as a trained
    vocoder's do. The codebook gets N(0, 0.5) codes.
    """
    state = module.state_dict()
    for name, t in state.items():
        prefix, _, leaf = name.rpartition(".")
        if name.startswith("codebook."):
            continue
        if "embedding" in prefix:
            v = rng.normal(0, 1, size=t.shape)
        elif leaf.startswith(("weight_", "bias_")):  # GRU / LSTM: 1/sqrt(hidden)
            v = rng.uniform(-1, 1, size=t.shape) / np.sqrt(state[f"{prefix}.weight_hh_l0"].shape[1])
        elif t.ndim >= 2:  # Linear / Conv1d weight
            v = rng.uniform(-1, 1, size=t.shape) / np.sqrt(np.prod(t.shape[1:]))
        elif leaf == "bias" and state[f"{prefix}.weight"].ndim == 2:  # Linear bias
            v = rng.uniform(-1, 1, size=t.shape) / np.sqrt(state[f"{prefix}.weight"].shape[1])
        else:  # LayerNorm
            continue
        if prefix.endswith("fc2"):
            v = v * fc2_gain
        t.copy_(torch.from_numpy(v))
    if "codebook.embedding" in state:
        emb = torch.from_numpy(rng.normal(0, 0.5, size=state["codebook.embedding"].shape))
        state["codebook.embedding"].copy_(emb)
        state["codebook.ema_weight"].copy_(emb)
        state["codebook.ema_count"].fill_(1.0)


def first_divergence(a: np.ndarray, b: np.ndarray):
    """Per row of (T, B) class arrays: the first step where they differ, or None."""
    out = []
    for r in range(a.shape[1]):
        d = np.nonzero(a[:, r] != b[:, r])[0]
        out.append(int(d[0]) if d.size else None)
    return out


def phase_compare(seed: int, card: str, precision: str = "bf16") -> dict:
    """Kernel against plain version at full width in one mode; returns the
    worst numbers."""
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.models.vocoder import Vocoder
    from vectorquantizedcpc_tpu_torch.ops import ar_decode as ar

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    conf = load_conf([])
    net = conf.training_vocoder.model.network
    vocoder = Vocoder(net)
    rng = np.random.default_rng(seed)
    randomize(vocoder, rng)
    vocoder = vocoder.cuda().eval()
    w = ar.prep_decode_weights(vocoder, precision)
    hop, hidden = net.rnnms.upsampling_t, net.rnnms.wave_ar.size_h_rnn
    n_classes = 2 ** net.rnnms.bits_mu_law
    frames = 8
    worst_h, worst_gap, n_div = 0.0, 0.0, 0
    for batch in COMPARE_BATCHES[precision]:
        cond = torch.from_numpy(
            rng.uniform(-1, 1, size=(batch, frames, net.rnnms.dim_voc_latent)).astype(np.float32)
        ).cuda()
        cond_proj = ar.project_cond_frames(w, cond).transpose(0, 1).contiguous()
        h0, prev0 = ar.init_decode_state(batch, hidden, n_classes, cond.device)
        for greedy in (True, False):
            out_k, h_k = ar.ar_decode(cond_proj, h0, prev0, w, hop, seed=seed + batch, greedy=greedy)
            torch.cuda.synchronize()
            out_r, h_r, scores = ar.ar_decode_reference(
                cond_proj, h0, prev0, w, hop, seed=seed + batch, greedy=greedy, return_scores=True
            )
            out_k, out_r = out_k.cpu().numpy(), out_r.cpu().numpy()
            scores = scores.cpu().numpy()
            check(out_k.min() >= 0 and out_k.max() < n_classes, "kernel class out of range")
            div = first_divergence(out_k, out_r)
            for r, t0 in enumerate(div):
                if t0 is None:
                    err = float((h_k[r] - h_r[r]).abs().max())
                    check(err <= MAX_H_ERR, f"B={batch} row {r}: final h differs by {err}")
                    worst_h = max(worst_h, err)
                else:
                    n_div += 1
                    gap = float(scores[t0, r].max() - scores[t0, r, out_k[t0, r]])
                    check(gap <= MAX_GAP, f"B={batch} row {r} step {t0}: gap {gap} > {MAX_GAP}")
                    worst_gap = max(worst_gap, gap)
            print(
                f"compare {precision} B={batch} {'greedy ' if greedy else 'sampled'} steps={frames * hop}: "
                f"first divergence per row {div}, same samples "
                f"{float(np.mean(out_k == out_r)):.6f}  [{card}]"
            )
    print(
        f"compare {precision}: final-h max abs diff {worst_h:.3e} (bound {MAX_H_ERR}) over rows "
        f"that never diverged; {n_div} rows diverged, worst gap {worst_gap:.3e} "
        f"(bound {MAX_GAP})  [{card}]"
    )
    chain_h = _compare_chain(w, net, rng, seed, card)
    return {"max_abs_err": max(worst_h, chain_h)}


def phase_compare_dual(seed: int, card: str) -> dict:
    """The dual head's kernel against its plain version at the default
    widths (H 896, halves of 448, 256 classes a head), 8 frames (1,280
    steps) at B in DUAL_BATCHES, greedy and sampled; the stamped variant
    must give the plain launch's bits; 4 chained greedy segments must give
    one launch's. Returns the worst numbers."""
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.models.vocoder import Vocoder
    from vectorquantizedcpc_tpu_torch.ops import ar_decode as ar
    from vectorquantizedcpc_tpu_torch.ops import dual_decode as dd

    torch.backends.cuda.matmul.allow_tf32 = False
    net = load_conf(["training_vocoder.model.network.rnnms.output=dual16"]
                    ).training_vocoder.model.network
    torch.manual_seed(seed)
    vocoder = Vocoder(net)
    with torch.no_grad():  # scores with a clear maximum, as a trained head's
        vocoder.rnnms.o2.weight.mul_(8.0)
        vocoder.rnnms.o4.weight.mul_(8.0)
    vocoder = vocoder.cuda().eval()
    w = dd.prep_dual_weights(vocoder)
    hop, hidden = net.rnnms.upsampling_t, net.rnnms.wave_ar.size_h_rnn
    rng = np.random.default_rng(seed)
    frames = 8
    worst_h, worst_gap, n_div = 0.0, 0.0, 0
    for batch in DUAL_BATCHES:
        cond = torch.from_numpy(
            rng.uniform(-1, 1, size=(batch, frames, net.rnnms.dim_voc_latent)).astype(np.float32)
        ).cuda()
        cond_proj = ar.project_cond_frames(w, cond).transpose(0, 1).contiguous()
        state = dd.init_dual_state(batch, hidden, cond.device)
        for greedy in (True, False):
            out_k, st_k = dd.dual_decode(cond_proj, state, w, hop, seed=seed + batch,
                                         greedy=greedy)
            torch.cuda.synchronize()
            out_r, st_r, scores = dd.dual_decode_reference(
                cond_proj, state, w, hop, seed=seed + batch, greedy=greedy, return_scores=True)
            out_k, out_r = out_k.cpu().numpy(), out_r.cpu().numpy()
            scores = scores.cpu().numpy()
            check(out_k.min() >= 0 and out_k.max() < 65536, "dual kernel sample out of range")
            div = first_divergence(out_k, out_r)
            for r, t0 in enumerate(div):
                if t0 is None:
                    err = float((st_k.h[r] - st_r.h[r]).abs().max())
                    check(err <= MAX_H_ERR, f"dual B={batch} row {r}: final h differs by {err}")
                    worst_h = max(worst_h, err)
                    continue
                n_div += 1
                c, f = divmod(int(out_k[t0, r]), 256)
                sc = scores[t0, r]
                gap = (sc[:256].max() - sc[c] if c != out_r[t0, r] // 256
                       else sc[256:].max() - sc[256 + f])
                check(gap <= MAX_GAP, f"dual B={batch} row {r} step {t0}: gap {gap} > {MAX_GAP}")
                worst_gap = max(worst_gap, float(gap))
            if not greedy:
                out_s, _, _ = dd.dual_decode_stamped(cond_proj, state, w, hop, seed=seed + batch)
                check(np.array_equal(out_s.cpu().numpy(), out_k),
                      f"dual B={batch}: the stamped variant gave other samples")
            print(f"compare dual16 B={batch} {'greedy ' if greedy else 'sampled'} "
                  f"steps={frames * hop}: first divergence per row {div}, same samples "
                  f"{float(np.mean(out_k == out_r)):.6f}  [{card}]")
        one, _ = dd.dual_decode(cond_proj, state, w, hop, greedy=True)
        chained, st = [], state
        for k in range(0, frames, 2):
            seg, st = dd.fused_dual_decode_segment(w, cond_proj[k:k + 2].transpose(0, 1), st,
                                                   seed, hop, greedy=True)
            chained.append(seg)
        check(torch.equal(torch.cat(chained, 1), one.t()),
              f"dual B={batch}: 4 chained segments differ from one launch")
    print(f"compare dual16: final-h max abs diff {worst_h:.3e} (bound {MAX_H_ERR}) over rows "
          f"that never diverged; {n_div} rows diverged, worst gap {worst_gap:.3e} "
          f"(bound {MAX_GAP}); stamped bits and 4 chained segments equal  [{card}]")
    return {"max_abs_err": worst_h, "worst_gap": worst_gap}


def _compare_chain(w, net, rng, seed: int, card: str) -> float:
    """The segment entry: 4 chained launches against one, B = 8, 8 frames.

    Greedy, the chain must equal one launch bit for bit (the state hand-off
    is exact). Sampled, each segment has its own seed, so the chained
    kernel is held against the chained plain version under the prefix rule.
    """
    from vectorquantizedcpc_tpu_torch.ops import ar_decode as ar

    hop, hidden = net.rnnms.upsampling_t, net.rnnms.wave_ar.size_h_rnn
    n_classes = 2 ** net.rnnms.bits_mu_law
    batch, frames, n_seg = 8, 8, 4
    sf = frames // n_seg
    cond = torch.from_numpy(
        rng.uniform(-1, 1, size=(batch, frames, net.rnnms.dim_voc_latent)).astype(np.float32)
    ).to(DEVICE)
    cond_proj = ar.project_cond_frames(w, cond)  # (B, Tf, 3H)
    h0, prev0 = ar.init_decode_state(batch, hidden, n_classes, cond.device)

    def chained(kernel: bool, greedy: bool):
        state, outs, scores = ar.DecodeState(h0, prev0), [], []
        for k in range(n_seg):
            seg = cond_proj[:, k * sf : (k + 1) * sf]
            seed_k = ar.segment_seed(seed, k)
            if kernel:
                classes, state = ar.fused_ar_decode_segment(w, seg, state, seed_k, hop, greedy)
            else:
                out, h, sc = ar.ar_decode_reference(
                    seg.transpose(0, 1).contiguous(), state.h, state.prev, w, hop,
                    seed_k, greedy, return_scores=True,
                )
                classes, state = out.t(), ar.DecodeState(h, out[-1].clone())
                scores.append(sc)
            outs.append(classes)
        return torch.cat(outs, dim=1).t().cpu().numpy(), state.h, scores

    one, h_one = ar.ar_decode(cond_proj.transpose(0, 1).contiguous(), h0, prev0, w, hop,
                              seed=seed, greedy=True)
    out_k, h_k, _ = chained(kernel=True, greedy=True)
    torch.cuda.synchronize()
    check(np.array_equal(out_k, one.cpu().numpy()), "greedy: 4 chained segments != one launch")
    check(torch.equal(h_k, h_one), "greedy: chained final h != one launch's")
    print(f"compare chain {w.mode} greedy B={batch} {n_seg} segments x {sf * hop} steps: "
          f"bit-identical to one launch (classes and final h)  [{card}]")

    out_k, h_k, _ = chained(kernel=True, greedy=False)
    out_r, h_r, scores = chained(kernel=False, greedy=False)
    scores = torch.cat(scores).cpu().numpy()
    check(out_k.min() >= 0 and out_k.max() < n_classes, "chained kernel class out of range")
    worst_h, worst_gap, same = 0.0, 0.0, 0
    for r, t0 in enumerate(first_divergence(out_k, out_r)):
        if t0 is None:
            same += 1
            worst_h = max(worst_h, float((h_k[r] - h_r[r]).abs().max()))
        else:
            gap = float(scores[t0, r].max() - scores[t0, r, out_k[t0, r]])
            check(gap <= MAX_GAP, f"chain row {r} step {t0}: gap {gap} > {MAX_GAP}")
            worst_gap = max(worst_gap, gap)
    check(worst_h <= MAX_H_ERR, f"chain: final h differs by {worst_h}")
    print(f"compare chain {w.mode} sampled B={batch} {n_seg} segments, per-segment seeds: "
          f"{same} of {batch} rows bit-identical to the chained plain version, final-h "
          f"max abs diff {worst_h:.3e} (bound {MAX_H_ERR}); worst gap where a row "
          f"diverged {worst_gap:.3e} (bound {MAX_GAP})  [{card}]")
    return worst_h


def _gru_inputs(seed: int, h: int = GRU_H):
    """GRU-scan operands at the serving PreNet's shape (H ``h`` per
    direction), from ``seed``: wh, bh at nn.GRU's init scale, xproj of a bf16
    input projection, h0, and a reverse-time ragged mask (rows of length 1
    and T among them)."""
    rng = np.random.default_rng(seed + 3)
    g, t = GRU_G, GRU_T
    lengths = rng.integers(1, t + 1, size=g)
    lengths[:2] = [1, t]
    valid = np.arange(t)[:, None] >= t - lengths[None, :]
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(DEVICE)
    return {
        "wh": f32(rng.uniform(-1, 1, size=(h, 3 * h)) / np.sqrt(h)).bfloat16(),
        "bh": f32(rng.uniform(-1, 1, size=(3 * h,)) / np.sqrt(h)),
        "xproj": f32(rng.normal(0, 0.8, size=(t, g, 3 * h))).bfloat16(),
        "h0": f32(rng.uniform(-0.5, 0.5, size=(g, h))),
        "valid": torch.from_numpy(valid.astype(np.int32)).to(DEVICE),
        "lengths": lengths,
    }


def phase_compare_gru(seed: int, card: str) -> dict:
    """Both GRU scans against their plain versions at G = 48, T = 200, H = 128."""
    from vectorquantizedcpc_tpu_torch.ops import gru_train as g

    x = _gru_inputs(seed)
    args = (x["wh"], x["bh"], x["xproj"])
    runs = {
        "gru_scan": (g.gru_scan(*args, x["h0"]), g.gru_scan_reference(*args, x["h0"])),
        "gru_scan_masked": (
            g.gru_scan_masked(*args, x["valid"], x["h0"]),
            g.gru_scan_masked_reference(*args, x["valid"], x["h0"]),
        ),
    }
    torch.cuda.synchronize()
    out = {}
    for name, ((hs, h_t), (ref, ref_h)) in runs.items():
        err_hs = float((hs.float() - ref.float()).abs().max())
        err_h = float((h_t - ref_h).abs().max())
        check(err_hs <= MAX_GRU_ERR, f"{name}: hs differs by {err_hs}")
        check(err_h <= MAX_GRU_ERR, f"{name}: h_T differs by {err_h}")
        print(f"compare {name} G={GRU_G} T={GRU_T} H={GRU_H}: hs max abs diff {err_hs:.3e}, "
              f"h_T {err_h:.3e} (bound {MAX_GRU_ERR} each: one bf16 ulp of |h| < 1 is "
              f"3.9e-3, f32 sums in another order, damped by the gates)  [{card}]")
        out[name] = max(err_hs, err_h)
    short = int(np.argmin(x["lengths"]))
    (hs, h_t), _ = runs["gru_scan_masked"]
    check(torch.equal(hs[: GRU_T - 1, short], x["h0"][short].bfloat16().expand(GRU_T - 1, -1)),
          "masked: a row of length 1 moved before its only valid step")
    return out


def phase_compare_gru_masked_grid(seed: int, card: str) -> float:
    """The masked grid forward (a PreNet of 256 per direction, and one of
    2,500 whose blocks stage wh in K chunks) against its plain version at G
    48, T 200, ragged; an all-valid mask gives the unmasked grid forward's
    bits."""
    from vectorquantizedcpc_tpu_torch.ops import gru_train as g

    worst = 0.0
    for hidden in (GRU_WIDE_H, GRU_STREAM_H):
        x = _gru_inputs(seed, hidden)
        args = (x["wh"], x["bh"], x["xproj"])
        check(g.scan_route(hidden) == "grid", f"H {hidden} should take the grid kernels")
        hs, h_t = g.gru_scan_masked(*args, x["valid"], x["h0"])
        hs_all, h_all = g.gru_scan_masked(*args, torch.ones_like(x["valid"]), x["h0"])
        plain = g.gru_scan(*args, x["h0"])
        torch.cuda.synchronize()
        check(torch.equal(hs_all, plain[0]) and torch.equal(h_all, plain[1]),
              f"masked grid H={hidden} with an all-valid mask != the grid forward's bits")
        ref, ref_h = g.gru_scan_masked_reference(*args, x["valid"], x["h0"])
        err_hs = float((hs.float() - ref.float()).abs().max())
        err_h = float((h_t - ref_h).abs().max())
        check(max(err_hs, err_h) <= MAX_GRU_ERR, f"masked grid H={hidden}: hs {err_hs}, h_T {err_h}")
        short = int(np.argmin(x["lengths"]))
        check(torch.equal(hs[: GRU_T - 1, short], x["h0"][short].bfloat16().expand(GRU_T - 1, -1)),
              f"masked grid H={hidden}: a row of length 1 moved before its only valid step")
        plan = g.grid_plan(GRU_G, hidden)
        print(f"compare gru_scan_masked_grid G={GRU_G} T={GRU_T} H={hidden} ({plan.groups} row "
              f"groups of {plan.rows}, K chunk {plan.chunk}): "
              f"hs max abs diff {err_hs:.3e}, h_T {err_h:.3e} (bound {MAX_GRU_ERR}); all-valid "
              f"mask bit-identical to the grid forward; masked rows keep their carry  [{card}]")
        worst = max(worst, err_hs, err_h)
    return worst


def _sms() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def _lstm_inputs(seed: int, batch: int, steps: int, h: int = LSTM_H):
    """LSTM-scan operands from ``seed``: wh at nn.LSTM's init scale and an
    input projection, both bf16; h0 and c0 in f32."""
    rng = np.random.default_rng(seed + 6)
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(DEVICE)
    return (
        f32(rng.uniform(-1, 1, size=(h, 4 * h)) / np.sqrt(h)).bfloat16(),
        f32(rng.normal(0, 1, size=(steps, batch, 4 * h))).bfloat16(),
        f32(rng.uniform(-0.5, 0.5, size=(batch, h))),
        f32(rng.uniform(-1, 1, size=(batch, h))),
    )


def phase_compare_lstm(seed: int, card: str) -> float:
    """The LSTM scan against its plain version at the export and training shapes."""
    from vectorquantizedcpc_tpu_torch.ops import lstm_scan as ls

    worst = 0.0
    for name, (batch, steps) in LSTM_SHAPES.items():
        args = _lstm_inputs(seed, batch, steps)
        got = ls.lstm_scan(*args)
        torch.cuda.synchronize()
        ref = ls.lstm_scan_reference(*args)
        errs = [float((a.float() - b.float()).abs().max()) for a, b in zip(got, ref)]
        check(max(errs) <= MAX_LSTM_ERR, f"lstm_scan {name}: hs, h_T, c_T differ by {errs}")
        print(f"compare lstm_scan {name} B={batch} T={steps} H={LSTM_H}: hs max abs diff "
              f"{errs[0]:.3e}, h_T {errs[1]:.3e}, c_T {errs[2]:.3e} (bound {MAX_LSTM_ERR} "
              f"each, as for the GRU scans)  [{card}]")
        worst = max(worst, *errs)
    return worst


def _write_inputs(d: Path, seed: int):
    """Full-width random checkpoints, 8 wavs of 1-2 s, list and speakers."""
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.dsp.audio_io import write_wav
    from vectorquantizedcpc_tpu_torch.models.encoder import Encoder
    from vectorquantizedcpc_tpu_torch.models.vocoder import Vocoder

    conf = load_conf([])
    rng = np.random.default_rng(seed + 1)
    encoder, vocoder = Encoder(conf.model.encoder), Vocoder(conf.training_vocoder.model.network)
    randomize(encoder, rng)
    randomize(vocoder, rng)
    torch.save({"encoder": encoder.state_dict(), "epoch": 0}, d / "cpc.pt")
    torch.save({"vocoder": vocoder.state_dict()}, d / "vocoder.pt")
    speakers = [f"S{i:03d}" for i in range(conf.training_vocoder.model.n_speakers)]
    (d / "wavs").mkdir()
    (d / "wavs" / "speakers.json").write_text(json.dumps(speakers))
    lengths = [16000 + 2000 * i + int(rng.integers(0, 1000)) for i in range(8)]
    entries = []
    for i, n in enumerate(lengths):
        t = np.arange(n) / 16000
        f0 = 110 + 25 * i
        env = 0.6 + 0.4 * np.sin(2 * np.pi * 3 * t)
        wave = env * sum(0.15 / k * np.sin(2 * np.pi * k * f0 * t) for k in range(1, 6))
        wave += 0.005 * rng.normal(size=n)
        write_wav(d / "wavs" / f"utt{i}.wav", wave.astype(np.float32), 16000)
        entries.append([f"utt{i}", speakers[(7 * i) % len(speakers)], f"conv{i}"])
    (d / "list.json").write_text(json.dumps(entries))
    return conf, lengths


def phase_convert(seed: int, card: str, precision: str = "bfloat16") -> dict:
    """The CLI end to end on the card at ``runtime.precision``; returns the
    kernel launch counts. Each batch decodes in the mode that the precision
    resolves to at its size ("auto": the faster mode of ``_STEP_US``)."""
    from vectorquantizedcpc_tpu_torch.cli import convert as cli
    from vectorquantizedcpc_tpu_torch.dsp.audio_io import read_wav
    from vectorquantizedcpc_tpu_torch.dsp.loudness import integrated_loudness
    from vectorquantizedcpc_tpu_torch.ops import ar_decode as ar

    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        conf, lengths = _write_inputs(d, seed)
        hop = conf.data.dataset.mel_stft_stride
        n_mels = [1 + n // hop for n in lengths]
        buckets = {}
        for m in n_mels:
            padded = max(32, -(-m // 32) * 32)
            buckets[padded] = buckets.get(padded, 0) + 1
        n_batches = sum(-(-n // 8) for n in buckets.values())
        sizes = [min(8, n - b0) for n in buckets.values() for b0 in range(0, n, 8)]
        modes = [ar.resolve_precision(precision, s) for s in sizes]
        argv = [
            f"cpc_checkpoint={d / 'cpc.pt'}", f"vocoder_checkpoint={d / 'vocoder.pt'}",
            f"in_dir={d / 'wavs'}", f"out_dir={d / 'out'}", f"synthesis_list={d / 'list.json'}",
            f"runtime.precision={precision}",
        ]
        torch.cuda.synchronize()
        ar.AR_DECODE_LAUNCHES = ar.AR_DECODE_INT8_LAUNCHES = 0
        start = time.perf_counter()
        n = cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        by_mode = {"bf16": ar.AR_DECODE_LAUNCHES, "int8": ar.AR_DECODE_INT8_LAUNCHES}
        launches = sum(by_mode.values())
        check(n == 8, f"converted {n} utterances, expected 8")
        check(launches >= n_batches > 0, f"{launches} AR decode launches for {n_batches} batches")
        check(by_mode == {m: modes.count(m) for m in ("bf16", "int8")},
              f"launches by mode {by_mode} for batches of {sizes} resolved to {modes}")
        for i, m in enumerate(n_mels):
            out, sr = read_wav(d / "out" / f"conv{i}.wav")
            src, _ = read_wav(d / "wavs" / f"utt{i}.wav")
            check(out.shape == ((m // 2) * 2 * hop,), f"conv{i}: {out.shape} samples")
            check(bool(np.isfinite(out).all()) and float(np.abs(out).max()) <= 1.0, f"conv{i} range")
            l_out, l_src = integrated_loudness(out, sr), integrated_loudness(src, sr)
            if np.isfinite(l_out):
                check(abs(l_out - l_src) < 0.5, f"conv{i}: loudness {l_out} vs source {l_src}")
            print(f"convert conv{i}: {out.shape[0]} samples, {l_out:.3f} LUFS vs source {l_src:.3f}")
    audio = sum((m // 2) * 2 * hop for m in n_mels) / 16000
    print(
        f"convert runtime.precision={precision}: 8 utterances ({audio:.3f} s of audio) in "
        f"{n_batches} batches of {sizes} resolved to {modes}, AR decode launches by mode "
        f"{json.dumps(by_mode)}, {seconds:.3f} s wall incl. checkpoint load  [{card}]"
    )
    return {"ar_decode": by_mode["bf16"], "ar_decode_int8": by_mode["int8"]}


def _classes_of(wave: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Mu-law wave -> classes (the expansion is injective)."""
    return np.abs(wave[:, None] - table[None, :]).argmin(-1)


def phase_serve(seed: int, card: str) -> dict:
    """ContinuousBatcher at full width: 48 requests, sampled, then greedy."""
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.dsp.mulaw import mulaw_decode
    from vectorquantizedcpc_tpu_torch.infer.serving import ContinuousBatcher
    from vectorquantizedcpc_tpu_torch.models.vocoder import Vocoder, build_conditioning_frames
    from vectorquantizedcpc_tpu_torch.ops import ar_decode as ar
    from vectorquantizedcpc_tpu_torch.ops import gru_train as g

    net = load_conf([]).training_vocoder.model.network
    vocoder = Vocoder(net)
    randomize(vocoder, np.random.default_rng(seed + 4))
    vocoder = vocoder.to(DEVICE).eval()
    hop = net.rnnms.upsampling_t
    n_classes = 2 ** net.rnnms.bits_mu_law
    rng = np.random.default_rng(seed + 5)
    requests = [
        (rng.integers(0, net.size_i_codebook, size=int(rng.choice(MIX_CODES))),
         int(rng.integers(0, net.n_speakers)))
        for _ in range(48)
    ]

    def server(greedy: bool = False, slots: int = 8, precision: str = "bf16"):
        return ContinuousBatcher(vocoder, slots=slots, segment_frames=4,
                                 max_frames=2 * max(MIX_CODES) + 32, greedy=greedy,
                                 precision=precision, seed=seed, device=DEVICE)

    def drain(srv, reqs):
        rids = [srv.submit(z, spk) for z, spk in reqs]
        waves = srv.run()
        return [waves[r] for r in rids]

    valid = sum(2 * len(z) * hop for z, _ in requests)

    def served(slots: int, precision: str = "bf16"):
        """The main path at ``slots`` in one mode, counts zeroed just before
        and read just after; every wave and count checked."""
        srv = server(slots=slots, precision=precision)
        torch.cuda.synchronize()
        ar.AR_DECODE_LAUNCHES = ar.AR_DECODE_INT8_LAUNCHES = ar.AR_DECODE_STAMPED_LAUNCHES = 0
        g.GRU_SCAN_LAUNCHES = g.GRU_SCAN_MASKED_LAUNCHES = 0
        start = time.perf_counter()
        waves = drain(srv, requests)
        seconds = time.perf_counter() - start
        launches = {
            "ar_decode": ar.AR_DECODE_LAUNCHES,
            "ar_decode_int8": ar.AR_DECODE_INT8_LAUNCHES,
            "ar_decode_stamped": ar.AR_DECODE_STAMPED_LAUNCHES,
            "gru_scan": g.GRU_SCAN_LAUNCHES,
            "gru_scan_masked": g.GRU_SCAN_MASKED_LAUNCHES,
        }
        key, other = ("ar_decode_int8", "ar_decode") if precision == "int8" else (
            "ar_decode", "ar_decode_int8")
        steps = int(srv.stats["steps"])
        check(len(waves) == 48, f"{slots} slots: {len(waves)} of 48 requests returned")
        for (z, _spk), wave in zip(requests, waves):
            check(wave.shape == (2 * len(z) * hop,), f"wave of {wave.shape} for {len(z)} codes")
            check(bool(np.isfinite(wave).all()) and float(np.abs(wave).max()) <= 1.0, "wave range")
        check(srv.stats["samples_out"] == valid, f"samples_out {srv.stats['samples_out']} != {valid}")
        check(launches[key] == steps > 0 and launches[other] == launches["ar_decode_stamped"] == 0,
              f"{precision}: AR launches {launches}, {steps} steps")
        check(launches["gru_scan"] == 2 and launches["gru_scan_masked"] == 2,
              f"GRU launches {launches}: expected 2 layers x 1 each")
        print(f"serve {precision} {slots} slots: 48 of 48 requests returned, {valid} samples "
              f"({valid / 16000:.3f} s of audio) in {steps} segment steps, {seconds:.3f} s wall "
              f"(first drain); launches {json.dumps(launches)}  [{card}]")
        return waves, launches, srv

    waves, launches, _ = served(8)
    second = server()
    again = drain(second, requests)
    check(all(np.array_equal(a, b) for a, b in zip(waves, again)),
          "two drains with one seed gave different waves")
    print(f"serve: a second drain with seed {seed} gave identical waves  [{card}]")

    # Greedy: the 8 shortest requests against single-shot decodes.
    shortest = sorted(requests, key=lambda q: len(q[0]))[:8]
    greedy_waves = drain(server(greedy=True), shortest)
    w = ar.prep_decode_weights(vocoder)
    table = mulaw_decode(torch.arange(n_classes, device=DEVICE), n_classes).cpu().numpy()
    same, worst_gap = 0, 0.0
    for (z, spk), wave in zip(shortest, greedy_waves):
        zt = torch.from_numpy(z)[None].to(DEVICE)
        st = torch.tensor([spk], device=DEVICE)
        single = ar.fused_ar_decode(vocoder, zt, st, greedy=True, weights={"bf16": w})[0].cpu().numpy()
        got, ref = _classes_of(wave, table), _classes_of(single, table)
        (t0,) = first_divergence(got[:, None], ref[:, None])
        if t0 is None:
            same += 1
            continue
        # The plain version's scores where the two first differ.
        cond = ar.project_cond_frames(w, build_conditioning_frames(vocoder, zt, st))
        cond = cond[:, : t0 // hop + 1].transpose(0, 1).contiguous()
        h0, prev0 = ar.init_decode_state(1, w.wh.shape[0], n_classes, cond.device)
        _, _, scores = ar.ar_decode_reference(cond, h0, prev0, w, hop, greedy=True,
                                              return_scores=True)
        sc = scores[t0, 0].cpu().numpy()
        gap = float(sc.max() - sc[got[t0]])
        check(gap <= MAX_GAP, f"greedy server vs single shot: gap {gap} at step {t0}")
        worst_gap = max(worst_gap, gap)
    print(f"serve greedy: 8 requests of {len(shortest[0][0])}-{len(shortest[-1][0])} codes, "
          f"{same} of 8 bit-identical to single-shot fused_ar_decode; worst plain-version "
          f"gap where one diverged {worst_gap:.3e} (bound {MAX_GAP})  [{card}]")

    launches_by_slots, servers = {8: launches}, {8: second}
    for slots in SERVE_SLOTS[1:]:
        _, launches_by_slots[slots], servers[slots] = served(slots)
    # The same mix at int8: the int8 kernel, and not the bf16 one, at every slot count.
    launches_int8 = {slots: served(slots, "int8")[1] for slots in SERVE_SLOTS}
    return {"launches": launches_by_slots, "launches_int8": launches_int8, "servers": servers,
            "requests": requests, "valid": valid, "vocoder": vocoder}


def _dual_vocoder(seed: int):
    """A full-width dual16 vocoder (H 896, halves of 448, 256 classes a
    head) on the card, randomized as phase 4b's, its heads' second layers
    8 times larger so that the scores have a clear maximum."""
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.models.vocoder import Vocoder

    net = load_conf(["training_vocoder.model.network.rnnms.output=dual16"]
                    ).training_vocoder.model.network
    vocoder = Vocoder(net)
    randomize(vocoder, np.random.default_rng(seed + 4))
    with torch.no_grad():
        vocoder.rnnms.o2.weight.mul_(8.0)
        vocoder.rnnms.o4.weight.mul_(8.0)
    return net, vocoder.to(DEVICE).eval()


def _check_pcm16(wave: np.ndarray, n: int, what: str) -> None:
    """``wave`` holds ``n`` values, each a 16-bit sample's (256 c + f) / 32767.5 - 1 to 1e-6."""
    from vectorquantizedcpc_tpu_torch.dsp.pcm16 import pcm16_to_float

    check(wave.shape == (n,), f"{what}: wave of {wave.shape}, expected ({n},)")
    v = np.rint((wave.astype(np.float64) + 1.0) * 32767.5)
    check(bool(np.isfinite(wave).all()) and v.min() >= 0 and v.max() <= 65535,
          f"{what}: values outside 16-bit PCM")
    off = float(np.abs(pcm16_to_float(v.astype(np.int64)) - wave).max())
    check(off <= 1e-6, f"{what}: a value {off} from its 16-bit sample's")


def phase_serve_dual(seed: int, card: str, serve: dict) -> dict:
    """The dual softmax head on the main serving path: phase 4b's 48
    requests through ``ContinuousBatcher`` at 8 slots, bf16, sampled, the
    counts zeroed just before and read just after. The planned drain takes
    one dual decode launch a segment and no AR decode launch, the PreNet's
    GRU kernels once each; every wave is 16-bit PCM of its length and
    ``samples_out`` counts 16-bit samples; a second drain with the seed
    gives the same waves; the same requests by ``step()`` take one launch
    a step. Returns the launch counts."""
    from vectorquantizedcpc_tpu_torch.infer.serving import ContinuousBatcher
    from vectorquantizedcpc_tpu_torch.ops import ar_decode as ar
    from vectorquantizedcpc_tpu_torch.ops import dual_decode as dd
    from vectorquantizedcpc_tpu_torch.ops import gru_train as g

    net, vocoder = _dual_vocoder(seed)
    hop = net.rnnms.upsampling_t
    requests, valid = serve["requests"], serve["valid"]

    def server():
        return ContinuousBatcher(vocoder, slots=8, segment_frames=4,
                                 max_frames=2 * max(MIX_CODES) + 32, precision="bf16",
                                 seed=seed, device=DEVICE)

    def zero():
        torch.cuda.synchronize()
        dd.DUAL_DECODE_LAUNCHES = 0
        ar.AR_DECODE_LAUNCHES = ar.AR_DECODE_INT8_LAUNCHES = ar.AR_DECODE_STAMPED_LAUNCHES = 0
        g.GRU_SCAN_LAUNCHES = g.GRU_SCAN_MASKED_LAUNCHES = 0

    def counts():
        return {"dual_decode": dd.DUAL_DECODE_LAUNCHES,
                "ar_decode": ar.AR_DECODE_LAUNCHES + ar.AR_DECODE_INT8_LAUNCHES
                + ar.AR_DECODE_STAMPED_LAUNCHES,
                "gru_scan": g.GRU_SCAN_LAUNCHES, "gru_scan_masked": g.GRU_SCAN_MASKED_LAUNCHES}

    def drain(srv):
        rids = [srv.submit(z, spk) for z, spk in requests]
        waves = srv.run()
        return [waves[r] for r in rids]

    srv = server()
    zero()
    start = time.perf_counter()
    waves = drain(srv)
    seconds = time.perf_counter() - start
    launches = counts()
    steps = int(srv.stats["steps"])
    check(len(waves) == 48, f"dual16: {len(waves)} of 48 requests returned")
    for i, ((z, _spk), wave) in enumerate(zip(requests, waves)):
        _check_pcm16(wave, 2 * len(z) * hop, f"dual16 request {i}")
    check(srv.stats["samples_out"] == valid,
          f"dual16: samples_out {srv.stats['samples_out']} != {valid}")
    check(launches["dual_decode"] == steps > 0 and launches["ar_decode"] == 0,
          f"dual16: launches {launches}, {steps} segment steps")
    check(launches["gru_scan"] == 2 and launches["gru_scan_masked"] == 2,
          f"dual16: GRU launches {launches}: expected 2 layers x 1 each")
    again = drain(server())
    check(all(np.array_equal(a, b) for a, b in zip(waves, again)),
          "dual16: two drains with one seed gave different waves")

    stepped = server()
    rids = [stepped.submit(z, spk) for z, spk in requests]
    zero()
    done = []
    while len(done) < len(rids):
        done += stepped.step()
    launches_step = dd.DUAL_DECODE_LAUNCHES
    check(launches_step == int(stepped.stats["steps"]) > 0,
          f"dual16 step(): {launches_step} launches, {stepped.stats['steps']} steps")
    for i, ((z, _spk), rid) in enumerate(zip(requests, rids)):
        _check_pcm16(stepped.result(rid), 2 * len(z) * hop, f"dual16 step() request {i}")
    print(f"serve dual16 bf16 8 slots: 48 of 48 requests returned as 16-bit PCM, {valid} "
          f"samples ({valid / 16000:.3f} s of audio) in {steps} segment steps, {seconds:.3f} s "
          f"wall (first drain); launches {json.dumps(launches)}; a second drain gave the same "
          f"waves; step() took {launches_step} launches for {int(stepped.stats['steps'])} "
          f"steps  [{card}]")
    return {"launches": launches, "launches_step": launches_step}


def _speechlike_wave(n_samples: int, cat: int, spk: int, sr: int, rng) -> np.ndarray:
    """Segments of 40-150 ms, as syllables are: a fifth of them noise, the
    rest harmonics of a pitch around the category's (110 + 45 cat Hz, a
    sixth of an octave of jitter) under three random formant peaks and the
    speaker's spectral tilt (-6 or -10 dB per octave)."""
    wave = np.zeros(n_samples)
    pos = 0
    while pos < n_samples:
        n = min(int(rng.integers(int(0.04 * sr), int(0.15 * sr))), n_samples - pos)
        t = np.arange(n) / sr
        if rng.random() < 0.2:
            seg = 0.05 * rng.normal(size=n)
        else:
            f0 = (110 + 45 * cat) * 2 ** rng.normal(0, 0.15)
            formants = rng.uniform(300, 3500, size=3)
            seg = np.zeros(n)
            for k in range(1, int(4000 // f0)):
                peaks = sum(3 * np.exp(-(((k * f0) - f) / 150) ** 2) for f in formants)
                amp = 10 ** ((-6 - 4 * spk) * np.log2(k) / 20) * (1 + peaks)
                seg += amp * np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 2 * np.pi))
            seg *= 0.1 * np.hanning(n) ** 0.3
        wave[pos : pos + n] = seg
        pos += n
    return wave + 0.002 * rng.normal(size=n_samples)


def _write_mels(d: Path, seed: int):
    """A full-width random encoder as a reference checkpoint and 40 mels of
    50 to 1,000 frames from speech-like synthetic wavs: 4 "categories" of
    pitch, 2 "speakers" of spectral tilt. Returns {stem: (frames, category,
    speaker)}."""
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.dsp.mel import wave_to_mel
    from vectorquantizedcpc_tpu_torch.models.encoder import Encoder

    conf = load_conf([])
    rng = np.random.default_rng(seed + 7)
    encoder = Encoder(conf.model.encoder)
    randomize(encoder, rng)
    torch.save({"encoder": encoder.state_dict(), "epoch": 0}, d / "cpc.pt")
    pp = conf.data.dataset.preprocess
    lengths = rng.integers(50, 1001, size=EXPORT_MELS)
    lengths[:2] = [50, 1000]
    (d / "mels").mkdir()
    meta = {}
    for i, n in enumerate(lengths):
        cat, spk = i % 4, (i // 4) % 2
        # (n - 1) hops of samples give n mel frames.
        wave = _speechlike_wave(int(n - 1) * pp.hop_length, cat, spk, pp.sr, rng)
        mel = wave_to_mel(wave.astype(np.float32), pp)
        check(mel.shape == (pp.n_mels, n), f"mel of {mel.shape} for {n} frames")
        stem = f"s{spk}_u{i:02d}"
        np.save(d / "mels" / f"{stem}.mel.npy", mel)
        meta[stem] = (int(n), f"c{cat}", f"s{spk}")
    return meta


def phase_export(seed: int, card: str) -> dict:
    """The encode CLI end to end on the card at the default bf16, then at
    f32 for the codes, then the ABX CLI on the bf16 dumps."""
    from vectorquantizedcpc_tpu_torch.cli import encode as encode_cli
    from vectorquantizedcpc_tpu_torch.cli import eval_abx
    from vectorquantizedcpc_tpu_torch.ops import lstm_scan as ls

    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        meta = _write_mels(d, seed)
        buckets = {}
        for n, _, _ in meta.values():
            padded = max(64, -(-n // 64) * 64)
            buckets[padded] = buckets.get(padded, 0) + 1
        n_batches = sum(-(-k // 16) for k in buckets.values())
        frames = sum(n // 2 for n, _, _ in meta.values())
        argv = [f"cpc_checkpoint={d / 'cpc.pt'}", f"in_dir={d / 'mels'}", "save_auxiliary=true"]
        torch.cuda.synchronize()
        ls.LSTM_SCAN_LAUNCHES = 0
        start = time.perf_counter()
        n = encode_cli.main(argv + [f"out_dir={d / 'bf16' / 'codes'}"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = ls.LSTM_SCAN_LAUNCHES
        check(n == EXPORT_MELS, f"exported {n} utterances, expected {EXPORT_MELS}")
        check(launches == n_batches, f"{launches} LSTM scan launches for {n_batches} batches")
        check(encode_cli.main(argv + [f"out_dir={d / 'f32' / 'codes'}",
                                      "runtime.precision=float32"]) == EXPORT_MELS, "f32 export")
        emb = torch.load(d / "cpc.pt")["encoder"]["codebook.embedding"].double().numpy()
        same, worst_gap, worst_pre = 0, 0.0, 0.0
        for stem, (n_frames, _, _) in meta.items():
            dumps = {}
            for prec in ("bf16", "f32"):
                for sub in ("codes", "auxiliary_embedding1", "auxiliary_embedding2"):
                    rows = dumps[prec, sub] = np.loadtxt(d / prec / sub / f"{stem}.txt", ndmin=2)
                    check(rows.shape[0] == n_frames // 2 and bool(np.isfinite(rows).all()),
                          f"{prec} {sub}/{stem}: {rows.shape} rows for {n_frames} frames")
            # z rows are code vectors: their codes, and the f32 distances of z_pre.
            code = {p: ((dumps[p, "codes"][:, None] - emb) ** 2).sum(-1).argmin(-1)
                    for p in ("bf16", "f32")}
            z_pre = dumps["f32", "auxiliary_embedding2"]
            dist = ((z_pre[:, None] - emb) ** 2).sum(-1)
            rows = np.arange(len(z_pre))
            gap = (dist[rows, code["bf16"]] - dist[rows, code["f32"]]) / dist[rows, code["f32"]]
            same += int((code["bf16"] == code["f32"]).sum())
            worst_gap = max(worst_gap, float(gap.max()))
            worst_pre = max(worst_pre, float(np.abs(dumps["bf16", "auxiliary_embedding2"] - z_pre).max()))
        agree = same / frames
        check(agree >= MIN_CODE_AGREEMENT, f"bf16 codes agree with f32 on {agree:.4f} of frames")
        check(worst_gap <= MAX_CODE_GAP, f"a bf16 code is {worst_gap} farther than the f32 one")
        check(worst_pre <= MAX_PRE_VQ_ERR, f"bf16 z_pre differs from f32 by {worst_pre}")
        items = {stem: {"category": c, "speaker": s} for stem, (_, c, s) in meta.items()}
        (d / "items.json").write_text(json.dumps(items))
        abx = eval_abx.main(["--features", str(d / "bf16" / "codes"),
                             "--items", str(d / "items.json")])
        check(0.0 <= abx["abx_error_rate"] <= 1.0, f"ABX error rate {abx['abx_error_rate']}")
    print(f"export: {EXPORT_MELS} mels of 50-1000 frames in {n_batches} batches "
          f"({len(buckets)} buckets), {frames} latent frames, {launches} LSTM scan launches, "
          f"{seconds:.3f} s wall incl. checkpoint and mel load = {frames / seconds:.1f} latent "
          f"frames/s; codes agree with the f32 export on {agree:.6f} of frames "
          f"(bound {MIN_CODE_AGREEMENT}), where not a near-tie: relative f32 distance gap "
          f"{worst_gap:.3e} (bound {MAX_CODE_GAP}); z_pre max abs diff {worst_pre:.3e} "
          f"(bound {MAX_PRE_VQ_ERR}); ABX across speakers on the dumps: "
          f"{json.dumps(abx)}  [{card}]")
    return {"launches": launches, "seconds": seconds, "frames": frames}


def mix_ceiling(requests, slots: int, sf: int) -> float:
    """Slot-utilisation ceiling of a request mix (bench.py:554-562): valid
    frames over (makespan x sf x slots), LPT over the slot pool."""
    ends = [0] * slots
    for seg in sorted((-(-2 * len(z) // sf) for z, _ in requests), reverse=True):
        heapq.heappush(ends, heapq.heappop(ends) + seg)
    return sum(2 * len(z) for z, _ in requests) / (max(ends) * sf * slots)


def time_cuda(fn, reps: int) -> float:
    """Milliseconds per call, by CUDA events around ``reps`` calls after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# torch.cuda._sleep's spin, in clock cycles, ahead of time_device's launches:
# ~28 ms at 1.755 GHz, more than the host takes to enqueue them.
SLEEP_CYCLES = 50_000_000


def time_device(fn, reps: int) -> tuple:
    """(device ms per call, host us per call). The ``reps`` calls are
    enqueued behind a ``torch.cuda._sleep`` so that the CUDA events bracket
    only the device's work, the launches running back to back; the host's
    enqueue time per call is the wrapper's cost. Fails if the sleep ended
    before the host had enqueued every call."""
    fn()
    torch.cuda.synchronize()
    slept, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    slept.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    check(slept.elapsed_time(start) > host_ms, f"time_device: the sleep ({slept.elapsed_time(start):.3f}"
          f" ms) ended before the {reps} calls were enqueued ({host_ms:.3f} ms)")
    return start.elapsed_time(end) / reps, host_ms * 1e3 / reps


def _decode_bound(w, batch: int, steps: int, cond_proj, h0, prev0):
    """(bound ms, what bounds it, operations, bytes) of one decode: each
    input read once and each output written once; the products at the
    tensor-core peak of their type (int8 mode: wh and FC1 int8, FC2 bf16)."""
    hidden, fc = w.fc1_w.shape
    n_classes = w.fc2_w.shape[1]
    ops_gate_fc1 = 2 * batch * steps * (hidden * 3 * hidden + hidden * fc)
    ops_fc2 = 2 * batch * steps * fc * n_classes
    peak = PEAK_INT8_OPS if w.mode == "int8" else PEAK_BF16_FLOPS
    ops_ms = (ops_gate_fc1 / peak + ops_fc2 / PEAK_BF16_FLOPS) * 1e3
    weight_tensors = [w.embed_proj, w.wh, w.bh, w.fc1_w, w.fc1_b, w.fc2_w, w.fc2_b]
    weight_tensors += [x for x in (w.embed_scale, w.wh_scale, w.fc1_scale) if x is not None]
    n_bytes = sum(t.numel() * t.element_size() for t in weight_tensors)
    n_bytes += cond_proj.numel() * 2 + prev0.numel() * 4 + 2 * h0.numel() * 4 + steps * batch * 4
    bytes_ms = n_bytes / PEAK_BYTES * 1e3
    return (max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes",
            ops_gate_fc1 + ops_fc2, n_bytes)


def phase_time(seed: int, card: str):
    """The AR step in both modes at B = 1, 8, 32, 64 and 128, 100 frames
    (1 s), and the pick that "auto" makes at each; int8 also staging q(h)
    from the f32 h (the design option) at 8, 32 and 64; kernel and plain
    version at B = 8 with the bound. Returns ({mode: B = 8 numbers},
    {mode: {B: kernel ms}})."""
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.models.vocoder import Vocoder
    from vectorquantizedcpc_tpu_torch.ops import ar_decode as ar

    net = load_conf([]).training_vocoder.model.network
    vocoder = Vocoder(net)
    rng = np.random.default_rng(seed + 2)
    randomize(vocoder, rng)
    vocoder = vocoder.cuda().eval()
    weights = {mode: ar.prep_decode_weights(vocoder, mode) for mode in ("bf16", "int8")}
    frames, hop = TIME_FRAMES, net.rnnms.upsampling_t
    hidden, fc = weights["bf16"].fc1_w.shape
    n_classes = weights["bf16"].fc2_w.shape[1]
    cond = torch.from_numpy(
        rng.uniform(-1, 1, size=(max(TIME_BATCHES), frames, net.rnnms.dim_voc_latent)).astype(np.float32)
    ).cuda()
    cond_all = ar.project_cond_frames(weights["bf16"], cond).transpose(0, 1).contiguous()
    steps = frames * hop
    audio_s = steps / 16000

    def inputs(batch):
        h0, prev0 = ar.init_decode_state(batch, hidden, n_classes, cond.device)
        return cond_all[:, :batch].contiguous(), h0, prev0

    ms_by_batch, timing = {}, {}
    for mode, w in weights.items():
        ms_by_batch[mode] = {}
        for batch in TIME_BATCHES:
            args = inputs(batch)
            ms = ms_by_batch[mode][batch] = time_cuda(lambda: ar.ar_decode(*args, w, hop, seed=1),
                                                      reps=3)
            grid, units, smem = ar.kernel_plan(batch, hidden, fc, n_classes, mode)
            print(f"timing ar_decode {mode} B={batch} steps={steps} ({audio_s:.3f} s audio): kernel "
                  f"{ms:.3f} ms = {ms * 1e3 / steps:.3f} us/step, {batch * steps / (ms / 1e3):.1f} "
                  f"samples/s; grid {grid} blocks x {units} units, {smem} B shared memory  [{card}]")
        batch = 8
        cond_proj, h0, prev0 = inputs(batch)
        plain_ms = time_cuda(lambda: ar.ar_decode_reference(cond_proj, h0, prev0, w, hop, seed=1),
                             reps=1)
        bound, by, ops, n_bytes = _decode_bound(w, batch, steps, cond_proj, h0, prev0)
        kernel_ms = ms_by_batch[mode][batch]
        print(f"timing ar_decode {mode} B={batch} steps={steps}: kernel {kernel_ms:.3f} ms, RTF "
              f"{kernel_ms / 1e3 / audio_s:.5f}; plain {plain_ms:.3f} ms; bound "
              f"{bound * 1e3:.3f} us by {by} ({ops:.4g} operations, {n_bytes:.4g} B); bound / "
              f"kernel = {bound / kernel_ms * 100:.4f} %  [{card}]")
        timing[mode] = {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by}
    step_us = {mode: [[b, round(ms * 1e3 / steps, 3)] for b, ms in by.items()]
               for mode, by in ms_by_batch.items()}
    picks = {b: ar.resolve_precision("auto", b) for b in TIME_BATCHES}
    measured_picks = {b: ar.resolve_precision("auto", b, step_us) for b in TIME_BATCHES}
    print(f"timing auto: built-in table picks {json.dumps(picks)}; this run's times pick "
          f"{json.dumps(measured_picks)}; this run's us/step "
          f"{json.dumps({'device': torch.cuda.get_device_name(0), **step_us})}  [{card}]")
    timing["int8"].update(auto_pick_by_batch=picks, measured_auto_pick_by_batch=measured_picks)
    return timing, ms_by_batch


def phase_time_dual(seed: int, card: str) -> dict:
    """The dual decode at B in DUAL_BATCHES, 100 frames (1 s); kernel and
    plain version at B = 8 with the bound: each input read once and each
    output written once, the products at the bf16 tensor-core peak (the
    byte and c_t columns are element-wise and left out)."""
    from vectorquantizedcpc_tpu_torch.ops import ar_decode as ar
    from vectorquantizedcpc_tpu_torch.ops import dual_decode as dd

    net, vocoder = _dual_vocoder(seed + 2)
    w = dd.prep_dual_weights(vocoder)
    frames, hop = TIME_FRAMES, net.rnnms.upsampling_t
    hidden, half = w.wh.shape[0], w.wh.shape[0] // 2
    n_classes = w.o2_w.shape[1]
    rng = np.random.default_rng(seed + 2)
    cond = torch.from_numpy(
        rng.uniform(-1, 1, size=(max(DUAL_BATCHES), frames, net.rnnms.dim_voc_latent))
        .astype(np.float32)).cuda()
    cond_all = ar.project_cond_frames(w, cond).transpose(0, 1).contiguous()
    steps = frames * hop
    ms_by_batch = {}
    for batch in DUAL_BATCHES:
        args = (cond_all[:, :batch].contiguous(), dd.init_dual_state(batch, hidden, cond.device))
        ms = ms_by_batch[batch] = time_cuda(lambda: dd.dual_decode(*args, w, hop, seed=1), reps=3)
        print(f"timing dual_decode B={batch} steps={steps}: kernel {ms:.3f} ms = "
              f"{ms * 1e3 / steps:.3f} us/step, {batch * steps / (ms / 1e3):.1f} samples/s  "
              f"[{card}]")
    batch = 8
    cond_proj, state = cond_all[:, :batch].contiguous(), dd.init_dual_state(batch, hidden,
                                                                             cond.device)
    plain_ms = time_cuda(lambda: dd.dual_decode_reference(cond_proj, state, w, hop, seed=1),
                         reps=1)
    ops = 2 * batch * steps * (hidden * 3 * hidden + 2 * (half * half + half * n_classes))
    kernel_tensors = [t for name, t in w._asdict().items() if name not in ("wx_cond", "bx")]
    n_bytes = sum(t.numel() * t.element_size() for t in kernel_tensors)
    n_bytes += cond_proj.numel() * 2 + 2 * state.h.numel() * 4 + 2 * batch * 4 + steps * batch * 4
    ops_ms, bytes_ms = ops / PEAK_BF16_FLOPS * 1e3, n_bytes / PEAK_BYTES * 1e3
    bound, by = max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"
    kernel_ms = ms_by_batch[batch]
    print(f"timing dual_decode B={batch} steps={steps}: kernel {kernel_ms:.3f} ms; plain "
          f"{plain_ms:.3f} ms; bound {bound * 1e3:.3f} us by {by} ({ops:.4g} operations, "
          f"{n_bytes:.4g} B); bound / kernel = {bound / kernel_ms * 100:.4f} %  [{card}]")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "ms_by_batch": ms_by_batch}


STAMP_BATCHES = (1, 8, 64, 128)
STAMP_FRAMES = 8  # 1,280 steps per stamped launch


def phase_stamps(seed: int, card: str) -> dict:
    """The AR step's split by phase, from the kernel variant that stamps
    clock64 per phase on block 0 and the grid's last block
    (``ar_decode_stamped``, reached from nothing but this phase), in both
    modes at B 1, 8, 64 and 128 (the serving shape); ``summarize_stamps``
    turns the buffer into microseconds per step. Returns {mode: {B: split}}."""
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.models.vocoder import Vocoder
    from vectorquantizedcpc_tpu_torch.ops import ar_decode as ar

    net = load_conf([]).training_vocoder.model.network
    vocoder = Vocoder(net)
    rng = np.random.default_rng(seed + 2)
    randomize(vocoder, rng)
    vocoder = vocoder.to(DEVICE).eval()
    hop, hidden = net.rnnms.upsampling_t, net.rnnms.wave_ar.size_h_rnn
    n_classes = 2 ** net.rnnms.bits_mu_law
    steps = STAMP_FRAMES * hop
    cond = torch.from_numpy(rng.uniform(
        -1, 1, size=(max(STAMP_BATCHES), STAMP_FRAMES, net.rnnms.dim_voc_latent)
    ).astype(np.float32)).to(DEVICE)
    out = {}
    for mode in ("bf16", "int8"):
        w = ar.prep_decode_weights(vocoder, mode)
        cond_all = ar.project_cond_frames(w, cond).transpose(0, 1).contiguous()
        out[mode] = {}
        for batch in STAMP_BATCHES:
            h0, prev0 = ar.init_decode_state(batch, hidden, n_classes, cond.device)
            args = (cond_all[:, :batch].contiguous(), h0, prev0, w, hop)
            ar.ar_decode_stamped(*args, seed=1)  # warm-up
            _, _, stamps = ar.ar_decode_stamped(*args, seed=1)
            torch.cuda.synchronize()
            split = ar.summarize_stamps(stamps.cpu().tolist(), steps)
            check(bool(split), f"stamps {mode} B={batch}: no block recorded")
            out[mode][batch] = split
            for block, phases in split.items():
                print(f"stamps ar_decode {mode} B={batch} {block} (us/step over {steps - 1} "
                      f"steps, sampled): " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items())
                      + f"  [{card}]")
    return out


def phase_gru_stamps(seed: int, card: str) -> dict:
    """The GRU grid kernels' split by phase at the vocoder's T 5,120, B 32,
    H 896, from their stamped variants (``gru_scan_train_stamped``,
    ``gru_scan_bwd_stamped``, reached from nothing but this phase), which
    must give the plain launches' bits. Returns {"forward": split,
    "backward": split}, each {block: {phase: us per step}}."""
    from vectorquantizedcpc_tpu_torch.ops import gru_train as g

    steps, batch, hidden = GRU_TRAIN_SHAPES["training"]
    args = _gru_train_inputs(seed, steps, batch, hidden)
    plain = g.gru_scan_train(*args)
    g.gru_scan_train_stamped(*args)  # warm-up
    *got, stamps = g.gru_scan_train_stamped(*args)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, plain)),
          "the stamped GRU grid forward's outputs are not the plain launch's bits")
    out = {"forward": g.summarize_grid_stamps(stamps.cpu().tolist(), steps)}
    rng = np.random.default_rng(seed + 17)
    dhs = torch.from_numpy(rng.normal(size=(steps, batch, hidden)).astype(np.float32)).to(
        DEVICE).bfloat16()
    h_prevs = torch.cat([args[3].bfloat16()[None], plain[0][:-1]]).contiguous()
    bwd_args = (plain[1], plain[2], h_prevs, dhs, args[0], torch.zeros_like(plain[3]))
    plain_b = g.gru_scan_bwd(*bwd_args)
    g.gru_scan_bwd_stamped(*bwd_args)
    *got_b, stamps_b = g.gru_scan_bwd_stamped(*bwd_args)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got_b, plain_b)),
          "the stamped gru_scan_bwd's outputs are not the plain launch's bits")
    out["backward"] = g.summarize_grid_stamps(stamps_b.cpu().tolist(), steps, backward=True)
    for kernel, split in out.items():
        check(bool(split), f"stamps GRU grid {kernel}: no block recorded")
        for block, phases in split.items():
            print(f"stamps gru grid {kernel} T={steps} B={batch} H={hidden} {block} (us/step over "
                  f"{steps - 1} steps): " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items())
                  + f"  [{card}]")
    return out


def phase_lstm_stamps(seed: int, card: str) -> dict:
    """The cluster LSTM kernels' split by phase, from their stamped variants
    (``lstm_scan_stamped``, ``lstm_scan_bwd_stamped``, reached from nothing
    but this phase), which must give the plain launches' bits: the
    inference forward at the export shape, the training forward and the
    backward at the training shape. Returns {shape: {kernel: split}}, each
    split {CTA: {phase: us per step}}."""
    from vectorquantizedcpc_tpu_torch.ops import lstm_scan as ls

    out = {}
    for shape, (batch, steps) in LSTM_SHAPES.items():
        args = _lstm_inputs(seed, batch, steps)
        save = shape == "training"
        plain = ls.lstm_scan_train(*args) if save else ls.lstm_scan(*args)
        ls.lstm_scan_stamped(*args, save=save)  # warm-up
        hs, acts, c_prev, h_t, c_t, stamps = ls.lstm_scan_stamped(*args, save=save)
        torch.cuda.synchronize()
        got = (hs, acts, c_prev, h_t, c_t) if save else (hs, h_t, c_t)
        check(all(torch.equal(a, b) for a, b in zip(got, plain)),
              f"the stamped LSTM forward's outputs at the {shape} shape are not the plain bits")
        splits = {"training forward" if save else "forward":
                  ls.summarize_scan_stamps(stamps.cpu().tolist(), steps)}
        if save:
            rng = np.random.default_rng(seed + 12)
            dhs = torch.from_numpy(rng.normal(size=(steps, batch, LSTM_H)).astype(np.float32)).to(
                DEVICE).bfloat16()
            bwd_args = (acts, c_prev, dhs, args[0], torch.zeros_like(h_t), torch.zeros_like(c_t))
            plain_b = ls.lstm_scan_bwd(*bwd_args)
            ls.lstm_scan_bwd_stamped(*bwd_args)
            *got_b, stamps_b = ls.lstm_scan_bwd_stamped(*bwd_args)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got_b, plain_b)),
                  "the stamped lstm_scan_bwd's outputs are not the plain launch's bits")
            splits["backward"] = ls.summarize_scan_stamps(stamps_b.cpu().tolist(), steps, True)
        for kernel, split in splits.items():
            check(bool(split), f"stamps LSTM {kernel} at {shape}: no CTA recorded")
            for block, phases in split.items():
                print(f"stamps lstm {kernel} {shape} B={batch} T={steps} H={LSTM_H} {block} "
                      f"(us/step over {steps - 1} steps): "
                      + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()) + f"  [{card}]")
        out[shape] = splits
    return out


def phase_time_lstm_grid_h256(seed: int, card: str) -> dict:
    """The grid LSTM pair (csrc/lstm_grid.cu) at the cluster kernels' H 256,
    launched through its entry points (``scan_route`` sends H 256 to the
    cluster), held against the plain versions and timed at the export shape
    (inference) and the training shape (training forward, backward): the
    yardstick of one LSTM kernel family (``ls._grid_forward`` and
    ``_grid_backward``, which count nothing)."""
    from vectorquantizedcpc_tpu_torch.ops import lstm_scan as ls

    def forward(args, save):
        hs, acts, c_prev, h_out, c_out = ls._grid_forward(*args, save)
        return (hs, acts, c_prev, h_out, c_out) if save else (hs, h_out, c_out)

    backward = ls._grid_backward

    out = {}
    batch, steps = LSTM_SHAPES["export"]
    args = _lstm_inputs(seed, batch, steps)
    got, ref = forward(args, False), ls.lstm_scan_reference(*args)
    errs = [float((a.float() - r.float()).abs().max()) for a, r in zip(got, ref)]
    check(max(errs) <= MAX_LSTM_ERR, f"grid LSTM at H 256, export shape: {errs}")
    with torch.no_grad():
        out["lstm_scan"] = time_cuda(lambda: forward(args, False), reps=20)
    batch, steps = LSTM_SHAPES["training"]
    args = _lstm_inputs(seed, batch, steps)
    got, ref = forward(args, True), ls.lstm_scan_train_reference(*args)
    errs = [float((a.float() - r.float()).abs().max()) for a, r in zip(got, ref)]
    check(max(errs) <= MAX_LSTM_ERR, f"grid LSTM at H 256, training shape: {errs}")
    rng = np.random.default_rng(seed + 12)
    dhs = torch.from_numpy(rng.normal(size=(steps, batch, LSTM_H)).astype(np.float32)).to(
        DEVICE).bfloat16()
    bwd_args = (ref[1], ref[2], dhs, args[0], torch.zeros_like(ref[3]), torch.zeros_like(ref[4]))
    kb, rb = backward(*bwd_args), ls.lstm_scan_bwd_reference(*bwd_args)
    for what, a, r in zip(("dgates", "dh0", "dc0"), kb, rb):
        e, m = _rel_err(a, r)
        check(e <= MAX_LSTM_BWD_REL * m + 1e-3, f"grid LSTM backward at H 256: {what} {e} of {m}")
    out["lstm_scan_train"] = time_cuda(lambda: forward(args, True), reps=20)
    out["lstm_scan_bwd"] = time_cuda(lambda: backward(*bwd_args), reps=20)
    old = EARLIER_GRID_MS["h256"]
    print(f"timing lstm grid pair at H={LSTM_H} (yardstick; the cluster kernels take H 256): "
          f"inference B={LSTM_SHAPES['export'][0]} T={LSTM_SHAPES['export'][1]} "
          f"{out['lstm_scan']:.4f} ms, training forward B={batch} T={steps} "
          f"{out['lstm_scan_train']:.4f} ms, backward {out['lstm_scan_bwd']:.4f} ms (one-barrier "
          f"grid: {old[0]} / {old[1]} / {old[2]} ms)  [{card}]")
    return out


def report_lstm(stamps: dict, timing_lstm: dict, timing_train: dict, grid_h256: dict,
                timing_voc: dict, timing_masked_grid: dict, exported: dict, card: str) -> None:
    """Phase 5's account of the cluster LSTM pair: the stamped split of the
    FMA kernels (FMA_LSTM_STAMPS) beside this run's; each kernel beside its
    bound, cuDNN, the grid pair at H 256 and its earlier time (EARLIER_MS);
    the kernels that must not move (UNMOVED_MS), the CPC step and the
    export beside theirs."""
    for kernel, split in (("forward export", stamps["export"]["forward"]),
                          ("training forward training", stamps["training"]["training forward"]),
                          ("backward training", stamps["training"]["backward"])):
        old = FMA_LSTM_STAMPS[kernel]
        print(f"stamps lstm {kernel}, rank 0, us/step, FMA kernels -> this run: "
              + ", ".join(f"{ph} {old[ph]:.3f} -> {split['block 0'][ph]:.3f}" for ph in old)
              + f"  [{card}]")
    rows = (("lstm_scan", timing_lstm["export"], LSTM_SHAPES["export"]),
            ("lstm_scan_train", timing_train["lstm_scan_train"], LSTM_SHAPES["training"]),
            ("lstm_scan_bwd", timing_train["lstm_scan_bwd"], LSTM_SHAPES["training"]))
    for name, res, (batch, steps) in rows:
        print(f"lstm table {name} B={batch} T={steps} H={LSTM_H}: kernel {res['ms']:.4f} ms = "
              f"{res['ms'] * 1e3 / steps:.3f} us/step (earlier {EARLIER_MS[name]} ms, "
              f"{EARLIER_MS[name] / res['ms']:.2f}x); bound {res['bound_ms'] * 1e3:.3f} us by "
              f"{res['bound_by']}; cuDNN {res['library_ms']:.4f} ms; grid pair at H 256 "
              f"{grid_h256[name]:.4f} ms (cluster / grid {res['ms'] / grid_h256[name]:.3f})  "
              f"[{card}]")
    unmoved = {"lstm_scan": timing_lstm["export"]["ms"],
               "lstm_scan_train": timing_train["lstm_scan_train"]["ms"],
               "lstm_scan_bwd": timing_train["lstm_scan_bwd"]["ms"],
               "gru_scan_train": timing_voc["gru_scan_train"]["ms"],
               "gru_scan_bwd": timing_voc["gru_scan_bwd"]["ms"],
               "gru_scan_masked_grid": timing_masked_grid["ms"],
               "cpc_select": timing_train["cpc_select"]["ms"],
               "cpc_select_bwd": timing_train["cpc_select_bwd"]["ms"]}
    print("unmoved kernels, this run against earlier (ms): " + ", ".join(
        f"{k} {v:.4f} vs {UNMOVED_MS[k]} ({(v / UNMOVED_MS[k] - 1) * 100:+.1f} %)"
        for k, v in unmoved.items()) + f"  [{card}]")
    step = timing_train["step"]
    busy = step.get("device_busy_ms")
    busy_text = "not measured" if busy is None else (
        f"{busy:.3f} ms of device work (earlier {EARLIER_MS['cpc_device_busy']}), idle "
        f"{(1 - busy / step['ms']) * 100:.2f} %")
    fps = exported["frames"] / exported["seconds"]
    print(f"end to end: CPC train step (the graph path) {step['ms']:.3f} ms = "
          f"{step['steps_per_s']:.2f} steps/s (earlier, eager: {EARLIER_MS['cpc_step']} ms; this "
          f"run's eager path {step['eager']['ms']:.3f} ms), {busy_text}; export {fps:.1f} latent frames/s "
          f"(earlier {EARLIER_EXPORT_FRAMES_S})  [{card}]")


def _gru_bound(x: dict, masked: bool):
    """(bound ms, what bounds it): each input read once, each output
    written once; the operations of the steps the data needs."""
    g, t, h = GRU_G, GRU_T, x["wh"].shape[0]
    n_bytes = sum(x[k].numel() * x[k].element_size() for k in ("wh", "bh", "xproj", "h0"))
    n_bytes += t * g * h * 2 + g * h * 4  # hs bf16, h_T f32
    steps = g * t
    if masked:
        n_bytes += x["valid"].numel() * 4
        steps = int(x["valid"].sum())
    flops = 2 * steps * h * 3 * h
    ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, n_bytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes"), flops, n_bytes


def phase_time_gru(seed: int, card: str) -> dict:
    """Both GRU scans, their plain versions and cuDNN's GRU at the serving
    PreNet's shape. cuDNN (one layer, one direction, fp16, on the (G, T,
    2H) input; a PackedSequence of the same lengths for the masked scan)
    is only timed here: the port never calls it."""
    from vectorquantizedcpc_tpu_torch.ops import gru_train as g

    x = _gru_inputs(seed)
    args = (x["wh"], x["bh"], x["xproj"])
    gru_in = torch.randn(GRU_G, GRU_T, 2 * GRU_H, device=DEVICE, dtype=CUDNN_DTYPE)
    cudnn = torch.nn.GRU(2 * GRU_H, GRU_H, batch_first=True).to(DEVICE, CUDNN_DTYPE)
    packed = torch.nn.utils.rnn.pack_padded_sequence(
        gru_in, torch.from_numpy(x["lengths"]), batch_first=True, enforce_sorted=False
    )
    out = {}
    with torch.no_grad():
        for name, kernel, plain, lib in [
            ("gru_scan", lambda: g.gru_scan(*args, x["h0"]),
             lambda: g.gru_scan_reference(*args, x["h0"]), lambda: cudnn(gru_in)),
            ("gru_scan_masked", lambda: g.gru_scan_masked(*args, x["valid"], x["h0"]),
             lambda: g.gru_scan_masked_reference(*args, x["valid"], x["h0"]),
             lambda: cudnn(packed)),
        ]:
            bound, by, flops, n_bytes = _gru_bound(x, masked=name.endswith("masked"))
            res = {
                "ms": time_cuda(kernel, reps=20),
                "plain_ms": time_cuda(plain, reps=2),
                "bound_ms": bound,
                "bound_by": by,
                "library_ms": time_cuda(lib, reps=20),
            }
            print(f"timing {name} G={GRU_G} T={GRU_T} H={GRU_H}: kernel {res['ms']:.4f} ms "
                  f"= {res['ms'] * 1e3 / GRU_T:.3f} us/step; plain {res['plain_ms']:.3f} ms; "
                  f"cuDNN nn.GRU (fp16) {res['library_ms']:.4f} ms, kernel / cuDNN = "
                  f"{res['ms'] / res['library_ms']:.3f}; bound "
                  f"{bound * 1e3:.3f} us by {by} ({flops:.4g} FLOP, {n_bytes:.4g} B); "
                  f"bound / kernel = {bound / res['ms'] * 100:.3f} %  [{card}]")
            out[name] = res
    return out


def phase_time_gru_masked_grid(seed: int, card: str) -> dict:
    """The masked grid forward, its plain version and cuDNN's GRU on a
    PackedSequence of the same lengths, at G 48, T 200, H 256 (only timed
    here: the port never calls cuDNN)."""
    from vectorquantizedcpc_tpu_torch.ops import gru_train as g

    x = _gru_inputs(seed, GRU_WIDE_H)
    args = (x["wh"], x["bh"], x["xproj"], x["valid"], x["h0"])
    gru_in = torch.randn(GRU_G, GRU_T, 2 * GRU_WIDE_H, device=DEVICE, dtype=CUDNN_DTYPE)
    cudnn = torch.nn.GRU(2 * GRU_WIDE_H, GRU_WIDE_H, batch_first=True).to(DEVICE, CUDNN_DTYPE)
    packed = torch.nn.utils.rnn.pack_padded_sequence(
        gru_in, torch.from_numpy(x["lengths"]), batch_first=True, enforce_sorted=False)
    bound, by, flops, n_bytes = _gru_bound(x, masked=True)
    with torch.no_grad():
        res = {"ms": time_cuda(lambda: g.gru_scan_masked(*args), reps=20),
               "plain_ms": time_cuda(lambda: g.gru_scan_masked_reference(*args), reps=2),
               "bound_ms": bound, "bound_by": by,
               "library_ms": time_cuda(lambda: cudnn(packed), reps=20)}
    print(f"timing gru_scan_masked_grid G={GRU_G} T={GRU_T} H={GRU_WIDE_H}: kernel "
          f"{res['ms']:.4f} ms = {res['ms'] * 1e3 / GRU_T:.3f} us/step; plain "
          f"{res['plain_ms']:.3f} ms; cuDNN nn.GRU (fp16, packed) {res['library_ms']:.4f} ms; "
          f"bound {bound * 1e3:.3f} us by {by} ({flops:.4g} FLOP, {n_bytes:.4g} B); bound / "
          f"kernel = {bound / res['ms'] * 100:.3f} %  [{card}]")
    return res


def _lstm_grid_plan_text(batch: int, hidden: int) -> str:
    """The grid LSTM plan of both directions at (B, H): groups x blocks x
    units, shared bytes a block, K chunk."""
    from vectorquantizedcpc_tpu_torch.ops import lstm_scan as ls

    parts = []
    for backward, k in ((False, hidden), (True, 4 * hidden)):
        p = ls.grid_plan(batch, hidden, backward=backward)
        parts.append(f"{'backward' if backward else 'forward'} {p.groups} groups of {p.rows} rows "
                     f"x {p.blocks} blocks x {p.units} units, {p.smem} B shared, K chunk "
                     f"{p.chunk} of {k}")
    return "; ".join(parts)


def phase_time_lstm_grid(seed: int, card: str) -> dict:
    """The grid LSTM pair device only (``time_device``) at H 512: the
    training forward and the backward at the training shape (B 64, T 70)
    and the inference forward at the export shape (B 16, T 256), each
    beside its time before row groups (EARLIER_GRID_MS), its host loop, its
    plain version, its bound and cuDNN's LSTM (fp16, H 512, with the input
    projection; only timed here), with the plan; then both directions at
    the wide widths of LSTM_WIDE_H (B 64, T 70) beside their bounds."""
    from vectorquantizedcpc_tpu_torch.ops import lstm_scan as ls

    def timed(kernel, plain, bound, by, lib, reps=20) -> dict:
        ms, host_us = time_device(kernel, reps)
        return {"ms": ms, "host_us": host_us, "host_loop_ms": time_cuda(kernel, reps),
                "plain_ms": time_cuda(plain, reps=2), "bound_ms": bound, "bound_by": by,
                "library_ms": time_cuda(lib, reps) if lib is not None else None}

    def line(name, res, batch, steps, hidden, earlier, lib_text) -> None:
        lib = ("" if res["library_ms"] is None else
               f"; cuDNN nn.LSTM ({lib_text}) {res['library_ms']:.4f} ms")
        print(f"timing {name} B={batch} T={steps} H={hidden}: kernel {res['ms']:.4f} ms device "
              f"only = {res['ms'] * 1e3 / steps:.3f} us/step (before row groups {earlier} ms by "
              f"CUDA events, {earlier / res['ms']:.2f}x; this run's host loop "
              f"{res['host_loop_ms']:.4f} ms, host {res['host_us']:.1f} us a call); plain "
              f"{res['plain_ms']:.3f} ms{lib}; bound {res['bound_ms'] * 1e3:.3f} us by "
              f"{res['bound_by']}; bound / kernel = {res['bound_ms'] / res['ms'] * 100:.3f} %  "
              f"[{card}]")

    def training_rows(batch, steps, hidden, cudnn_lib):
        args = _lstm_inputs(seed, batch, steps, hidden)
        hs, acts, c_prev, h_t, c_t = ls.lstm_scan_train(*args)
        rng = np.random.default_rng(seed + 12)
        dhs = torch.from_numpy(rng.normal(size=(steps, batch, hidden)).astype(np.float32)).to(
            DEVICE).bfloat16()
        bwd_args = (acts, c_prev, dhs, args[0], torch.zeros_like(h_t), torch.zeros_like(c_t))
        flops = 2 * batch * steps * hidden * 4 * hidden
        fwd_bound = _bound(_nbytes(*args, hs, acts, c_prev, h_t, c_t), flops, PEAK_BF16_FLOPS)
        bwd_bound = _bound(_nbytes(*bwd_args, acts, h_t, c_t), flops, PEAK_BF16_FLOPS)
        return {
            "lstm_scan_grid": (lambda: ls.lstm_scan_train(*args),
                               lambda: ls.lstm_scan_train_reference(*args), *fwd_bound,
                               cudnn_lib[0]),
            "lstm_scan_grid_bwd": (lambda: ls.lstm_scan_bwd(*bwd_args),
                                   lambda: ls.lstm_scan_bwd_reference(*bwd_args), *bwd_bound,
                                   cudnn_lib[1]),
        }

    hidden = LSTM_GRID_H[0]
    out = {}
    batch, steps = LSTM_SHAPES["training"]
    lstm_in = torch.randn(batch, steps, 64, device=DEVICE, dtype=CUDNN_DTYPE, requires_grad=True)
    cudnn = torch.nn.LSTM(64, hidden, batch_first=True).to(DEVICE, CUDNN_DTYPE)
    lib_out, _ = cudnn(lstm_in)
    lib_grad = torch.randn_like(lib_out)
    inputs = [lstm_in] + list(cudnn.parameters())
    libs = (lambda: cudnn(lstm_in),
            lambda: torch.autograd.grad(lib_out, inputs, lib_grad, retain_graph=True))
    for name, row in training_rows(batch, steps, hidden, libs).items():
        out[name] = timed(*row)
        line(name, out[name], batch, steps, hidden, EARLIER_GRID_MS[name],
             "fp16, with the input projection" + (", backward" if "bwd" in name else ""))
    print(f"plan lstm grid B={batch} H={hidden}: {_lstm_grid_plan_text(batch, hidden)}  [{card}]")
    del lib_out, inputs
    batch, steps = LSTM_SHAPES["export"]
    args = _lstm_inputs(seed, batch, steps, hidden)
    lstm_in = torch.randn(batch, steps, 64, device=DEVICE, dtype=CUDNN_DTYPE)
    n_bytes = _nbytes(*args) + steps * batch * hidden * 2 + 2 * batch * hidden * 4
    bound = _bound(n_bytes, 2 * batch * steps * hidden * 4 * hidden, PEAK_BF16_FLOPS)
    with torch.no_grad():
        res = timed(lambda: ls.lstm_scan(*args), lambda: ls.lstm_scan_reference(*args), *bound,
                    lambda: cudnn(lstm_in))
    line("lstm_scan_grid (inference)", res, batch, steps, hidden,
         EARLIER_GRID_MS["lstm_scan_grid_inference"], "fp16")
    print(f"plan lstm grid B={batch} H={hidden}: {_lstm_grid_plan_text(batch, hidden)}  [{card}]")
    out["lstm_scan_grid"]["inference_export_shape"] = res
    # The wide widths at the training shape: one row group, then K chunks.
    batch, steps = LSTM_SHAPES["training"]
    for hidden, kind in LSTM_WIDE_H.items():
        res = {name: timed(*row, reps=5)
               for name, row in training_rows(batch, steps, hidden, (None, None)).items()}
        old = EARLIER_GRID_MS["h1600"] if hidden == 1600 else None
        print(f"timing lstm_scan_grid {kind} B={batch} T={steps} H={hidden} ("
              f"{_lstm_grid_plan_text(batch, hidden)}): " + ", ".join(
                  f"{what} {r['ms']:.4f} ms device only = {r['ms'] * 1e3 / steps:.3f} us/step, "
                  f"bound {r['bound_ms'] * 1e3:.3f} us by {r['bound_by']}"
                  + (f" (before row groups {old[i]} ms)" if old else "")
                  for i, (what, r) in enumerate(zip(("training forward", "backward"),
                                                    res.values())))
              + f"  [{card}]")
        out["lstm_scan_grid"][f"h{hidden}_ms"] = res["lstm_scan_grid"]["ms"]
        out["lstm_scan_grid_bwd"][f"h{hidden}_ms"] = res["lstm_scan_grid_bwd"]["ms"]
    return out


def phase_lstm_grid_stamps(seed: int, card: str) -> dict:
    """The grid LSTM pair's split by phase at B 64, T 70, H 512, from its
    stamped variants (``lstm_scan_grid_stamped``,
    ``lstm_scan_grid_bwd_stamped``, reached from nothing but this phase),
    which must give the plain launches' bits. Returns {"forward": split,
    "backward": split}, each {block: {phase: us per step}}."""
    from vectorquantizedcpc_tpu_torch.ops import lstm_scan as ls

    hidden = LSTM_GRID_H[0]
    batch, steps = LSTM_SHAPES["training"]
    args = _lstm_inputs(seed, batch, steps, hidden)
    plain = ls.lstm_scan_train(*args)
    ls.lstm_scan_grid_stamped(*args)  # warm-up
    *got, stamps = ls.lstm_scan_grid_stamped(*args)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, plain)),
          "the stamped grid LSTM forward's outputs are not the plain launch's bits")
    out = {"forward": ls.summarize_scan_stamps(stamps.cpu().tolist(), steps, grid=True)}
    rng = np.random.default_rng(seed + 12)
    dhs = torch.from_numpy(rng.normal(size=(steps, batch, hidden)).astype(np.float32)).to(
        DEVICE).bfloat16()
    bwd_args = (plain[1], plain[2], dhs, args[0], torch.zeros_like(plain[3]),
                torch.zeros_like(plain[4]))
    plain_b = ls.lstm_scan_bwd(*bwd_args)
    ls.lstm_scan_grid_bwd_stamped(*bwd_args)
    *got_b, stamps_b = ls.lstm_scan_grid_bwd_stamped(*bwd_args)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got_b, plain_b)),
          "the stamped grid LSTM backward's outputs are not the plain launch's bits")
    out["backward"] = ls.summarize_scan_stamps(stamps_b.cpu().tolist(), steps, backward=True,
                                               grid=True)
    for kernel, split in out.items():
        check(bool(split), f"stamps LSTM grid {kernel}: no block recorded")
        for block, phases in split.items():
            print(f"stamps lstm grid {kernel} B={batch} T={steps} H={hidden} {block} (us/step "
                  f"over {steps - 1} steps): " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items())
                  + f"  [{card}]")
    return out


def phase_time_lstm(seed: int, card: str) -> dict:
    """The LSTM scan, its plain version and cuDNN's LSTM at the export and
    training shapes. cuDNN (one layer, fp16, on a (B, T, 64) input, so it
    also does the input projection that the kernel takes precomputed) is
    only timed here: the port never calls it."""
    from vectorquantizedcpc_tpu_torch.ops import lstm_scan as ls

    out = {}
    with torch.no_grad():
        for name, (batch, steps) in LSTM_SHAPES.items():
            args = _lstm_inputs(seed, batch, steps)
            lstm_in = torch.randn(batch, steps, 64, device=DEVICE, dtype=CUDNN_DTYPE)
            cudnn = torch.nn.LSTM(64, LSTM_H, batch_first=True).to(DEVICE, CUDNN_DTYPE)
            # Each input read once, each output written once: hs bf16, h_T and c_T f32.
            n_bytes = sum(x.numel() * x.element_size() for x in args)
            n_bytes += steps * batch * LSTM_H * 2 + 2 * batch * LSTM_H * 4
            flops = 2 * batch * steps * LSTM_H * 4 * LSTM_H
            ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, n_bytes / PEAK_BYTES * 1e3
            res = {
                "ms": time_cuda(lambda: ls.lstm_scan(*args), reps=20),
                "plain_ms": time_cuda(lambda: ls.lstm_scan_reference(*args), reps=2),
                "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "library_ms": time_cuda(lambda: cudnn(lstm_in), reps=20),
            }
            print(f"timing lstm_scan {name} B={batch} T={steps} H={LSTM_H}: kernel "
                  f"{res['ms']:.4f} ms = {res['ms'] * 1e3 / steps:.3f} us/step; plain "
                  f"{res['plain_ms']:.3f} ms; cuDNN nn.LSTM (fp16) {res['library_ms']:.4f} ms; "
                  f"bound {res['bound_ms'] * 1e3:.3f} us by {res['bound_by']} ({flops:.4g} FLOP, "
                  f"{n_bytes:.4g} B); bound / kernel = {res['bound_ms'] / res['ms'] * 100:.3f} %  "
                  f"[{card}]")
            out[name] = res
    return out


def phase_time_serve(serve: dict, ms_by_batch: dict, card: str) -> None:
    """Each drain of phase 4b again (every server has drained once: warm), to
    the device, beside the mix's ceiling at that many slots times the raw
    kernel rate at that many rows."""
    from vectorquantizedcpc_tpu_torch.models.vocoder import build_conditioning_frames_ragged
    from vectorquantizedcpc_tpu_torch.ops import ar_decode as ar

    requests, valid = serve["requests"], serve["valid"]
    hop = serve["vocoder"].conf.rnnms.upsampling_t
    seconds_by_slots = {}
    for slots in SERVE_SLOTS:
        server = serve["servers"][slots]
        for z, spk in requests:
            server.submit(z, spk)
        steps_before = server.stats["steps"]
        torch.cuda.synchronize()
        start = time.perf_counter()
        server.run(materialize=False)
        torch.cuda.synchronize()
        seconds = seconds_by_slots[slots] = time.perf_counter() - start
        steps = int(server.stats["steps"] - steps_before)
        rate = valid / seconds
        kernel_ms = ms_by_batch[slots]
        kernel_rate = slots * TIME_FRAMES * hop / (kernel_ms / 1e3)
        ceiling = mix_ceiling(requests, slots=slots, sf=4)
        segments_ms = steps * 4 * kernel_ms / TIME_FRAMES
        print(f"serve timing {slots} slots: {valid} valid samples in {seconds * 1e3:.3f} ms to "
              f"the device = {rate:.1f} samples/s; mix ceiling {ceiling:.4f} x B={slots} kernel "
              f"rate {kernel_rate:.1f} samples/s = {ceiling * kernel_rate:.1f} samples/s; served "
              f"/ (ceiling x kernel) = {rate / (ceiling * kernel_rate):.4f}; {steps} segments x "
              f"{4 * hop} steps at phase_time's B = {slots} step time = {segments_ms:.3f} ms = "
              f"{segments_ms / (seconds * 1e3) * 100:.3f} % of the drain  [{card}]")

    # The ragged conditioning of the same 48 requests alone (the PreNet kernels).
    vocoder = serve["vocoder"]
    mc = max(len(z) for z, _ in requests)
    zs = np.zeros((len(requests), mc), np.int64)
    for j, (z, _spk) in enumerate(requests):
        zs[j, : len(z)] = z
    zs = torch.from_numpy(zs).to(DEVICE)
    spks = torch.tensor([spk for _, spk in requests], device=DEVICE)
    n_frames = torch.tensor([2 * len(z) for z, _ in requests], device=DEVICE)
    w = ar.prep_decode_weights(vocoder)
    cond_ms = time_cuda(lambda: ar.project_cond_frames(w, build_conditioning_frames_ragged(
        vocoder, zs, spks, n_frames, use_kernel=True).float()), reps=3)
    print(f"serve timing: ragged conditioning {cond_ms:.3f} ms = "
          f"{cond_ms / (seconds_by_slots[8] * 1e3) * 100:.3f} % of the 8-slot drain  [{card}]")


def _rel_err(a: torch.Tensor, r: torch.Tensor) -> tuple:
    """(max abs difference, largest |reference|), both as floats."""
    return float((a.float() - r.float()).abs().max()), float(r.float().abs().max())


def _lstm_grads(args, device) -> list:
    """Autograd through ``LstmScan`` on ``device`` (the kernels on the card,
    the plain versions on the CPU): [dwh, dxproj, dh0, dc0] as f32 on the CPU."""
    from vectorquantizedcpc_tpu_torch.ops import lstm_scan as ls

    leaves = [a.detach().to(device).requires_grad_() for a in args]
    hs, h_t, c_t = ls.LstmScan.apply(*leaves)
    w = torch.linspace(-1, 1, hs.shape[-1], device=device)
    loss = (hs.float() * w).sum() + (h_t * w).sum() + c_t.square().sum()
    return [g.float().cpu() for g in torch.autograd.grad(loss, leaves)]


def phase_compare_train(seed: int, card: str) -> dict:
    """The LSTM scan's training pair and the CPC selection pair against their
    plain versions on the card; returns each kernel's worst max abs error."""
    from vectorquantizedcpc_tpu_torch.ops import cpc_select as cs
    from vectorquantizedcpc_tpu_torch.ops import lstm_scan as ls

    worst = {"lstm_scan_train": 0.0, "lstm_scan_bwd": 0.0, "cpc_select": 0.0, "cpc_select_bwd": 0.0}
    for name, (batch, steps) in TRAIN_LSTM_SHAPES.items():
        args = _lstm_inputs(seed, batch, steps)
        got = ls.lstm_scan_train(*args)
        torch.cuda.synchronize()
        ref = ls.lstm_scan_train_reference(*args)
        errs = [_rel_err(a, r)[0] for a, r in zip(got, ref)]
        check(max(errs) <= MAX_LSTM_ERR, f"lstm_scan_train {name}: hs, acts, c_prev, h_T, c_T "
              f"differ by {errs}")
        rng = np.random.default_rng(seed + 8)
        f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(DEVICE)
        dhs = f32(rng.normal(0, 1, size=(steps, batch, LSTM_H))).bfloat16()
        dh_t, dc_t = (f32(rng.normal(0, 1, size=(batch, LSTM_H))) for _ in range(2))
        kb = ls.lstm_scan_bwd(ref[1], ref[2], dhs, args[0], dh_t, dc_t)
        torch.cuda.synchronize()
        rb = ls.lstm_scan_bwd_reference(ref[1], ref[2], dhs, args[0], dh_t, dc_t)
        errs_b = [_rel_err(a, r) for a, r in zip(kb, rb)]
        for what, (e, m) in zip(("dgates", "dh0", "dc0"), errs_b):
            check(e <= MAX_LSTM_BWD_REL * m + 1e-3, f"lstm_scan_bwd {name}: {what} differs by {e} "
                  f"(largest {m})")
        grads = _lstm_grads(args, DEVICE)
        plain = _lstm_grads([a.cpu() for a in args], "cpu")
        errs_g = [_rel_err(a, r) for a, r in zip(grads, plain)]
        for what, (e, m) in zip(("dwh", "dxproj", "dh0", "dc0"), errs_g):
            check(e <= MAX_LSTM_GRAD_REL * m, f"LstmScan {name}: {what} differs by {e} (largest {m})")
        print(f"compare lstm_scan_train {name} B={batch} T={steps} H={LSTM_H}: hs, acts, c_prev, "
              f"h_T, c_T max abs diff {', '.join(f'{e:.3e}' for e in errs)} (bound {MAX_LSTM_ERR}); "
              f"lstm_scan_bwd dgates, dh0, dc0 {', '.join(f'{e:.3e} of {m:.3f}' for e, m in errs_b)} "
              f"(bound {MAX_LSTM_BWD_REL} x largest + 1e-3); autograd vs the plain route dwh, "
              f"dxproj, dh0, dc0 {', '.join(f'{e:.3e} of {m:.3f}' for e, m in errs_g)} (bound "
              f"{MAX_LSTM_GRAD_REL} x largest)  [{card}]")
        worst["lstm_scan_train"] = max(worst["lstm_scan_train"], *errs)
        worst["lstm_scan_bwd"] = max(worst["lstm_scan_bwd"], *(e for e, _ in errs_b))

    for name, (k, s, u, n, l, z) in SELECT_SHAPES.items():
        wc, zs, utt, seq = _select_inputs(seed, k, s, u, n, l, z)
        f_neg, f_pos = cs.cpc_select(wc, zs, utt, seq)
        rng = np.random.default_rng(seed + 10)
        d_neg = torch.from_numpy(rng.normal(size=(k, s, u, n, l)).astype(np.float32)).to(DEVICE)
        d_pos = torch.from_numpy(rng.normal(size=(k, s, u, l)).astype(np.float32)).to(DEVICE)
        d_wc, d_zs = cs.cpc_select_bwd(d_neg, d_pos, wc, zs, utt, seq)
        torch.cuda.synchronize()
        ref = cs.cpc_select_reference(wc, zs, utt, seq) + cs.cpc_select_bwd_reference(
            d_neg, d_pos, wc, zs, utt, seq)
        errs = [_rel_err(a, r) for a, r in zip((f_neg, f_pos, d_wc, d_zs), ref)]
        for what, (e, m) in zip(("f_neg", "f_pos", "d_wc", "d_zs"), errs):
            check(e <= MAX_SELECT_REL * m, f"cpc_select {name}: {what} differs by {e} (largest {m})")
        # Collisions: (v, m) = (u, l), forced on negative 0 of every other
        # anchor, and candidates equal to the positive's vector (z is drawn
        # from a codebook). Each must tie with its positive bit for bit.
        own = (utt.long()[:, None, :, :, None] == torch.arange(u, device=DEVICE)[:, None, None]) & (
            seq.long() == torch.arange(l, device=DEVICE))
        cand = zs.reshape(k, s, u * l, z)[
            torch.arange(k, device=DEVICE)[:, None, None, None, None],
            torch.arange(s, device=DEVICE)[None, :, None, None, None],
            utt.long()[:, None, :, :, None] * l + seq.long()]
        equal = (cand == zs[:, :, :, None]).all(-1)
        pos = f_pos[:, :, :, None].expand_as(f_neg)
        check(int(own.sum()) > 0 and torch.equal(f_neg[own], pos[own]),
              f"cpc_select {name}: an own-frame negative differs from its positive")
        check(torch.equal(f_neg[equal], pos[equal]),
              f"cpc_select {name}: an equal-vector negative differs from its positive")
        print(f"compare cpc_select {name} K={k} S={s} U={u} N={n} L={l} Z={z}: f_neg, f_pos, "
              f"d_wc, d_zs max abs diff {', '.join(f'{e:.3e} of {m:.3f}' for e, m in errs)} "
              f"(bound {MAX_SELECT_REL} x largest); {int(own.sum())} own-frame and "
              f"{int(equal.sum())} equal-vector negatives, all bit-equal to their positives  "
              f"[{card}]")
        # One writer per output, sums in a fixed order: repeated launches
        # give the same bits.
        for _ in range(3):
            again = cs.cpc_select(wc, zs, utt, seq) + cs.cpc_select_bwd(d_neg, d_pos, wc, zs,
                                                                         utt, seq)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(again, (f_neg, f_pos, d_wc, d_zs))),
                  f"cpc_select {name}: a repeated launch gave other bits")
        print(f"compare cpc_select {name}: 3 more launches of both kernels gave the same bits "
              f"(f_neg, f_pos, d_wc, d_zs)  [{card}]")
        worst["cpc_select"] = max(worst["cpc_select"], errs[0][0], errs[1][0])
        worst["cpc_select_bwd"] = max(worst["cpc_select_bwd"], errs[2][0], errs[3][0])
    return worst


def phase_compare_lstm_grid(seed: int, card: str) -> dict:
    """The grid LSTM kernels (ops/csrc/lstm_grid.cu) against their plain
    versions at H 512 and 37, at the export and training shapes and at B 3
    (one partial row group) and 1, and at H 1,600 (one row group) and 2,048
    (wh staged in K chunks) at a short shape: both forward variants (the
    inference one gives the training one's bits), the backward, and
    autograd through ``LstmScan`` against the plain route on the CPU; each
    plan against its mirror (``group_plan``); returns each kernel's worst
    max abs error."""
    from vectorquantizedcpc_tpu_torch.ops import lstm_scan as ls

    worst = {"lstm_scan_grid": 0.0, "lstm_scan_grid_bwd": 0.0}
    cases = [(h, {**LSTM_SHAPES, **LSTM_GRID_SMALL_B}) for h in LSTM_GRID_H]
    cases += [(h, {kind: LSTM_STREAM_SHAPE}) for h, kind in LSTM_WIDE_H.items()]
    for hidden, shapes in cases:
        check(ls.scan_route(hidden) == ls.scan_route(hidden, backward=True) == "grid",
              f"H {hidden} should take the grid kernels")
        for name, (batch, steps) in shapes.items():
            for backward in (False, True):
                plan = ls.grid_plan(batch, hidden, backward=backward)
                check(plan == ls.group_plan(batch, hidden, backward, sms=_sms()),
                      f"lstm grid H={hidden} B={batch}: the plan {plan} is not its mirror's")
            args = _lstm_inputs(seed, batch, steps, hidden)
            inf = ls.lstm_scan(*args)
            got = ls.lstm_scan_train(*args)
            torch.cuda.synchronize()
            check(all(torch.equal(a, r) for a, r in zip(inf, (got[0], got[3], got[4]))),
                  f"lstm grid H={hidden} {name}: inference and training hs, h_T, c_T differ")
            ref = ls.lstm_scan_train_reference(*args)
            errs = [_rel_err(a, r)[0] for a, r in zip(got, ref)]
            check(max(errs) <= MAX_LSTM_ERR, f"lstm grid H={hidden} {name}: {errs}")
            rng = np.random.default_rng(seed + 8)
            f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(DEVICE)
            dhs = f32(rng.normal(0, 1, size=(steps, batch, hidden))).bfloat16()
            dh_t, dc_t = (f32(rng.normal(0, 1, size=(batch, hidden))) for _ in range(2))
            kb = ls.lstm_scan_bwd(ref[1], ref[2], dhs, args[0], dh_t, dc_t)
            torch.cuda.synchronize()
            rb = ls.lstm_scan_bwd_reference(ref[1], ref[2], dhs, args[0], dh_t, dc_t)
            errs_b = [_rel_err(a, r) for a, r in zip(kb, rb)]
            for what, (e, m) in zip(("dgates", "dh0", "dc0"), errs_b):
                check(e <= MAX_LSTM_BWD_REL * m + 1e-3,
                      f"lstm grid bwd H={hidden} {name}: {what} differs by {e} (largest {m})")
            grads = _lstm_grads(args, DEVICE)
            plain = _lstm_grads([a.cpu() for a in args], "cpu")
            errs_g = [_rel_err(a, r) for a, r in zip(grads, plain)]
            for what, (e, m) in zip(("dwh", "dxproj", "dh0", "dc0"), errs_g):
                check(e <= MAX_LSTM_GRAD_REL * m,
                      f"LstmScan grid H={hidden} {name}: {what} differs by {e} (largest {m})")
            print(f"compare lstm_scan_grid {name} B={batch} T={steps} H={hidden} "
                  f"({_lstm_grid_plan_text(batch, hidden)}): hs, acts, c_prev, "
                  f"h_T, c_T max abs diff {', '.join(f'{e:.3e}' for e in errs)} (bound "
                  f"{MAX_LSTM_ERR}), inference = training bits; lstm_scan_grid_bwd dgates, dh0, dc0 "
                  f"{', '.join(f'{e:.3e} of {m:.3f}' for e, m in errs_b)} (bound {MAX_LSTM_BWD_REL} "
                  f"x largest + 1e-3); autograd vs the plain route dwh, dxproj, dh0, dc0 "
                  f"{', '.join(f'{e:.3e} of {m:.3f}' for e, m in errs_g)} (bound "
                  f"{MAX_LSTM_GRAD_REL} x largest)  [{card}]")
            worst["lstm_scan_grid"] = max(worst["lstm_scan_grid"], *errs)
            worst["lstm_scan_grid_bwd"] = max(worst["lstm_scan_grid_bwd"], *(e for e, _ in errs_b))
    return worst


def _gru_train_inputs(seed: int, steps: int, batch: int, hidden: int):
    """GRU-scan operands from ``seed``: wh at nn.GRU's init scale and bh
    (bf16 values) as the vocoder passes them, an input projection, h0."""
    rng = np.random.default_rng(seed + 13)
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(DEVICE)
    return (
        f32(rng.uniform(-1, 1, size=(hidden, 3 * hidden)) / np.sqrt(hidden)).bfloat16(),
        f32(rng.uniform(-1, 1, size=(3 * hidden,)) / np.sqrt(hidden)).bfloat16().float(),
        f32(rng.normal(0, 0.8, size=(steps, batch, 3 * hidden))).bfloat16(),
        f32(rng.uniform(-0.5, 0.5, size=(batch, hidden))),
    )


def _gru_grads(args) -> list:
    """Autograd through ``GruScan`` on the card: [dwh, dbh, dxproj, dh0]."""
    from vectorquantizedcpc_tpu_torch.ops import gru_train as g

    leaves = [a.detach().clone().requires_grad_() for a in args]
    hs, h_t = g.GruScan.apply(*leaves)
    w = torch.linspace(-1, 1, hs.shape[-1], device=DEVICE)
    loss = (hs.float() * w).sum() + (h_t * w).sum()
    return list(torch.autograd.grad(loss, leaves))


def phase_compare_gru_train(seed: int, card: str) -> dict:
    """The GRU grid kernels (training forward, backward) against their plain
    versions on the card, autograd through ``GruScan`` against the plain
    route; returns each kernel's worst max abs error."""
    from vectorquantizedcpc_tpu_torch.ops import gru_train as g

    start = time.perf_counter()
    worst = {"gru_scan_train": 0.0, "gru_scan_bwd": 0.0}
    for name, (steps, batch, hidden) in GRU_TRAIN_SHAPES.items():
        args = _gru_train_inputs(seed, steps, batch, hidden)
        got = g.gru_scan_train(*args)
        hs, h_t = g.gru_scan(*args)
        torch.cuda.synchronize()
        check(torch.equal(hs, got[0]) and torch.equal(h_t, got[3]),
              f"gru_scan_train {name}: the no-grad forward's hs, h_T are not its bits")
        ref = g.gru_scan_train_reference(*args)
        errs = [_rel_err(a, r) for a, r in zip(got, ref)]
        for what, (e, m) in zip(("hs", "acts", "hns", "h_T"), errs):
            check(e <= MAX_GRU_ERR * max(1.0, m), f"gru_scan_train {name}: {what} differs by {e} "
                  f"(largest {m})")
        rng = np.random.default_rng(seed + 14)
        f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(DEVICE)
        dhs = f32(rng.normal(0, 1, size=(steps, batch, hidden))).bfloat16()
        dh_t = f32(rng.normal(0, 1, size=(batch, hidden)))
        h_prevs = torch.cat([args[3].bfloat16()[None], ref[0][:-1]]).contiguous()
        kb = g.gru_scan_bwd(ref[1], ref[2], h_prevs, dhs, args[0], dh_t)
        torch.cuda.synchronize()
        rb = g.gru_scan_bwd_reference(ref[1], ref[2], h_prevs, dhs, args[0], dh_t)
        errs_b = [_rel_err(a, r) for a, r in zip(kb, rb)]
        for what, (e, m) in zip(("dgx", "dgh", "dh0"), errs_b):
            check(e <= MAX_LSTM_BWD_REL * m + 1e-3, f"gru_scan_bwd {name}: {what} differs by {e} "
                  f"(largest {m})")
        grads = _gru_grads(args)
        with plain_route():
            plain = _gru_grads(args)
        errs_g = [_rel_err(a, r) for a, r in zip(grads, plain)]
        for what, (e, m) in zip(("dwh", "dbh", "dxproj", "dh0"), errs_g):
            check(e <= MAX_LSTM_GRAD_REL * m, f"GruScan {name}: {what} differs by {e} (largest {m})")
        print(f"compare gru_scan_train {name} T={steps} B={batch} H={hidden}: hs, acts, hns, h_T "
              f"max abs diff {', '.join(f'{e:.3e} of {m:.3f}' for e, m in errs)} (bound "
              f"{MAX_GRU_ERR} x max(1, largest)); no-grad forward bit-identical; gru_scan_bwd "
              f"dgx, dgh, dh0 {', '.join(f'{e:.3e} of {m:.3f}' for e, m in errs_b)} (bound "
              f"{MAX_LSTM_BWD_REL} x largest + 1e-3); autograd vs the plain route dwh, dbh, "
              f"dxproj, dh0 {', '.join(f'{e:.3e} of {m:.3f}' for e, m in errs_g)} (bound "
              f"{MAX_LSTM_GRAD_REL} x largest)  [{card}]")
        worst["gru_scan_train"] = max(worst["gru_scan_train"], *(e for e, _ in errs))
        worst["gru_scan_bwd"] = max(worst["gru_scan_bwd"], *(e for e, _ in errs_b))
    print(f"phase 3 GRU grid kernels: {time.perf_counter() - start:.3f} s wall")
    return worst


def _select_inputs(seed: int, k, s, u, n, l, z):
    """Selection operands from ``seed``: wc ~ N(0, 1); z_shift drawn from a
    512-word codebook as quantized latents are; the reference sampling of
    the indices, with negative 0 of every other anchor forced onto the
    anchor's own frame."""
    rng = np.random.default_rng(seed + 9)
    codes = rng.normal(0, 0.5, size=(512, z))
    zs = codes[rng.integers(0, 512, size=(k, s, u, l))]
    utt = rng.integers(0, u, size=(k, u, n))
    seq = (rng.integers(1, l, size=(k, s, u, n, l)) + np.arange(l)) % l
    utt[:, :, 0] = np.arange(u)
    seq[:, :, :, 0, ::2] = np.arange(l)[::2]
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(DEVICE)
    i32 = lambda x: torch.from_numpy(np.asarray(x, np.int32)).to(DEVICE)
    return f32(rng.normal(size=(k, s, u, l, z))), f32(zs), i32(utt), i32(seq)


def _train_counts(reset: bool = False) -> dict:
    from vectorquantizedcpc_tpu_torch.ops import cpc_select as cs
    from vectorquantizedcpc_tpu_torch.ops import lstm_scan as ls

    if reset:
        ls.LSTM_SCAN_LAUNCHES = ls.LSTM_SCAN_TRAIN_LAUNCHES = ls.LSTM_SCAN_BWD_LAUNCHES = 0
        cs.CPC_SELECT_LAUNCHES = cs.CPC_SELECT_BWD_LAUNCHES = 0
    return {
        "lstm_scan": ls.LSTM_SCAN_LAUNCHES,
        "lstm_scan_train": ls.LSTM_SCAN_TRAIN_LAUNCHES,
        "lstm_scan_bwd": ls.LSTM_SCAN_BWD_LAUNCHES,
        "cpc_select": cs.CPC_SELECT_LAUNCHES,
        "cpc_select_bwd": cs.CPC_SELECT_BWD_LAUNCHES,
    }


def check_graph(graph, kernels, steps: int, launches: dict, what: str) -> dict:
    """A trainer's step graph after a main path of ``steps`` steps: one
    capture holding each training kernel of ``kernels`` once a step and no
    other kernel (no inference or stamped kernel), replays plus eager
    warm-up steps equal to the steps, and each wrapper's count in
    ``launches`` its warm-up launches plus the capture's."""
    captured = {k: v for k, v in graph.captured.items() if v}
    check(graph.captures == 1, f"{what}: {graph.captures} captures")
    check(captured == {k: 1 for k in kernels},
          f"{what}: captured per step {captured}, expected each of {kernels} once")
    check(graph.replays + graph.eager_steps == steps,
          f"{what}: {graph.replays} replays + {graph.eager_steps} eager steps for {steps} steps")
    for name in kernels:
        check(launches[name] == graph.eager_steps + graph.captures,
              f"{what}: {launches[name]} {name} launches counted for {graph.eager_steps} eager "
              f"steps and {graph.captures} capture")
    return {"captured_per_step": captured, "replays": graph.replays,
            "eager_steps": graph.eager_steps, "capture_s": graph.capture_s,
            "pool_bytes": graph.pool_bytes}


def _corpus_args(d: Path) -> list:
    return ["data.dataset.name=synthetic", f"data.corpus.root={d / 'corpus'}",
            f"data.dataset.adress_data_root={d / 'features'}", "data.loader.num_workers=4"]


def phase_train(seed: int, card: str, d: Path) -> dict:
    """CPC training through the preprocess and train_cpc CLIs on the card,
    at full width and bf16; the checkpoint through Encoder and the encode
    CLI. The corpus, features and checkpoints stay in ``d`` for phase 4e."""
    from vectorquantizedcpc_tpu_torch.cli import encode as encode_cli
    from vectorquantizedcpc_tpu_torch.cli import preprocess as preprocess_cli
    from vectorquantizedcpc_tpu_torch.cli import train_cpc
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.data import datasets
    from vectorquantizedcpc_tpu_torch.data.corpus import SyntheticCorpus
    from vectorquantizedcpc_tpu_torch.models.encoder import Encoder

    # The default synthetic corpus has 4 speakers, fewer than S = 8, and
    # an existing corpus on disk is read as it is: materialize this one.
    SyntheticCorpus(d / "corpus", n_speakers=TRAIN_SPEAKERS, n_utterances=TRAIN_UTTS,
                    duration_s=2.0).utterances()
    data = _corpus_args(d)
    start = time.perf_counter()
    manifest = preprocess_cli.main(data + [f"out_dir={d / 'features'}"])
    pre_s = time.perf_counter() - start
    check(len(manifest["speakers"]) == TRAIN_SPEAKERS
          and len(manifest["utterances"]) == TRAIN_SPEAKERS * TRAIN_UTTS, "preprocess manifest")
    argv = data + [f"checkpoint_dir={d / 'ckpt'}", f"training.cpc.n_epochs={TRAIN_EPOCHS}",
                   "training.cpc.checkpoint_interval=5", "training.cpc.log_interval=5",
                   f"runtime.profile_dir={d / 'prof_cpc'}", f"seed={seed}"]
    torch.cuda.synchronize()
    _train_counts(reset=True)
    batch_calls = datasets.SAMPLE_BATCH_CALLS
    start = time.perf_counter()
    log = io.StringIO()  # the CLI's output, kept to read its logged steps/s
    try:
        with contextlib.redirect_stdout(log):
            trainer = train_cpc.main(argv)
    finally:
        print(log.getvalue(), end="")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = _train_counts()
    batch_calls = datasets.SAMPLE_BATCH_CALLS - batch_calls
    steps = trainer.global_step
    check(steps == TRAIN_EPOCHS * TRAIN_SPEAKERS // 8 >= 20, f"{steps} train steps")
    graph = check_graph(trainer.graph, TRAIN_KERNELS, steps, launches, "train_cpc")
    check(launches["lstm_scan"] == 0, "the inference scan ran during training")
    traces = list((d / "prof_cpc").iterdir())
    check(len(traces) == 1, f"runtime.profile_dir holds {traces}, expected one trace")
    logged = [float(x) for x in re.findall(r"([0-9.]+) steps/s", log.getvalue())]
    check(len(logged) == TRAIN_EPOCHS // 5, f"logged steps/s {logged}")
    losses = [float(m["loss"]) for m in trainer.history]
    check(len(losses) == steps and all(np.isfinite(losses)), f"losses {losses}")
    ckpts = sorted(p.name for p in (d / "ckpt").glob("*.pt"))
    check(ckpts == ["model.ckpt-10.pt", "model.ckpt-5.pt"], f"checkpoints {ckpts}")
    ckpt = d / "ckpt" / "model.ckpt-10.pt"
    encoder = Encoder(load_conf([]).model.encoder)
    encoder.load_state_dict(torch.load(ckpt, weights_only=True)["encoder"], strict=True)
    n = encode_cli.main([f"cpc_checkpoint={ckpt}", f"in_dir={d / 'features' / 'V000'}",
                         f"out_dir={d / 'codes'}"])
    check(n == TRAIN_UTTS, f"exported {n} of {TRAIN_UTTS} mels")
    for rec in manifest["utterances"][:TRAIN_UTTS]:
        rows = np.loadtxt(d / "codes" / f"{rec['name']}.txt", ndmin=2)
        check(rows.shape == (rec["n_frames"] // 2, 64) and bool(np.isfinite(rows).all()),
              f"export of {rec['name']}: {rows.shape}")
    print(f"train: preprocess of {len(manifest['utterances'])} utterances {pre_s:.3f} s; "
          f"train_cpc CLI {steps} steps ({TRAIN_EPOCHS} epochs x {steps // TRAIN_EPOCHS}) in "
          f"{seconds:.3f} s wall = {steps / seconds:.3f} steps/s incl. set-up and first-step "
          f"warm-up; losses {losses[0]:.4f} -> {losses[-1]:.4f}, all finite; launches counted "
          f"{json.dumps(launches)}; step graph: {graph['eager_steps']} eager warm-up steps, one "
          f"capture ({graph['capture_s']:.3f} s, pool {graph['pool_bytes'] / 2**20:.1f} MiB) holding "
          f"{json.dumps(graph['captured_per_step'])} a step, {graph['replays']} replays; logged "
          f"{logged} steps/s; one trace in runtime.profile_dir; checkpoints {ckpts} load strict "
          f"into Encoder; the encode CLI exported {n} mels from model.ckpt-10.pt  [{card}]")
    return {"launches": launches, "seconds": seconds, "steps": steps, "graph": graph,
            "logged_steps_per_s": logged, "sample_batch_calls": batch_calls}


@contextlib.contextmanager
def plain_route():
    """Inside, the training slices' autograd Functions call the plain
    versions of their six kernels, on card tensors."""
    from vectorquantizedcpc_tpu_torch.ops import cpc_select as cs
    from vectorquantizedcpc_tpu_torch.ops import gru_train as g
    from vectorquantizedcpc_tpu_torch.ops import lstm_scan as ls

    saved = (ls.lstm_scan_train, ls.lstm_scan_bwd, cs.cpc_select, cs.cpc_select_bwd,
             g.gru_scan_train, g.gru_scan_bwd)
    ls.lstm_scan_train, ls.lstm_scan_bwd = ls.lstm_scan_train_reference, ls.lstm_scan_bwd_reference
    cs.cpc_select, cs.cpc_select_bwd = cs.cpc_select_reference, cs.cpc_select_bwd_reference
    g.gru_scan_train, g.gru_scan_bwd = g.gru_scan_train_reference, g.gru_scan_bwd_reference
    try:
        yield
    finally:
        (ls.lstm_scan_train, ls.lstm_scan_bwd, cs.cpc_select, cs.cpc_select_bwd,
         g.gru_scan_train, g.gru_scan_bwd) = saved


def _train_batch(seed: int, conf):
    """A batch of S x U random mels and one step's negatives, from ``seed``."""
    from vectorquantizedcpc_tpu_torch.models.cpc import sample_negative_indices

    cc = conf.model.cpc
    rng = np.random.default_rng(seed + 11)
    t = conf.data.dataset.cpc.clip_length_mel
    mels = torch.from_numpy(rng.normal(size=(cc.n_speakers_per_batch, cc.n_utterances_per_speaker,
                                             80, t)).astype(np.float32)).to(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return (mels,) + sample_negative_indices(cc, t // 2 - cc.n_prediction_steps // 2, gen)


def _loss_and_grads(trainer, mels, utt, seq):
    from vectorquantizedcpc_tpu_torch.models.cpc import cpc_apply_with_indices

    cc = trainer.conf.model.cpc
    z, c, vq_loss, _ = trainer.encoder(mels.reshape(-1, *mels.shape[2:]), trainer.compute_dtype)
    cpc_loss, _ = cpc_apply_with_indices(trainer.cpc, cc, z, c, utt, seq)
    loss = cpc_loss + vq_loss
    named = [(f"encoder.{n}", p) for n, p in trainer.encoder.named_parameters() if p.requires_grad]
    named += [(f"cpc.{n}", p) for n, p in trainer.cpc.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return float(loss.detach()), {n: g for (n, _), g in zip(named, grads)}


def phase_train_step(seed: int, card: str) -> None:
    """One bf16 train step's loss and gradients, kernels against the plain
    route on the card (same weights, batch and indices); then 30 steps on
    one batch with fixed indices must lower the loss."""
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.training.cpc import CPCTrainer

    conf = load_conf([f"seed={seed}"])
    a, b = CPCTrainer(conf, DEVICE), CPCTrainer(conf, DEVICE)
    mels, utt, seq = _train_batch(seed, conf)
    before = _train_counts()
    loss_k, grads_k = _loss_and_grads(a, mels, utt, seq)
    with plain_route():
        loss_p, grads_p = _loss_and_grads(b, mels, utt, seq)
    torch.cuda.synchronize()
    after = _train_counts()
    check(all(after[k] == before[k] + 1 for k in after if k != "lstm_scan"),
          f"kernel launches {before} -> {after}")
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    check(loss_err <= MAX_STEP_LOSS_REL, f"train step loss {loss_k} vs plain {loss_p}")
    worst_name, worst = "", 0.0
    for name, g in grads_k.items():
        e, m = _rel_err(g, grads_p[name])
        check(e <= MAX_STEP_GRAD_REL * m, f"train step gradient {name}: {e} of {m}")
        if m > 0 and e / m >= worst:
            worst_name, worst = name, e / m
    print(f"train step vs plain route: loss {loss_k:.6f} vs {loss_p:.6f} (relative {loss_err:.3e}, "
          f"bound {MAX_STEP_LOSS_REL}); {len(grads_k)} gradients, worst {worst:.3e} of the "
          f"largest element ({worst_name}; bound {MAX_STEP_GRAD_REL})  [{card}]")

    trainer = CPCTrainer(conf, DEVICE)
    losses = [float(trainer.train_step(mels, utt, seq, 1e-3)["loss"]) for _ in range(30)]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"fixed-batch losses {losses}")
    print(f"train fixed batch: 30 steps at lr 1e-3, loss {losses[0]:.4f} -> {losses[-1]:.4f}  "
          f"[{card}]")


def _voc_counts(reset: bool = False) -> dict:
    from vectorquantizedcpc_tpu_torch.ops import ar_decode as ar
    from vectorquantizedcpc_tpu_torch.ops import gru_train as g

    if reset:
        g.GRU_SCAN_LAUNCHES = g.GRU_SCAN_TRAIN_LAUNCHES = g.GRU_SCAN_BWD_LAUNCHES = 0
        ar.AR_DECODE_LAUNCHES = ar.AR_DECODE_INT8_LAUNCHES = 0
    return {
        "gru_scan_train": g.GRU_SCAN_TRAIN_LAUNCHES,
        "gru_scan_bwd": g.GRU_SCAN_BWD_LAUNCHES,
        "gru_scan": g.GRU_SCAN_LAUNCHES,
        "ar_decode": ar.AR_DECODE_LAUNCHES,
        "ar_decode_int8": ar.AR_DECODE_INT8_LAUNCHES,
    }


def phase_train_vocoder(seed: int, card: str, d: Path) -> dict:
    """Vocoder training through the train_vocoder CLI on the card at full
    width and bf16, on phase 4d's corpus, features and CPC checkpoint; the
    checkpoint through Vocoder and the convert CLI."""
    from vectorquantizedcpc_tpu_torch.cli import convert as convert_cli
    from vectorquantizedcpc_tpu_torch.cli import train_vocoder
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.data import datasets
    from vectorquantizedcpc_tpu_torch.dsp.audio_io import read_wav
    from vectorquantizedcpc_tpu_torch.models.vocoder import Vocoder
    from vectorquantizedcpc_tpu_torch.training import vocoder as train_voc_module

    cpc = d / "ckpt" / "model.ckpt-10.pt"

    def argv_for(epochs: int, precision: str = "bfloat16"):
        return _corpus_args(d) + [
            f"cpc_checkpoint={cpc}", f"training_vocoder.ckpt_log.dir_root={d / 'voc'}",
            f"training_vocoder.trainer.max_epochs={epochs}",
            f"training_vocoder.trainer.val_interval_epoch={VOC_VAL_EVERY}",
            f"training_vocoder.trainer.steps_per_dispatch={VOC_DISPATCH}",
            "training_vocoder.trainer.profiler=simple", f"seed={seed}",
            f"runtime.precision={precision}", f"runtime.profile_dir={d / f'prof_{precision}'}",
        ]

    # The validation decodes' peak memory, beside the step graph's pool.
    validate, peaks = train_voc_module.validate, []

    def measured_validate(*a, **k):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        validate(*a, **k)
        torch.cuda.synchronize()
        peaks.append((base, torch.cuda.max_memory_allocated()))

    argv = argv_for(VOC_EPOCHS)
    torch.cuda.synchronize()
    _voc_counts(reset=True)
    batch_calls = datasets.SAMPLE_BATCH_CALLS
    start = time.perf_counter()
    train_voc_module.validate = measured_validate
    log = io.StringIO()  # the CLI's output, kept to read its profiler report
    try:
        with contextlib.redirect_stdout(log):
            trainer = train_vocoder.main(argv)
    finally:
        train_voc_module.validate = validate
        print(log.getvalue(), end="")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = _voc_counts()
    batch_calls = datasets.SAMPLE_BATCH_CALLS - batch_calls
    report = {name: (float(total), float(mean), int(n)) for name, total, mean, n in re.findall(
        r"(data_wait|train_dispatch)\s+([0-9.]+)\s+([0-9.]+)\s+([0-9]+)", log.getvalue())}
    check(sorted(report) == ["data_wait", "train_dispatch"], f"profiler report {report}")
    steps = trainer.step
    per_epoch = (TRAIN_SPEAKERS * TRAIN_UTTS - 3) // VOC_B
    check(steps == VOC_EPOCHS * per_epoch == 12, f"{steps} vocoder train steps")
    graph = check_graph(trainer.graph, VOC_KERNELS, steps, launches, "train_vocoder")
    check(launches["gru_scan"] == 0, "the no-grad GRU scan ran during training")
    traces = list((d / "prof_bfloat16").iterdir())
    check(len(traces) == 1, f"runtime.profile_dir holds {traces}, expected one trace")
    check(len(peaks) == VOC_EPOCHS // VOC_VAL_EVERY, f"{len(peaks)} validations")
    n_decodes = VOC_EPOCHS // VOC_VAL_EVERY * 3 * 2  # 3 utterances, reconstructed and converted
    check(launches["ar_decode"] == n_decodes and launches["ar_decode_int8"] == 0,
          f"{launches} AR decode launches in validation, expected {n_decodes} bf16")
    losses = list(trainer.history)
    check(len(losses) == steps and all(np.isfinite(losses)), f"vocoder losses {losses}")
    ckpt_dir = d / "voc" / "default" / "version_-1" / "checkpoints"
    final = ckpt_dir / f"model.ckpt-{steps}.pt"
    check(final.exists(), f"no {final.name} in {sorted(p.name for p in ckpt_dir.iterdir())}")
    wavs = sorted((ckpt_dir.parent / "samples").glob("*.wav"))
    for step in range(VOC_VAL_EVERY, VOC_EPOCHS + 1, VOC_VAL_EVERY):
        got = [w for w in wavs if w.name.endswith(f"_step{step * per_epoch}.wav")]
        check(len(got) >= 2, f"validation wavs at step {step * per_epoch}: {got}")
    for w in wavs:
        wave, _ = read_wav(w)
        check(wave.size > 0 and bool(np.isfinite(wave).all()) and float(np.abs(wave).max()) <= 1.0,
              f"validation wav {w.name}")
    vocoder = Vocoder(load_conf([]).training_vocoder.model.network)
    vocoder.load_state_dict(torch.load(final, weights_only=True)["vocoder"], strict=True)

    speakers = sorted(p.name for p in (d / "corpus").iterdir() if p.is_dir())
    (d / "vc_in").mkdir()
    (d / "vc_in" / "speakers.json").write_text(json.dumps(speakers))
    entries = [[f"../corpus/{speakers[i]}/{speakers[i]}_0001", speakers[(i + 5) % len(speakers)],
                f"vc{i}"] for i in range(2)]
    (d / "vc_list.json").write_text(json.dumps(entries))
    n = convert_cli.main([f"cpc_checkpoint={cpc}", f"vocoder_checkpoint={final}",
                          f"in_dir={d / 'vc_in'}", f"out_dir={d / 'vc_out'}",
                          f"synthesis_list={d / 'vc_list.json'}"])
    check(n == 2, f"converted {n} of 2 utterances")
    for i in range(2):
        wave, _ = read_wav(d / "vc_out" / f"vc{i}.wav")
        check(wave.size > 0 and bool(np.isfinite(wave).all()) and float(np.abs(wave).max()) <= 1.0,
              f"converted vc{i}")
    print(f"train vocoder: train_vocoder CLI {steps} steps ({VOC_EPOCHS} epochs x {per_epoch}, "
          f"B {VOC_B} x {VOC_T} samples, bf16) with validation every {VOC_VAL_EVERY} epochs in "
          f"{seconds:.3f} s wall incl. set-up, validation and the final save; losses "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, all finite; launches counted "
          f"{json.dumps(launches)}; step graph in groups of {VOC_DISPATCH}: "
          f"{graph['eager_steps']} eager warm-up steps, one capture ({graph['capture_s']:.3f} s) "
          f"holding {json.dumps(graph['captured_per_step'])} a step, {graph['replays']} replays; "
          f"one trace in runtime.profile_dir; {len(wavs)} validation wavs in [-1, 1]; "
          f"{final.name} loads strict into Vocoder and the convert CLI converted {n} utterances "
          f"with it  [{card}]")
    base, peak = max(peaks, key=lambda p: p[1])
    print(f"train vocoder memory: the step graph's pool {graph['pool_bytes'] / 2**30:.3f} GiB, "
          f"held for the run; the validation decodes' peak {peak / 2**30:.3f} GiB allocated "
          f"({(peak - base) / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB held when they "
          f"start)  [{card}]")

    # runtime.precision=int8: the CLI resumes from the checkpoint, trains
    # VOC_VAL_EVERY more epochs (in bf16) and validates through the int8 kernel.
    torch.cuda.synchronize()
    _voc_counts(reset=True)
    again = train_vocoder.main(argv_for(VOC_EPOCHS + VOC_VAL_EVERY, "int8"))
    torch.cuda.synchronize()
    launches_int8 = _voc_counts()
    last = (VOC_EPOCHS + VOC_VAL_EVERY) * per_epoch
    check(again.step == last, f"{again.step} steps after the int8 resume, expected {last}")
    check_graph(again.graph, VOC_KERNELS, last - steps, launches_int8, "train_vocoder resumed")
    check(launches_int8["ar_decode_int8"] == 6 and launches_int8["ar_decode"] == 0,
          f"{launches_int8}: int8 validation should launch the int8 kernel 6 times, bf16 none")
    got = [w for w in (ckpt_dir.parent / "samples").glob(f"*_step{last}.wav")]
    # Names are per speaker: utterances of one speaker write one file.
    check(len(got) >= 2, f"int8 validation wavs at step {last}: {got}")
    for w in got:
        wave, _ = read_wav(w)
        check(wave.size > 0 and bool(np.isfinite(wave).all()) and float(np.abs(wave).max()) <= 1.0,
              f"int8 validation wav {w.name}")
    print(f"train vocoder runtime.precision=int8: resumed to step {last}, validation wrote "
          f"{len(got)} wavs in [-1, 1]; launches {json.dumps(launches_int8)}  [{card}]")
    return {"launches": launches, "launches_int8": launches_int8, "seconds": seconds,
            "steps": steps, "graph": graph, "validation_peak_bytes": peak,
            "sample_batch_calls": batch_calls, "profiler_report": report}


DATA_PLANE_BATCHES = 21  # phase 4p: batches assembled each way per dataset
EXAMPLE_EPOCHS = 2  # phase 4p: examples/full_pipeline_torch.py --epochs
EXAMPLE_LIMIT_S = 300


def _assembly_ms(ds, batch: int, seed: int, n: int) -> dict:
    """``n`` batches of ``ds`` in the loader's order, epoch after epoch, each
    assembled by ``sample_batch`` and by the per-item stack in turns (which
    goes first alternates); both the same bits. Host ms per batch each way."""
    from vectorquantizedcpc_tpu_torch.data.loader import PrefetchLoader, stack_items

    loader = PrefetchLoader(ds, batch_size=batch, seed=seed)
    ms = {"sample_batch": [], "per_item": []}
    epoch = 0
    while len(ms["per_item"]) < n:
        epoch += 1
        loader.set_epoch(epoch)
        order = loader._order()
        for b in range(min(len(loader), n - len(ms["per_item"]))):
            idx = order[b * batch : (b + 1) * batch]
            got = {}
            for way in (("sample_batch", "per_item") if len(ms["per_item"]) % 2 == 0 else
                        ("per_item", "sample_batch")):
                start = time.perf_counter()
                got[way] = ds.sample_batch(idx) if way == "sample_batch" else stack_items(ds, idx)
                ms[way].append((time.perf_counter() - start) * 1e3)
            for x, y in zip(got["sample_batch"], got["per_item"]):
                check(x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y),
                      f"sample_batch of epoch {epoch} batch {b}: not the per-item bits")
    return {way: {"ms": float(np.median(v)), "spread_ms": max(v) - min(v), "runs_ms": v}
            for way, v in ms.items()}


def phase_data_plane(seed: int, card: str, d: Path, trained: dict, trained_voc: dict) -> dict:
    """The native clip engine (``data/native.py``) on phase 4d's features:
    a build with this machine's g++, ``sample_batch`` of both datasets at
    their default batch shapes against the per-item stack (the same bits,
    host ms per batch each way), the engine's batches counted in phases 4d
    and 4e, the train_cpc CLI's logged steps/s with each assembly, then
    ``examples/full_pipeline_torch.py`` on the card."""
    from vectorquantizedcpc_tpu_torch.cli import train_cpc
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.data import datasets, native
    from vectorquantizedcpc_tpu_torch.data.datamodule import VocoderDataModule
    from vectorquantizedcpc_tpu_torch.data.loader import PrefetchLoader, stack_items
    from vectorquantizedcpc_tpu_torch.dsp.audio_io import read_wav

    gpp = subprocess.run(["g++", "--version"], capture_output=True, text=True).stdout
    in_use, native.BUILD_DIR = native.BUILD_DIR, d / "host_native"
    try:
        start = time.perf_counter()
        fresh = native.build()
        build_s = time.perf_counter() - start
    finally:
        native.BUILD_DIR = in_use
    check(fresh.name == native.build().name, f"engine builds {fresh.name} and {native.build()}")
    for what, res in (("train_cpc (4d)", trained), ("train_vocoder (4e)", trained_voc)):
        check(res["sample_batch_calls"] == res["steps"] > 0,
              f"{what}: {res['sample_batch_calls']} batches through sample_batch in "
              f"{res['steps']} steps")

    conf = load_conf([])
    cpc = datasets.CPCMelSpkDataset(True, conf.data.dataset, d / "features", seed=seed)
    dm = VocoderDataModule(conf.data, data_dir=d / "features", seed=seed)
    dm.setup()
    s, b = conf.training.cpc.n_speakers_per_batch, conf.data.loader.batch_size
    clip, hop = conf.data.dataset.clip_length_mel, conf.data.dataset.mel_stft_stride
    shapes = {"CPC": ([(s, conf.training.cpc.n_utterances_per_speaker, 80,
                        conf.data.dataset.cpc.clip_length_mel), (s,)], cpc, s),
              "vocoder": ([(b, clip * hop + 1), (b, 80, clip), (b,)], dm._train, b)}
    out = {"build_s": build_s}
    for what, (want, ds, batch) in shapes.items():
        got = ds.sample_batch(np.arange(batch))
        check([x.shape for x in got] == want, f"{what} sample_batch shapes "
              f"{[x.shape for x in got]}, expected {want}")
        out[what] = times = _assembly_ms(ds, batch, seed, DATA_PLANE_BATCHES)
        mb = sum(x.nbytes for x in got) / 2**20
        print(f"data plane {what}: batch {' + '.join(str(tuple(x.shape)) for x in got)} "
              f"({mb:.2f} MiB), {DATA_PLANE_BATCHES} batches each way, the same bits: "
              f"sample_batch {times['sample_batch']['ms']:.3f} ms per batch (spread "
              f"{times['sample_batch']['spread_ms']:.3f}), per-item stack "
              f"{times['per_item']['ms']:.3f} ms (spread {times['per_item']['spread_ms']:.3f}), "
              f"{times['per_item']['ms'] / times['sample_batch']['ms']:.2f}x  [{card}]")
    print(f"data plane: engine {fresh.name} built in {build_s:.3f} s by {gpp.splitlines()[0]}; "
          f"sample_batch assembled {trained['sample_batch_calls']} of 4d's {trained['steps']} "
          f"and {trained_voc['sample_batch_calls']} of 4e's {trained_voc['steps']} batches  "
          f"[{card}]")

    # The train_cpc CLI at 4d's arguments (no trace), its loader assembling
    # per item and by sample_batch in turns: the steady logged steps/s
    # (epochs 6-10) each way.
    argv = _corpus_args(d) + [f"training.cpc.n_epochs={TRAIN_EPOCHS}", "training.cpc.log_interval=5",
                              f"training.cpc.checkpoint_interval={TRAIN_EPOCHS}", f"seed={seed}"]
    batched = PrefetchLoader._assemble
    logged = {"per_item": [], "sample_batch": []}
    for i, way in enumerate(("per_item", "sample_batch", "sample_batch", "per_item")):
        PrefetchLoader._assemble = (batched if way == "sample_batch" else
                                    lambda self, idx: stack_items(self.dataset, idx))
        log = io.StringIO()
        try:
            with contextlib.redirect_stdout(log):
                train_cpc.main(argv + [f"checkpoint_dir={d / f'ckpt_cli_{i}'}"])
        finally:
            PrefetchLoader._assemble = batched
        rates = [float(x) for x in re.findall(r"([0-9.]+) steps/s", log.getvalue())]
        check(len(rates) == TRAIN_EPOCHS // 5, f"train_cpc CLI logged {rates}")
        logged[way].append(rates[-1])
    out["cpc_cli_steps_per_s"] = logged
    print(f"data plane: train_cpc CLI (4d's arguments, no trace), steady logged steps/s (epochs "
          f"6-10) in turns: per-item assembly {logged['per_item']}, sample_batch "
          f"{logged['sample_batch']}  [{card}]")

    ws = d / "example"
    start = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve().parent / "examples" /
                                               "full_pipeline_torch.py"),
                           "--epochs", str(EXAMPLE_EPOCHS), "--workdir", str(ws)],
                          capture_output=True, text=True, timeout=EXAMPLE_LIMIT_S)
    example_s = time.perf_counter() - start
    if proc.returncode != 0:
        print(proc.stdout[-6000:], proc.stderr[-6000:], sep="\n")
    check(proc.returncode == 0, f"examples/full_pipeline_torch.py exited {proc.returncode}")
    wav = ws / "converted" / "demo_vc.wav"
    check(wav.exists(), f"the example wrote no {wav.name}")
    wave, _ = read_wav(wav)
    check(wave.size > 0 and bool(np.isfinite(wave).all()) and float(np.abs(wave).max()) <= 1.0,
          f"the example's {wav.name}")
    n_codes = len(list((ws / "codes").glob("*.txt")))
    print(f"data plane: examples/full_pipeline_torch.py --epochs {EXAMPLE_EPOCHS} on the card in "
          f"{example_s:.3f} s wall (5 CLI processes): {n_codes} code files, {wav.name} "
          f"{wave.size} samples, finite, in [-1, 1]  [{card}]")
    out["example_s"] = example_s
    return out


def _grid_counts(reset: bool = False) -> dict:
    from vectorquantizedcpc_tpu_torch.ops import ar_decode as ar
    from vectorquantizedcpc_tpu_torch.ops import gru_train as g
    from vectorquantizedcpc_tpu_torch.ops import lstm_scan as ls

    if reset:
        ls.LSTM_SCAN_GRID_LAUNCHES = ls.LSTM_SCAN_GRID_TRAIN_LAUNCHES = 0
        ls.LSTM_SCAN_GRID_BWD_LAUNCHES = 0
        g.GRU_SCAN_MASKED_GRID_LAUNCHES = 0
        _train_counts(reset=True)
        _voc_counts(reset=True)
        g.GRU_SCAN_MASKED_LAUNCHES = 0
    return {
        "lstm_scan_grid": ls.LSTM_SCAN_GRID_LAUNCHES,
        "lstm_scan_grid_train": ls.LSTM_SCAN_GRID_TRAIN_LAUNCHES,
        "lstm_scan_grid_bwd": ls.LSTM_SCAN_GRID_BWD_LAUNCHES,
        "gru_scan_masked_grid": g.GRU_SCAN_MASKED_GRID_LAUNCHES,
        "gru_scan_masked": g.GRU_SCAN_MASKED_LAUNCHES,
        "ar_decode": ar.AR_DECODE_LAUNCHES,
        **{k: v for k, v in _train_counts().items()},
        "gru_scan": g.GRU_SCAN_LAUNCHES,
    }


def phase_wide(seed: int, card: str, d: Path) -> dict:
    """The grid kernels on the main paths, at widths the cluster and
    one-block kernels cannot hold: train_cpc and the encode CLI at
    dim_cpc_context=512 on phase 4d's corpus (the grid LSTM forward, both
    variants, and backward), and a server whose PreNet is 256 wide per
    direction (dim_voc_latent=512: the masked grid forward). Counts zeroed
    just before each path and read just after."""
    from vectorquantizedcpc_tpu_torch.cli import encode as encode_cli
    from vectorquantizedcpc_tpu_torch.cli import train_cpc
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.infer.serving import ContinuousBatcher
    from vectorquantizedcpc_tpu_torch.models.vocoder import Vocoder

    wide = ["dim_cpc_context=512"]
    argv = _corpus_args(d) + wide + [
        f"checkpoint_dir={d / 'ckpt512'}", "training.cpc.n_epochs=2",
        "training.cpc.checkpoint_interval=2", "training.cpc.log_interval=2", f"seed={seed}"]
    torch.cuda.synchronize()
    _grid_counts(reset=True)
    start = time.perf_counter()
    trainer = train_cpc.main(argv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - start
    counts = _grid_counts()
    steps = trainer.global_step
    check(steps == 2 * TRAIN_SPEAKERS // 8, f"{steps} train steps at dim_cpc_context=512")
    graph = check_graph(trainer.graph, ("lstm_scan_grid_train", "lstm_scan_grid_bwd", "cpc_select",
                                        "cpc_select_bwd"), steps, counts, "train_cpc at 512")
    check(counts["lstm_scan_train"] == counts["lstm_scan_bwd"] == counts["lstm_scan"] == 0
          and counts["lstm_scan_grid"] == 0, f"the cluster or inference kernels ran: {counts}")
    losses = [float(m["loss"]) for m in trainer.history]
    check(len(losses) == steps and all(np.isfinite(losses)), f"losses {losses}")
    train_counts = counts

    mels = sorted((d / "features" / "V000").glob("*.mel.npy"))
    frames = [np.load(m).shape[1] for m in mels]
    buckets = {}
    for n in frames:
        padded = max(64, -(-n // 64) * 64)
        buckets[padded] = buckets.get(padded, 0) + 1
    n_batches = sum(-(-k // 16) for k in buckets.values())
    _grid_counts(reset=True)
    n = encode_cli.main(wide + [f"cpc_checkpoint={d / 'ckpt512' / 'model.ckpt-2.pt'}",
                                f"in_dir={d / 'features' / 'V000'}", f"out_dir={d / 'codes512'}"])
    torch.cuda.synchronize()
    counts = _grid_counts()
    check(n == len(mels) and counts["lstm_scan_grid"] == n_batches and counts["lstm_scan"] == 0,
          f"export at 512: {n} mels, launches {counts} for {n_batches} batches")
    for m, n_frames in zip(mels, frames):
        rows = np.loadtxt(d / "codes512" / f"{m.name[:-len('.mel.npy')]}.txt", ndmin=2)
        check(rows.shape == (n_frames // 2, 64) and bool(np.isfinite(rows).all()),
              f"export at 512 of {m.name}: {rows.shape}")
    export_counts = counts
    print(f"wide: train_cpc CLI at dim_cpc_context=512 {steps} steps in {train_s:.3f} s wall, "
          f"losses {losses[0]:.4f} -> {losses[-1]:.4f}, launches counted "
          f"{json.dumps(train_counts)}, the step graph holding "
          f"{json.dumps(graph['captured_per_step'])} a step ({graph['eager_steps']} eager warm-up "
          f"steps, {graph['replays']} replays); the "
          f"encode CLI exported {n} mels in {n_batches} batches, launches "
          f"{json.dumps(export_counts)}  [{card}]")

    net = load_conf(["training_vocoder.model.network.rnnms.dim_voc_latent=512"]
                    ).training_vocoder.model.network
    vocoder = Vocoder(net)
    randomize(vocoder, np.random.default_rng(seed + 18))
    rng = np.random.default_rng(seed + 19)
    requests = [(rng.integers(0, net.size_i_codebook, size=int(rng.choice(MIX_CODES))),
                 int(rng.integers(0, net.n_speakers))) for _ in range(8)]
    srv = ContinuousBatcher(vocoder.to(DEVICE).eval(), slots=8, segment_frames=4,
                            max_frames=2 * max(MIX_CODES) + 32, seed=seed, device=DEVICE)
    torch.cuda.synchronize()
    _grid_counts(reset=True)
    rids = [srv.submit(z, spk) for z, spk in requests]
    waves = srv.run()
    counts = _grid_counts()
    hop = net.rnnms.upsampling_t
    for (z, _spk), rid in zip(requests, rids):
        wave = waves[rid]
        check(wave.shape == (2 * len(z) * hop,) and bool(np.isfinite(wave).all())
              and float(np.abs(wave).max()) <= 1.0, f"wide server wave {wave.shape}")
    check(counts["gru_scan_masked_grid"] == 2 and counts["gru_scan_masked"] == 0
          and counts["gru_scan"] == 2 and counts["ar_decode"] == srv.stats["steps"] > 0,
          f"wide server launches {counts}")
    print(f"wide: served 8 requests with a PreNet of {net.rnnms.dim_voc_latent // 2} per "
          f"direction, launches {json.dumps(counts)}  [{card}]")
    return {"train": train_counts, "export": export_counts, "serve": counts, "graph": graph}


def _voc_trainer(seed: int, conf, group=None, model=None):
    """A vocoder trainer at ``conf``'s widths beside a random encoder from
    ``seed`` (a rank of the data ``group`` and ``model`` group, if given)."""
    from vectorquantizedcpc_tpu_torch.models.encoder import Encoder
    from vectorquantizedcpc_tpu_torch.training.vocoder import VocoderTrainer

    encoder = Encoder(conf.model.encoder)
    randomize(encoder, np.random.default_rng(seed + 15))
    return VocoderTrainer(conf, encoder, DEVICE, group, model)


def _voc_batch(seed: int, conf):
    """B 32 random clips of 32 mel frames: audio classes, mels, speakers."""
    rng = np.random.default_rng(seed + 16)
    frames, hop = conf.data.dataset.clip_length_mel, conf.data.dataset.mel_stft_stride
    to = lambda x: torch.from_numpy(x).to(DEVICE)
    return (to(rng.integers(0, 256, size=(VOC_B, frames * hop + 1)).astype(np.int32)),
            to(rng.normal(size=(VOC_B, 80, frames)).astype(np.float32)),
            to(rng.integers(0, TRAIN_SPEAKERS, size=VOC_B).astype(np.int32)))


def phase_train_vocoder_step(seed: int, card: str) -> None:
    """One bf16 vocoder train step's loss and gradients, kernels against the
    plain route on the card (same weights and batch); then 10 steps on one
    batch must lower the loss."""
    from vectorquantizedcpc_tpu_torch.configs import load_conf

    start = time.perf_counter()
    conf = load_conf([f"seed={seed}"])
    batch = _voc_batch(seed, conf)
    results = []
    before = _voc_counts()
    for plain in (False, True):
        trainer = _voc_trainer(seed, conf)
        with plain_route() if plain else contextlib.nullcontext():
            loss = trainer.loss(*batch)
            named = list(trainer.vocoder.named_parameters())
            grads = torch.autograd.grad(loss, [p for _, p in named])
        results.append((float(loss.detach()), {n: gr for (n, _), gr in zip(named, grads)}))
    torch.cuda.synchronize()
    after = _voc_counts()
    check(all(after[k] == before[k] + 1 for k in ("gru_scan_train", "gru_scan_bwd")),
          f"kernel launches {before} -> {after}")
    (loss_k, grads_k), (loss_p, grads_p) = results
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    check(loss_err <= MAX_STEP_LOSS_REL, f"vocoder step loss {loss_k} vs plain {loss_p}")
    worst_name, worst = "", 0.0
    for name, gr in grads_k.items():
        e, m = _rel_err(gr, grads_p[name])
        check(e <= MAX_STEP_GRAD_REL * m, f"vocoder step gradient {name}: {e} of {m}")
        if m > 0 and e / m >= worst:
            worst_name, worst = name, e / m
    print(f"train vocoder step vs plain route: loss {loss_k:.6f} vs {loss_p:.6f} (relative "
          f"{loss_err:.3e}, bound {MAX_STEP_LOSS_REL}); {len(grads_k)} gradients, worst "
          f"{worst:.3e} of the largest element ({worst_name}; bound {MAX_STEP_GRAD_REL})  [{card}]")

    trainer = _voc_trainer(seed, conf)
    lr = conf.training_vocoder.model.optim.learning_rate
    losses = [float(trainer.train_step(*batch, lr)["loss"]) for _ in range(10)]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"fixed-batch losses {losses}")
    print(f"train vocoder fixed batch: 10 steps at lr {lr:g}, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; phase wall {time.perf_counter() - start:.3f} s  [{card}]")


def _train_state(trainer, modules: dict) -> dict:
    """Every weight, buffer and Adam state tensor of a trainer, by name, the
    shards of a tensor-parallel rank gathered over its model group."""
    from vectorquantizedcpc_tpu_torch.parallel.tensor import (gather_module_state,
                                                              gather_optimizer_state)

    model = getattr(trainer, "model", None)
    out, names = {}, {}
    for prefix, module in modules.items():
        out.update({f"{prefix}.{k}": v for k, v in gather_module_state(module, model).items()})
        names.update({id(p): f"{prefix}.{k}" for k, p in module.named_parameters()})
    params = [p for g in trainer.optimizer.param_groups for p in g["params"]]
    for i, st in gather_optimizer_state(trainer.optimizer, model)["state"].items():
        out.update({f"adam.{names[id(params[i])]}.{k}": v for k, v in st.items()
                    if isinstance(v, torch.Tensor)})
    return out


def _own_tensors(trainer, modules: dict) -> tuple:
    """A rank's own weights, buffers and Adam moments: the replicated ones
    by name (copied to the host), the names of the shards, and the bytes of
    all of them."""
    from vectorquantizedcpc_tpu_torch.parallel.tensor import model_dim

    replicated, sharded, nbytes, names = {}, [], 0, {}
    for prefix, module in modules.items():
        for k, t in module.state_dict(keep_vars=True).items():
            names[id(t)] = f"{prefix}.{k}"
            nbytes += t.numel() * t.element_size()
            if model_dim(t) is None:
                replicated[f"{prefix}.{k}"] = t.detach().cpu()
            else:
                sharded.append(f"{prefix}.{k}")
    for p, st in trainer.optimizer.state.items():
        for k in ("exp_avg", "exp_avg_sq"):
            nbytes += st[k].numel() * st[k].element_size()
            key = f"adam.{names[id(p)]}.{k}"
            if model_dim(p) is None:
                replicated[key] = st[k].cpu()
            else:
                sharded.append(key)
    return replicated, sharded, nbytes


def _bit_diffs(a: dict, b: dict) -> dict:
    """Name -> max abs difference of the tensors whose bits differ."""
    return {k: float((a[k].float() - b[k].float()).abs().max())
            for k in a if not torch.equal(a[k], b[k])}


def _graph_against_eager(what: str, make, eager_run, graph_run, modules, lrs, card) -> None:
    """Three trainers from ``make()`` (the same weights): two run the
    batches eagerly, one through the step graph. The two eager runs must
    give the same bits (the step is deterministic) and the graph the eager
    bits: losses, weights, buffers, Adam's state."""
    runs = [make() for _ in range(3)]
    losses = [eager_run(runs[0]), eager_run(runs[1]), graph_run(runs[2])]
    torch.cuda.synchronize()
    states = [_train_state(tr, modules(tr)) for tr in runs]
    for other, label in ((1, "a second eager run"), (2, "the graph")):
        diffs = _bit_diffs(states[0], states[other])
        if not torch.equal(losses[0], losses[other]):
            diffs["loss"] = float((losses[0] - losses[other]).abs().max())
        check(not diffs, f"graph vs eager {what}: {label} differs from the eager run: "
                         f"{dict(list(diffs.items())[:6])}")
    graph = runs[2].graph
    print(f"graph vs eager {what}: {len(lrs)} steps, losses, weights, buffers and Adam's state "
          f"the same bits ({len(states[0])} tensors) in two eager runs and the graph; "
          f"{graph.eager_steps} eager warm-up steps, {graph.replays} replays  [{card}]")


def phase_graph_vs_eager(seed: int, card: str) -> None:
    """Phase 4g: the step graph against the eager step on the card, from
    the same weights on the same batches, negatives and learning rates:
    GRAPH_CPC_STEPS CPC steps and GRAPH_VOC_STEPS vocoder steps at B 32 x
    5,120 samples; then the card's Adam (capturable, fused) against the
    plain Adam on one step."""
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.models.cpc import sample_negative_indices
    from vectorquantizedcpc_tpu_torch.training.cpc import CPCTrainer

    start = time.perf_counter()
    conf = load_conf([f"seed={seed}"])
    cc = conf.model.cpc
    t = conf.data.dataset.cpc.clip_length_mel
    rng = np.random.default_rng(seed + 20)
    n = GRAPH_CPC_STEPS
    mels = torch.from_numpy(rng.normal(size=(n, cc.n_speakers_per_batch,
                                             cc.n_utterances_per_speaker, 80, t)).astype(
        np.float32)).to(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 20)
    negs = [sample_negative_indices(cc, t // 2 - cc.n_prediction_steps // 2, gen)
            for _ in range(n)]
    stacked = (torch.stack([u for u, _ in negs]), torch.stack([q for _, q in negs]))
    lrs = [4e-4 * (i + 1) / n for i in range(n)]
    _graph_against_eager(
        "CPC", lambda: CPCTrainer(conf, DEVICE),
        lambda tr: torch.stack([tr.train_step(mels[i], *negs[i], lrs[i])["loss"]
                                for i in range(n)]),
        lambda tr: tr.train_steps(mels, stacked, lrs)["loss"],
        lambda tr: {"encoder": tr.encoder, "cpc": tr.cpc}, lrs, card)

    k = GRAPH_VOC_STEPS
    batches = [_voc_batch(seed + i, conf) for i in range(k)]
    audio, vmels, spk = (torch.stack([b[j] for b in batches]) for j in range(3))
    vlrs = [conf.training_vocoder.model.optim.learning_rate] * k
    _graph_against_eager(
        "vocoder", lambda: _voc_trainer(seed, conf),
        lambda tr: torch.stack([tr.train_step(audio[i], vmels[i], spk[i], vlrs[i])["loss"]
                                for i in range(k)]),
        lambda tr: tr.train_steps(audio, vmels, spk, vlrs)["loss"],
        lambda tr: {"vocoder": tr.vocoder}, vlrs, card)

    # The card's Adam (capturable and fused: the device's own step count,
    # bias corrections in double) against the plain one (the host's), one
    # step from the same gradients; the capturable multi-tensor form beside
    # it, printed only.
    def one_step(optimizer=None):
        tr = CPCTrainer(conf, DEVICE)
        if optimizer is not None:
            tr.optimizer = optimizer(tr.optimizer.param_groups[0]["params"])
        tr.train_step(mels[0], *negs[0], 1e-3)
        return {k: v for k, v in _train_state(tr, {"encoder": tr.encoder, "cpc": tr.cpc}).items()
                if not k.startswith("adam.") and v.is_floating_point()}

    plain = one_step(lambda ps: torch.optim.Adam(ps, lr=0.0, betas=(0.9, 0.999), eps=1e-8))
    worst = {}
    for label, optimizer in (("capturable fused", None), ("capturable multi-tensor", lambda ps: (
            torch.optim.Adam(ps, lr=torch.zeros((), device=DEVICE), betas=(0.9, 0.999),
                             eps=1e-8, capturable=True)))):
        worst[label] = ("", 0.0)
        for name, a in one_step(optimizer).items():
            e, m = _rel_err(a, plain[name])
            if label == "capturable fused":
                check(e <= MAX_ADAM_REL * m, f"{label} Adam vs plain Adam, {name}: {e} of {m}")
            if m > 0 and e / m >= worst[label][1]:
                worst[label] = (name, e / m)
    (fused_name, fused), (multi_name, multi) = worst["capturable fused"], worst[
        "capturable multi-tensor"]
    print(f"Adam on the card vs plain Adam, one CPC step at lr 1e-3, the worst weight's error "
          f"over its largest element: capturable fused (the trainers') {fused:.3e} ({fused_name}; "
          f"bound {MAX_ADAM_REL}); capturable multi-tensor {multi:.3e} ({multi_name}; not used); "
          f"phase 4g wall {time.perf_counter() - start:.3f} s  [{card}]")


FIXTURES = Path(__file__).resolve().parent / "tests" / "fixtures" / "jax_ckpt"
FIXTURE_RUN = Path("default") / "version_-1" / "checkpoints"
CKPT_SAVES = 3  # saves of each kind a median is taken over (phase 4h)
CKPT_WALL_STEPS = {"cpc": 20, "vocoder": 3}  # steps timed with and without a save in flight


def _reset_counts() -> None:
    """Every kernel wrapper's launch counter to 0."""
    import importlib

    from vectorquantizedcpc_tpu_torch.training.step_graph import COUNTED_MODULES

    for name in COUNTED_MODULES:
        module = importlib.import_module(f"vectorquantizedcpc_tpu_torch.ops.{name}")
        for attr in list(vars(module)):
            if attr.endswith("_LAUNCHES"):
                setattr(module, attr, 0)


def _nonzero_counts() -> dict:
    from vectorquantizedcpc_tpu_torch.training.step_graph import launch_counts

    return {k: v for k, v in launch_counts().items() if v}


def _check_bits(what: str, got: dict, want: dict) -> int:
    """Every tensor of ``got`` (on the card) equals ``want`` (CPU) bit for bit."""
    check(set(got) == set(want), f"{what}: names {sorted(set(got) ^ set(want))[:6]} differ")
    for name, value in got.items():
        check(value.device.type == torch.device(DEVICE).type, f"{what}: {name} is on {value.device}")
        check(torch.equal(value.cpu(), want[name]), f"{what}: {name} differs from the fixture")
    return len(got)


def _adam_bits(what: str, trainer, names: list, want: dict) -> int:
    """The optimizer's state on the card equals ``want`` (a state_dict over
    ``names`` in the optimizer's order) bit for bit; step = optax's count."""
    params = trainer.optimizer.param_groups[0]["params"]
    check(len(params) == len(names) == len(want["state"]), f"{what}: {len(params)} parameters")
    for i, (name, p) in enumerate(zip(names, params)):
        st = trainer.optimizer.state[p]
        for key in ("exp_avg", "exp_avg_sq", "step"):
            check(st[key].device == p.device and torch.equal(st[key].cpu().float(),
                                                                 want["state"][i][key].float()),
                  f"{what}: Adam {key} of {name} differs from the fixture")
    return 3 * len(names)


def phase_jax_checkpoints(seed: int, card: str, d: Path) -> dict:
    """Phase 4h, first part: the JAX package's own checkpoints (committed
    fixtures, ``tests/torch_port_jax_fixtures.py``) through the port's entry
    points on the card, at the fixtures' small widths: export, convert and
    a server on their weights, train_cpc resumed from the CPC checkpoint
    for 2 epochs through the step graph, train_vocoder auto-resumed from the
    JAX run directory for 2 steps. Weights and Adam state on the card equal
    the fixture's bit for bit after each load; the first step or epoch after
    a resume is the checkpoint's; counts zeroed before and read after each
    path."""
    from vectorquantizedcpc_tpu_torch.cli import convert as convert_cli
    from vectorquantizedcpc_tpu_torch.cli import encode as encode_cli
    from vectorquantizedcpc_tpu_torch.cli import preprocess as preprocess_cli
    from vectorquantizedcpc_tpu_torch.cli import train_cpc, train_vocoder
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.data.corpus import SyntheticCorpus
    from vectorquantizedcpc_tpu_torch.dsp.audio_io import read_wav, write_wav
    from vectorquantizedcpc_tpu_torch.dsp.mel import wave_to_mel
    from vectorquantizedcpc_tpu_torch.infer.convert import load_models
    from vectorquantizedcpc_tpu_torch.infer.serving import ContinuousBatcher
    from vectorquantizedcpc_tpu_torch.models.encoder import Encoder
    from vectorquantizedcpc_tpu_torch.training.checkpoint import (checkpoint_format,
                                                                  latest_checkpoint,
                                                                  read_jax_checkpoint)
    from vectorquantizedcpc_tpu_torch.training.cpc import CPCTrainer
    from vectorquantizedcpc_tpu_torch.training.vocoder import VocoderTrainer
    from vectorquantizedcpc_tpu_torch.weights import (cpc_train_state_from_jax, flatten,
                                                      vocoder_from_jax_params,
                                                      vocoder_train_state_from_jax)

    start = time.perf_counter()
    argv = json.loads((FIXTURES / "argv.json").read_text())
    cpc_ckpt = FIXTURES / "cpc" / f"model.ckpt-{argv['cpc_epochs']}"
    voc_ckpt = FIXTURES / "vocoder" / FIXTURE_RUN / f"model.ckpt-{argv['vocoder_steps']}"
    check(checkpoint_format(cpc_ckpt) == checkpoint_format(voc_ckpt) == "jax", "fixture formats")
    decode_s = {}
    for name, path in (("cpc", cpc_ckpt), ("vocoder", voc_ckpt)):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            read_jax_checkpoint(path)
            times.append(time.perf_counter() - t0)
        decode_s[name] = (float(np.median(times)), path.stat().st_size)
    cpc_tree, voc_tree = read_jax_checkpoint(cpc_ckpt), read_jax_checkpoint(voc_ckpt)
    cpc_conf, voc_conf = load_conf(argv["cpc"]), load_conf(argv["vocoder"])
    out = {"decode_s": decode_s}

    # Export: the encode CLI at the default bf16, one batch (both mels pad to 64 frames).
    _reset_counts()
    n = encode_cli.main(argv["cpc"] + [f"cpc_checkpoint={cpc_ckpt}", f"in_dir={FIXTURES / 'mels'}",
                                       f"out_dir={d / 'codes'}"])
    torch.cuda.synchronize()
    out["export"] = _nonzero_counts()
    check(n == 2 and out["export"] == {"lstm_scan": 1},
          f"export of {n} mels launched {out['export']}, expected lstm_scan once")
    for mel in sorted((FIXTURES / "mels").glob("*.mel.npy")):
        rows = np.loadtxt(d / "codes" / mel.name.replace(".mel.npy", ".txt"), ndmin=2)
        check(rows.shape == (np.load(mel).shape[1] // 2, cpc_conf.dim_latent)
              and bool(np.isfinite(rows).all()), f"export of {mel.name}: {rows.shape}")

    # Convert 2 wavs, the second cut to 0.3 s (unequal lengths), bf16; then
    # a server on the same weights (the ragged PreNet's kernels).
    (d / "vc_in").mkdir()
    frames = []
    for i, wav in enumerate(sorted((FIXTURES / "wavs").glob("*.wav"))):
        wave, sr = read_wav(wav)
        wave = wave[: int(0.3 * sr)] if i else wave
        write_wav(d / "vc_in" / wav.name, wave, sr)
        frames.append(1 + len(wave) // voc_conf.data.dataset.mel_stft_stride)
    batches = len({max(32, -(-f // 32) * 32) for f in frames})  # convert's 32-frame buckets
    shutil.copy(FIXTURES / "wavs" / "speakers.json", d / "vc_in")
    _reset_counts()
    n = convert_cli.main(argv["vocoder"] + [
        f"cpc_checkpoint={cpc_ckpt}", f"vocoder_checkpoint={voc_ckpt}", f"in_dir={d / 'vc_in'}",
        f"out_dir={d / 'vc_out'}", f"synthesis_list={FIXTURES / 'synthesis.json'}"])
    torch.cuda.synchronize()
    out["convert"] = _nonzero_counts()
    check(n == 2 and out["convert"] == {"ar_decode": batches},
          f"convert of {n} wavs launched {out['convert']}, expected ar_decode {batches} times")
    for i in range(2):
        wave, _ = read_wav(d / "vc_out" / f"vc{i}.wav")
        check(wave.size > 0 and bool(np.isfinite(wave).all()) and float(np.abs(wave).max()) <= 1.0,
              f"converted vc{i}")
    encoder, vocoder = load_models(load_conf(argv["vocoder"] + [
        f"cpc_checkpoint={cpc_ckpt}", f"vocoder_checkpoint={voc_ckpt}"]), torch.device(DEVICE))
    from vectorquantizedcpc_tpu_torch.weights import encoder_from_jax_params

    bits = _check_bits("convert encoder", encoder.state_dict(), encoder_from_jax_params(
        flatten(cpc_tree["enc"]), flatten(cpc_tree["vq"])))
    bits += _check_bits("convert vocoder", vocoder.state_dict(),
                        vocoder_from_jax_params(flatten(voc_tree["params"])))
    # Independent of the mapping: the LSTM's and AR GRU's kernels are the
    # fixture's arrays transposed, the codebook the fixture's.
    check(torch.equal(encoder.rnn.weight_hh_l0.cpu(),
                      torch.from_numpy(np.ascontiguousarray(cpc_tree["enc"]["rnn"]["wh"].T)))
          and torch.equal(vocoder.rnnms.rnn.weight_hh_l0.cpu(), torch.from_numpy(
              np.ascontiguousarray(voc_tree["params"]["ar_gru"]["wh"].T)))
          and torch.equal(encoder.codebook.embedding.cpu(),
                          torch.from_numpy(cpc_tree["vq"]["embedding"].copy())),
          "the card's LSTM / AR GRU kernels or codebook differ from the fixture's arrays")
    pp = voc_conf.data.dataset.preprocess
    requests = []
    for i, wav in enumerate(sorted((d / "vc_in").glob("*.wav"))):
        mel = wave_to_mel(read_wav(wav, sr=pp.sr)[0], pp)[None]
        _, codes = encoder.encode(torch.from_numpy(mel).to(DEVICE), return_context=False)
        requests.append((codes[0].cpu().numpy(), i))
    net = voc_conf.training_vocoder.model.network
    srv = ContinuousBatcher(vocoder, slots=2, segment_frames=4,
                            max_frames=2 * max(len(z) for z, _ in requests) + 8, seed=seed,
                            device=DEVICE)
    _reset_counts()
    rids = [srv.submit(z, spk) for z, spk in requests]
    waves = srv.run()
    torch.cuda.synchronize()
    out["serve"] = _nonzero_counts()
    steps = int(srv.stats["steps"])
    check(out["serve"] == {"ar_decode": steps, "gru_scan": net.rnnms.prenet.num_layers,
                           "gru_scan_masked": net.rnnms.prenet.num_layers},
          f"server launched {out['serve']} for {steps} steps")
    for (z, _), r in zip(requests, rids):
        check(waves[r].shape == (2 * len(z) * net.rnnms.upsampling_t,)
              and bool(np.isfinite(waves[r]).all()), f"served wave {waves[r].shape}")

    # train_cpc resume= the JAX checkpoint: epochs 2 (re-run) and 3, 2 steps each.
    SyntheticCorpus(d / "corpus", **argv["corpus"]).utterances()
    data = _corpus_args(d)
    preprocess_cli.main(data + [f"out_dir={d / 'features'}"])
    fresh = CPCTrainer(cpc_conf, DEVICE)
    fresh.load(cpc_ckpt)
    want = cpc_train_state_from_jax(cpc_tree, fresh.param_names)
    bits += _check_bits("train_cpc encoder", fresh.encoder.state_dict(), want["encoder"])
    bits += _check_bits("train_cpc predictors", fresh.cpc.state_dict(), want["cpc"])
    bits += _adam_bits("train_cpc", fresh, fresh.param_names, want["optimizer"])
    del fresh
    epoch = int(cpc_tree["epoch"])
    _reset_counts()
    log = io.StringIO()
    try:
        with contextlib.redirect_stdout(log):
            trainer = train_cpc.main(argv["cpc"] + data + [
                f"checkpoint_dir={d / 'ckpt_cpc'}", f"resume={cpc_ckpt}",
                f"training.cpc.n_epochs={epoch + 1}", "training.cpc.log_interval=1",
                "training.cpc.checkpoint_interval=1", f"seed={seed}"])
    finally:
        print(log.getvalue(), end="")
    torch.cuda.synchronize()
    launches = _nonzero_counts()
    per_epoch = argv["corpus"]["n_speakers"] // cpc_conf.training.cpc.n_speakers_per_batch
    check(f"Resume checkpoint from: {cpc_ckpt}: epoch {epoch}" in log.getvalue(),
          "train_cpc did not resume at the checkpoint's epoch")
    logged = [int(e) for e in re.findall(r"^epoch:(\d+),", log.getvalue(), re.M)]
    check(logged == [epoch + 1] and trainer.global_step == 2 * per_epoch,
          f"resumed train_cpc logged epochs {logged}, {trainer.global_step} steps")
    graph = check_graph(trainer.graph, TRAIN_KERNELS, trainer.global_step,
                        {**dict.fromkeys(TRAIN_KERNELS, 0), **launches}, "train_cpc resumed from JAX")
    check(set(launches) == set(TRAIN_KERNELS), f"resumed train_cpc launched {launches}")
    losses = [float(m["loss"]) for m in trainer.history]
    check(len(losses) == trainer.global_step and all(np.isfinite(losses)), f"losses {losses}")
    saved = sorted(p.name for p in (d / "ckpt_cpc").glob("*.pt"))
    check(saved == [f"model.ckpt-{epoch + 1}.pt"], f"resumed train_cpc saved {saved}")
    out["train_cpc"] = launches

    # train_vocoder auto-resume from a copy of the JAX run directory: steps 4 and 5.
    shutil.copytree(FIXTURES / "vocoder", d / "voc_run")
    ckpt_dir = d / "voc_run" / FIXTURE_RUN
    check(latest_checkpoint(ckpt_dir) == ckpt_dir / voc_ckpt.name, "latest of the JAX run")
    fresh = VocoderTrainer(voc_conf, Encoder(voc_conf.model.encoder), DEVICE)
    fresh.load(voc_ckpt)
    names = [n for n, _ in fresh.vocoder.named_parameters()]
    want = vocoder_train_state_from_jax(voc_tree, names)
    bits += _check_bits("train_vocoder", fresh.vocoder.state_dict(), want["vocoder"])
    bits += _adam_bits("train_vocoder", fresh, names, want["optimizer"])
    del fresh
    step = int(voc_tree["step"])
    _reset_counts()
    log = io.StringIO()
    try:
        with contextlib.redirect_stdout(log):
            vtrainer = train_vocoder.main(argv["vocoder"] + data + [
                f"cpc_checkpoint={cpc_ckpt}", f"training_vocoder.ckpt_log.dir_root={d / 'voc_run'}",
                "data.loader.batch_size=4", "training_vocoder.trainer.max_epochs=3",
                "training_vocoder.trainer.val_interval_epoch=10", f"seed={seed}"],
                max_steps=step + 2)
    finally:
        print(log.getvalue(), end="")
    torch.cuda.synchronize()
    launches = _nonzero_counts()
    check(f"Auto-resume from: {ckpt_dir / voc_ckpt.name}: step {step}, epoch "
          f"{int(voc_tree['epoch'])}" in log.getvalue(), "train_vocoder did not resume the JAX run")
    vg = vtrainer.graph
    check(vtrainer.step == step + 2 and len(vtrainer.history) == 2
          and all(np.isfinite(list(vtrainer.history))), f"resumed vocoder at {vtrainer.step}")
    check(vg.eager_steps == 2 and vg.captures == 0
          and launches == {k: vg.eager_steps for k in VOC_KERNELS},
          f"resumed train_vocoder launched {launches} in {vg.eager_steps} eager steps")
    saved = sorted(p.name for p in ckpt_dir.iterdir())
    check(saved == [voc_ckpt.name, f"model.ckpt-{step + 2}.pt"], f"vocoder run holds {saved}")
    out["train_vocoder"] = launches
    print(f"JAX checkpoints (phase 4h): decoded the fixtures' CPC train state "
          f"({decode_s['cpc'][1]:,} B) in {decode_s['cpc'][0] * 1e3:.3f} ms and the vocoder's "
          f"({decode_s['vocoder'][1]:,} B) in {decode_s['vocoder'][0] * 1e3:.3f} ms (host, median "
          f"of 3); {bits} tensors on the card the fixture's bits after the loads; export "
          f"{json.dumps(out['export'])}; convert {json.dumps(out['convert'])}; server "
          f"{json.dumps(out['serve'])} ({steps} steps); train_cpc resumed at epoch {epoch}, "
          f"logged {logged}, {trainer.global_step} steps, {json.dumps(out['train_cpc'])}, graph "
          f"{graph['eager_steps']} eager + {graph['replays']} replays; train_vocoder auto-resumed "
          f"at step {step}: steps {step + 1}-{vtrainer.step}, {json.dumps(launches)}; "
          f"phase wall {time.perf_counter() - start:.3f} s  [{card}]")
    return out


def _state_bytes(tree) -> int:
    """Bytes of a checkpoint state's tensors on the card."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size() if tree.device.type == "cuda" else 0
    if isinstance(tree, dict):
        return sum(_state_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_state_bytes(v) for v in tree)
    return 0


def _loaded_bits(a, b, path="") -> list:
    """Where two loaded checkpoints differ (names), tensors bit for bit."""
    if isinstance(b, torch.Tensor):
        return [] if isinstance(a, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b) \
            else [path]
    if isinstance(b, dict):
        if not isinstance(a, dict) or a.keys() != b.keys():
            return [path]
        return [p for k in b for p in _loaded_bits(a[k], b[k], f"{path}/{k}")]
    if isinstance(b, (list, tuple)):
        return [p for i, (x, y) in enumerate(zip(a, b)) for p in _loaded_bits(x, y, f"{path}/{i}")]
    return [] if a == b else [path]


def _async_at_width(what: str, card: str, d: Path, make, run, state, modules) -> dict:
    """One trainer at its default width through the step graph: host ms the
    loop is blocked per save (sync ``save_checkpoint`` and
    ``AsyncCheckpointer.save``, median of CKPT_SAVES each, in turns, one
    step queued before each), step wall ms with and without a save in
    flight (median of 3 runs each, in turns), the snapshot's extra device
    memory; then a sync and an async save of one step, the async one
    written while 3 more steps run: both files load to the same tensors;
    a new trainer loads the async file and its next 3 steps (2 eager, then
    the capture) give the uninterrupted run's losses and state bit for bit."""
    from vectorquantizedcpc_tpu_torch.training.checkpoint import (AsyncCheckpointer,
                                                                  load_checkpoint,
                                                                  save_checkpoint)

    trainer = make()
    writer = AsyncCheckpointer()
    run(trainer, 3)  # 2 eager warm-up steps, then the capture
    torch.cuda.synchronize()
    blocked = {"sync": [], "async": []}
    for i in range(CKPT_SAVES):
        for kind in ("sync", "async"):
            run(trainer, 1)
            t0 = time.perf_counter()
            if kind == "sync":
                save_checkpoint(d / f"{what}_sync", i, state(trainer))
            else:
                writer.save(d / f"{what}_async", i, state(trainer))
            blocked[kind].append((time.perf_counter() - t0) * 1e3)
            writer.wait()
            torch.cuda.synchronize()
    w = CKPT_WALL_STEPS[what]
    wall = {"without": [], "with": []}
    for _ in range(3):
        for kind in ("without", "with"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kind == "with":
                writer.save(d / f"{what}_wall", 0, state(trainer))
            run(trainer, w)
            torch.cuda.synchronize()
            wall[kind].append((time.perf_counter() - t0) * 1e3 / w)
            writer.wait()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    writer.save(d / f"{what}_mem", 0, state(trainer))
    extra = torch.cuda.max_memory_allocated() - base
    writer.wait()
    nbytes = _state_bytes(state(trainer))

    # The same step saved both ways; 3 steps run while the async file is written.
    torch.cuda.synchronize()
    sync_path = save_checkpoint(d / f"{what}_eq_sync", 1, state(trainer))
    writer.save(d / f"{what}_eq_async", 1, state(trainer))
    first = trainer.graph.replays
    losses = run(trainer, 3)
    async_path = writer.wait()
    torch.cuda.synchronize()
    check(trainer.graph.replays == first + 3, f"{what}: the uninterrupted run left the graph")
    diffs = _loaded_bits(load_checkpoint(async_path), load_checkpoint(sync_path))
    check(not diffs, f"{what}: the async file differs from the sync one at {diffs[:6]}")
    uninterrupted = _train_state(trainer, modules(trainer))
    resumed = make()
    resumed.load(async_path)
    losses_resumed = run(resumed, 3, rewind=True)
    torch.cuda.synchronize()
    check(resumed.graph.eager_steps == 2 and resumed.graph.captures == 1,
          f"{what}: the resumed trainer took {resumed.graph.eager_steps} eager steps")
    diffs = _bit_diffs(uninterrupted, _train_state(resumed, modules(resumed)))
    if not torch.equal(torch.stack(losses), torch.stack(losses_resumed)):
        diffs["loss"] = float((torch.stack(losses) - torch.stack(losses_resumed)).abs().max())
    check(not diffs, f"{what}: resumed from the async file, 3 steps differ from the "
                     f"uninterrupted run: {dict(list(diffs.items())[:6])}")
    med = {k: float(np.median(v)) for k, v in {**blocked, **{f"wall_{k}": v
                                                             for k, v in wall.items()}}.items()}
    print(f"checkpoint {what} (phase 4h, default widths, {nbytes / 2**20:.1f} MiB on the card): "
          f"loop blocked per save {med['sync']:.3f} ms sync (saves {['%.3f' % x for x in blocked['sync']]}) "
          f"vs {med['async']:.3f} ms async ({['%.3f' % x for x in blocked['async']]}), median of "
          f"{CKPT_SAVES}; step wall {med['wall_without']:.3f} ms without a save in flight "
          f"({['%.3f' % x for x in wall['without']]}) vs {med['wall_with']:.3f} ms with one "
          f"({['%.3f' % x for x in wall['with']]}), {w} steps a run, median of 3; snapshot "
          f"{extra / 2**20:.1f} MiB of extra device memory; the async file (written under 3 "
          f"in-place graph steps) loads to the sync file's tensors; a trainer resumed from it "
          f"gives the uninterrupted run's 3 losses and {len(uninterrupted)} state tensors bit "
          f"for bit  [{card}]")
    del trainer, resumed
    torch.cuda.empty_cache()
    return {**med, "blocked_ms": blocked, "wall_ms": wall, "snapshot_bytes": extra,
            "state_bytes": nbytes}


def phase_async_checkpoints(seed: int, card: str, d: Path) -> dict:
    """Phase 4h, second part: ``AsyncCheckpointer`` against the synchronous
    save for both trainers at their default widths (``_async_at_width``)."""
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.models.cpc import sample_negative_indices
    from vectorquantizedcpc_tpu_torch.training.cpc import CPCTrainer
    from vectorquantizedcpc_tpu_torch.training.schedule import WarmupSchedule

    start = time.perf_counter()
    conf = load_conf([f"seed={seed}"])
    cc = conf.model.cpc
    t = conf.data.dataset.cpc.clip_length_mel
    rng = np.random.default_rng(seed + 30)
    pool = 4
    mels = torch.from_numpy(rng.normal(size=(pool, cc.n_speakers_per_batch,
                                             cc.n_utterances_per_speaker, 80, t)).astype(
        np.float32)).to(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 30)
    negs = [sample_negative_indices(cc, t // 2 - cc.n_prediction_steps // 2, gen)
            for _ in range(pool)]
    schedule = WarmupSchedule(150, 1e-5, 4e-4, [20000], 0.25)
    cursor = {}

    def cpc_run(trainer, k, rewind=False):
        """k graph steps on the pool's next batches (``rewind``: the 3
        batches the last 3 steps of the other trainer took)."""
        i = cursor.get("cpc", 0) - (3 if rewind else 0)
        losses = []
        for j in range(i, i + k):
            b = j % pool
            losses.append(trainer.train_steps(mels[b:b + 1], (negs[b][0][None], negs[b][1][None]),
                                              [schedule(j)])["loss"][0])
        if not rewind:
            cursor["cpc"] = i + k
        return losses

    out = {"cpc": _async_at_width(
        "cpc", card, d, lambda: CPCTrainer(conf, DEVICE), cpc_run,
        lambda tr: tr.checkpoint(cursor["cpc"], schedule),
        lambda tr: {"encoder": tr.encoder, "cpc": tr.cpc})}

    batches = [_voc_batch(seed + 40 + i, conf) for i in range(pool)]
    lr = conf.training_vocoder.model.optim.learning_rate

    def voc_run(trainer, k, rewind=False):
        i = cursor.get("vocoder", 0) - (3 if rewind else 0)
        losses = []
        for j in range(i, i + k):
            a, m, s = batches[j % pool]
            losses.append(trainer.train_steps(a[None], m[None], s[None], [lr])["loss"][0])
        if not rewind:
            cursor["vocoder"] = i + k
        return losses

    out["vocoder"] = _async_at_width(
        "vocoder", card, d, lambda: _voc_trainer(seed, conf), voc_run,
        lambda tr: tr.checkpoint(), lambda tr: {"vocoder": tr.vocoder})
    print(f"phase 4h async checkpoints: {time.perf_counter() - start:.3f} s wall  [{card}]")
    return out


def _bound(n_bytes: float, flops: float, peak_flops: float):
    ops_ms, bytes_ms = flops / peak_flops * 1e3, n_bytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_time_select(seed: int, card: str) -> dict:
    """The selection pair at the training shape: the device's own time
    (``ms``) and the host's cost per call (``time_device``), the host loop's
    time per call (``host_loop_ms``, ``time_cuda``, as earlier runs read it), the
    plain versions, the
    bound, and the dense route as a yardstick: a composite of PyTorch calls,
    not a library kernel for the function (forward: bmm of wc against the
    (k, s) tile, then gather; backward: the scores' cotangents scattered
    into the dense (k, s) tile, then two bmm), f32 with TF32 off."""
    from vectorquantizedcpc_tpu_torch.ops import cpc_select as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    k, s, u, n, l, z = SELECT_SHAPES["training"]
    wc, zs, utt, seq = _select_inputs(seed, k, s, u, n, l, z)
    f_neg, f_pos = cs.cpc_select(wc, zs, utt, seq)
    d_neg, d_pos = torch.randn_like(f_neg), torch.randn_like(f_pos)
    dots = 2 * k * s * u * (n + 1) * l * z
    ks, ul = k * s, u * l
    # Candidate rows of each anchor, positive first: (KS, U L, 1 + N) int64.
    cand = torch.cat([torch.arange(ul, device=DEVICE).reshape(1, u, 1, l).expand(ks, u, 1, l),
                      (utt.long()[:, None, :, :, None] * l + seq.long()).reshape(ks, u, n, l)],
                     dim=2).permute(0, 1, 3, 2).reshape(ks, ul, n + 1).contiguous()
    d_cand = torch.cat([d_pos.reshape(ks, u, 1, l), d_neg.reshape(ks, u, n, l)],
                       dim=2).permute(0, 1, 3, 2).reshape(ks, ul, n + 1).contiguous()
    wc3, zs3 = wc.reshape(ks, ul, z), zs.reshape(ks, ul, z)

    def dense_fwd():
        return torch.gather(torch.bmm(wc3, zs3.transpose(1, 2)), 2, cand)

    def dense_bwd():
        dense = torch.zeros(ks, ul, ul, device=DEVICE).scatter_add_(2, cand, d_cand)
        return torch.bmm(dense, zs3), torch.bmm(dense.transpose(1, 2), wc3)

    rows = {
        "cpc_select": (lambda: cs.cpc_select(wc, zs, utt, seq),
                       lambda: cs.cpc_select_reference(wc, zs, utt, seq),
                       _nbytes(wc, zs, utt, seq, f_neg, f_pos), dots, dense_fwd, 2),
        "cpc_select_bwd": (lambda: cs.cpc_select_bwd(d_neg, d_pos, wc, zs, utt, seq),
                           lambda: cs.cpc_select_bwd_reference(d_neg, d_pos, wc, zs, utt, seq),
                           _nbytes(d_neg, d_pos, wc, zs, utt, seq, wc, zs), 2 * dots, dense_bwd,
                           4),
    }
    out = {}
    for name, (kernel, plain, n_bytes, ops, dense, calls) in rows.items():
        bound, by = _bound(n_bytes, ops, PEAK_F32_FLOPS)
        device_ms, host_us = time_device(kernel, reps=200)
        dense_ms, _ = time_device(dense, reps=50)
        res = {"ms": device_ms, "host_loop_ms": time_cuda(kernel, reps=50), "host_us": host_us,
               "plain_ms": time_cuda(plain, reps=5), "bound_ms": bound, "bound_by": by,
               "library_ms": None, "dense_route_ms": dense_ms}
        loop_ms, dev_ms, required, goal = EARLIER_SELECT_MS[name]
        print(f"timing {name} K={k} S={s} U={u} N={n} L={l} Z={z}: host loop "
              f"{res['host_loop_ms']:.4f} ms, device only {device_ms:.4f} ms (bound / device = "
              f"{bound / device_ms * 100:.2f} %), host {host_us:.2f} us per call; dense route "
              f"(a composite of {calls} PyTorch calls, f32, TF32 off) {dense_ms:.4f} ms device "
              f"only; before the redesign {loop_ms} ms host loop, {dev_ms} ms device only "
              f"({dev_ms / device_ms:.2f}x); required <= {required} ms "
              f"{'met' if device_ms <= required else 'missed'}, goal <= {goal} ms "
              f"{'met' if device_ms <= goal else 'missed'}  [{card}]")
        out[name] = res
    return out


def phase_select_stamps(seed: int, card: str) -> dict:
    """The selection pair's split by phase at the training shape, from the
    stamped variants (``cpc_select_stamped``, ``cpc_select_bwd_stamped``,
    reached from nothing but this phase), whose outputs must be the plain
    launches' bits: us that thread 0 of block 0 and of the last block spent
    in each phase over the launch, for the forward and the backward (its
    block 0 builds the d_zs lists and sums d_zs rows, its last block sums
    d_wc rows); the SM clock over each launch. Returns {kernel: {block:
    {phase: us}}}."""
    from vectorquantizedcpc_tpu_torch.ops import cpc_select as cs

    k, s, u, n, l, z = SELECT_SHAPES["training"]
    wc, zs, utt, seq = _select_inputs(seed, k, s, u, n, l, z)
    rng = np.random.default_rng(seed + 10)
    d_neg = torch.from_numpy(rng.normal(size=(k, s, u, n, l)).astype(np.float32)).to(DEVICE)
    d_pos = torch.from_numpy(rng.normal(size=(k, s, u, l)).astype(np.float32)).to(DEVICE)
    plain = cs.cpc_select(wc, zs, utt, seq)
    plain_b = cs.cpc_select_bwd(d_neg, d_pos, wc, zs, utt, seq)
    cs.cpc_select_stamped(wc, zs, utt, seq)  # warm-up
    *got, stamps = cs.cpc_select_stamped(wc, zs, utt, seq)
    cs.cpc_select_bwd_stamped(d_neg, d_pos, wc, zs, utt, seq)
    *got_b, stamps_b = cs.cpc_select_bwd_stamped(d_neg, d_pos, wc, zs, utt, seq)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, plain)),
          "the stamped cpc_select's outputs are not the plain launch's bits")
    check(all(torch.equal(a, b) for a, b in zip(got_b, plain_b)),
          "the stamped cpc_select_bwd's d_wc, d_zs are not the plain launch's bits")
    out = {**cs.summarize_select_stamps(stamps.cpu().tolist()),
           **cs.summarize_select_stamps(stamps_b.cpu().tolist(), True)}
    # The SM clock over each stamped launch: clock64 ticks per globaltimer ns.
    clocks = [(r[3] - r[1]) / max(1, r[2] - r[0]) * 1e3 for buf in (stamps, stamps_b)
              for r in buf.cpu().tolist()]
    for kernel, split in out.items():
        check(bool(split), f"stamps cpc_select {kernel}: no block recorded")
        for block, phases in split.items():
            print(f"stamps cpc_select {kernel} K={k} S={s} U={u} N={n} L={l} Z={z} {block} (us "
                  f"over the launch, thread 0): " + ", ".join(f"{ph} {v:.3f}" for ph, v in
                                                               phases.items()) + f"  [{card}]")
    print(f"stamps cpc_select: SM clock over the stamped launches "
          f"{', '.join(f'{c:.0f}' for c in clocks)} MHz  [{card}]")
    return out


def phase_time_train(seed: int, card: str) -> dict:
    """The training kernels, their plain versions and bounds at the training
    shape; cuDNN's LSTM (fp16, with the input projection) forward and
    backward beside the LSTM pair; the train step to the device."""
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.models.cpc import sample_negative_indices
    from vectorquantizedcpc_tpu_torch.ops import lstm_scan as ls
    from vectorquantizedcpc_tpu_torch.training.cpc import CPCTrainer

    out = {}
    batch, steps = TRAIN_LSTM_SHAPES["training"]
    args = _lstm_inputs(seed, batch, steps)
    hs, acts, c_prev, h_t, c_t = ls.lstm_scan_train(*args)
    rng = np.random.default_rng(seed + 12)
    dhs = torch.from_numpy(rng.normal(size=(steps, batch, LSTM_H)).astype(np.float32)).to(
        DEVICE).bfloat16()
    dh_t, dc_t = torch.zeros_like(h_t), torch.zeros_like(c_t)
    bwd_args = (acts, c_prev, dhs, args[0], dh_t, dc_t)
    dgates = torch.empty_like(acts)
    flops = 2 * batch * steps * LSTM_H * 4 * LSTM_H
    lstm_in = torch.randn(batch, steps, 64, device=DEVICE, dtype=CUDNN_DTYPE, requires_grad=True)
    cudnn = torch.nn.LSTM(64, LSTM_H, batch_first=True).to(DEVICE, CUDNN_DTYPE)
    lib_out, _ = cudnn(lstm_in)
    lib_grad = torch.randn_like(lib_out)
    inputs = [lstm_in] + list(cudnn.parameters())
    rows = {
        "lstm_scan_train": (lambda: ls.lstm_scan_train(*args),
                            lambda: ls.lstm_scan_train_reference(*args),
                            _nbytes(*args, hs, acts, c_prev, h_t, c_t), lambda: cudnn(lstm_in)),
        "lstm_scan_bwd": (lambda: ls.lstm_scan_bwd(*bwd_args),
                          lambda: ls.lstm_scan_bwd_reference(*bwd_args),
                          _nbytes(*bwd_args, dgates, h_t, c_t),
                          lambda: torch.autograd.grad(lib_out, inputs, lib_grad, retain_graph=True)),
    }
    for name, (kernel, plain, n_bytes, lib) in rows.items():
        bound, by = _bound(n_bytes, flops, PEAK_BF16_FLOPS)
        out[name] = {"ms": time_cuda(kernel, reps=20), "plain_ms": time_cuda(plain, reps=2),
                     "bound_ms": bound, "bound_by": by, "library_ms": time_cuda(lib, reps=20)}

    out.update(phase_time_select(seed, card))
    for name, res in out.items():
        lib = "none" if res["library_ms"] is None else f"{res['library_ms']:.4f} ms"
        print(f"timing {name}: kernel {res['ms']:.4f} ms; plain {res['plain_ms']:.3f} ms; "
              f"library {lib}; bound {res['bound_ms'] * 1e3:.3f} us by {res['bound_by']}; "
              f"bound / kernel = {res['bound_ms'] / res['ms'] * 100:.3f} %  [{card}]")

    # The train step to the device on both paths: negatives drawn and one
    # optimizer step, as train_model runs them.
    conf = load_conf([f"seed={seed}"])
    trainers = {"eager": CPCTrainer(conf, DEVICE), "graph": CPCTrainer(conf, DEVICE)}
    mels, _, _ = _train_batch(seed, conf)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    length = conf.data.dataset.cpc.clip_length_mel // 2 - conf.model.cpc.n_prediction_steps // 2

    def negatives():
        return sample_negative_indices(conf.model.cpc, length, gen)

    def eager(k: int):
        for _ in range(k):
            trainers["eager"].train_step(mels, *negatives(), 1e-4)

    def graphed(k: int):
        negs = [negatives() for _ in range(k)]
        trainers["graph"].train_steps(mels.expand(k, *mels.shape),
                                      (torch.stack([u for u, _ in negs]),
                                       torch.stack([q for _, q in negs])), [1e-4] * k)

    paths = _time_step_paths("CPC train step (S 8 x U 8 x 140 frames, bf16)",
                             {"eager": eager, "graph": graphed}, trainers["graph"].graph,
                             warmup=5, n=50, reps=3, profile_n=10, card=card)
    step_ms = paths["graph"]["ms"]
    kernels_ms = sum(res["ms"] for res in out.values())
    print(f"timing train step: the graph path {step_ms:.3f} ms = {1e3 / step_ms:.2f} steps/s to "
          f"the device, the eager path {paths['eager']['ms']:.3f} ms "
          f"({paths['eager']['ms'] / step_ms:.2f}x); the four training kernels {kernels_ms:.4f} ms "
          f"= {kernels_ms / step_ms * 100:.2f} % of the graph step (their times alone, above)  "
          f"[{card}]")
    out["step"] = {**paths["graph"], "steps_per_s": 1e3 / step_ms,
                   "kernels_share": kernels_ms / step_ms, "eager": paths["eager"]}
    return out


def phase_time_vocoder(seed: int, card: str) -> dict:
    """The GRU training pair, their plain versions and bounds at the
    vocoder's T 5,120, B 32, H 896; cuDNN's GRU (fp16, on the (B, T, 512)
    input, so it also does the input projection) forward and backward
    beside them; the dwh product; the vocoder train step to the device."""
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.ops import gru_train as g
    from vectorquantizedcpc_tpu_torch.ops.matmul import bf16_product

    start = time.perf_counter()
    out = {}
    steps, batch, hidden = GRU_TRAIN_SHAPES["training"]
    args = _gru_train_inputs(seed, steps, batch, hidden)
    hs, acts, hns, h_t = g.gru_scan_train(*args)
    rng = np.random.default_rng(seed + 17)
    dhs = torch.from_numpy(rng.normal(size=(steps, batch, hidden)).astype(np.float32)).to(
        DEVICE).bfloat16()
    h_prevs = torch.cat([args[3].bfloat16()[None], hs[:-1]]).contiguous()
    bwd_args = (acts, hns, h_prevs, dhs, args[0], torch.zeros_like(h_t))
    dgx, dgh, dh0 = g.gru_scan_bwd(*bwd_args)
    flops = 2 * steps * batch * hidden * 3 * hidden
    gru_in = torch.randn(batch, steps, 512, device=DEVICE, dtype=CUDNN_DTYPE, requires_grad=True)
    cudnn = torch.nn.GRU(512, hidden, batch_first=True).to(DEVICE, CUDNN_DTYPE)
    lib_out, _ = cudnn(gru_in)
    lib_grad = torch.randn_like(lib_out)
    inputs = [gru_in] + list(cudnn.parameters())
    rows = {
        "gru_scan_train": (lambda: g.gru_scan_train(*args),
                           lambda: g.gru_scan_train_reference(*args),
                           _nbytes(*args, hs, acts, hns, h_t), lambda: cudnn(gru_in)),
        "gru_scan_bwd": (lambda: g.gru_scan_bwd(*bwd_args),
                         lambda: g.gru_scan_bwd_reference(*bwd_args),
                         _nbytes(*bwd_args, dgx, dgh, dh0),
                         lambda: torch.autograd.grad(lib_out, inputs, lib_grad, retain_graph=True)),
    }
    for name, (kernel, plain, n_bytes, lib) in rows.items():
        bound, by = _bound(n_bytes, flops, PEAK_BF16_FLOPS)
        res = out[name] = {"ms": time_cuda(kernel, reps=3), "plain_ms": time_cuda(plain, reps=1),
                           "bound_ms": bound, "bound_by": by, "library_ms": time_cuda(lib, reps=3)}
        print(f"timing {name} T={steps} B={batch} H={hidden}: kernel {res['ms']:.3f} ms = "
              f"{res['ms'] * 1e3 / steps:.3f} us/step; plain {res['plain_ms']:.3f} ms; cuDNN "
              f"nn.GRU (fp16, with the input projection) {res['library_ms']:.3f} ms; bound "
              f"{bound:.4f} ms by {by} ({flops:.4g} FLOP, {n_bytes:.4g} B); bound / kernel = "
              f"{bound / res['ms'] * 100:.3f} %  [{card}]")
    del lib_out, inputs, gru_in, cudnn
    # GruScan.backward's dwh: one product of the bf16 operands, f32 sums.
    dwh_ms = time_cuda(lambda: bf16_product(h_prevs.reshape(-1, hidden).t(),
                                               dgh.reshape(-1, 3 * hidden)), reps=5)
    dwh_bound, dwh_by = _bound(_nbytes(h_prevs, dgh) + hidden * 3 * hidden * 2, flops,
                               PEAK_BF16_FLOPS)
    print(f"timing dwh = h_prevs^T dgh ({steps * batch}-deep, bf16 in, f32 sums): {dwh_ms:.3f} ms "
          f"= {flops / dwh_ms / 1e9:.1f} TFLOP/s; bound {dwh_bound:.4f} ms by {dwh_by}  [{card}]")
    for name, ms in (("gru_scan_train", out["gru_scan_train"]["ms"]),
                     ("gru_scan_bwd", out["gru_scan_bwd"]["ms"]), ("dwh", dwh_ms)):
        print(f"timing {name} against the one-group kernels ({ONE_GROUP_MS[name]} ms, the same "
              f"shape and card type): {ms:.3f} ms, {ONE_GROUP_MS[name] / ms:.2f}x  [{card}]")

    conf = load_conf([f"seed={seed}"])
    trainers = {"eager": _voc_trainer(seed, conf), "graph": _voc_trainer(seed, conf)}
    batch_t = _voc_batch(seed, conf)

    def eager(k: int):
        for _ in range(k):
            trainers["eager"].train_step(*batch_t, 1e-4)

    def graphed(k: int):
        trainers["graph"].train_steps(*(x.expand(k, *x.shape) for x in batch_t), [1e-4] * k)

    eager(1)  # the eager step's own peak, before the graph's pool exists
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    eager(1)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    paths = _time_step_paths(f"vocoder train step (B {VOC_B} x {VOC_T} samples, bf16)",
                             {"eager": eager, "graph": graphed}, trainers["graph"].graph,
                             warmup=2, n=5, reps=3, profile_n=3, card=card)
    step_ms = paths["graph"]["ms"]
    kernels_ms = out["gru_scan_train"]["ms"] + out["gru_scan_bwd"]["ms"]
    samples_s = VOC_B * VOC_T / (step_ms / 1e3)
    print(f"timing vocoder train step: the graph path {step_ms:.3f} ms = {1e3 / step_ms:.3f} "
          f"steps/s = {samples_s:.1f} samples/s to the device, the eager path "
          f"{paths['eager']['ms']:.3f} ms ({paths['eager']['ms'] / step_ms:.2f}x); the two GRU "
          f"kernels {kernels_ms:.3f} ms = {kernels_ms / step_ms * 100:.2f} % of the graph step "
          f"(their times alone, above); the eager step's peak memory {peak / 2**30:.3f} GiB "
          f"({(peak - base) / 2**30:.3f} GiB above the trainers' state)  [{card}]")
    out["step"] = {**paths["graph"], "steps_per_s": 1e3 / step_ms, "samples_per_s": samples_s,
                   "kernels_share": kernels_ms / step_ms, "peak_bytes": peak, "dwh_ms": dwh_ms,
                   "eager": paths["eager"]}
    print(f"phase 5 vocoder timing: {time.perf_counter() - start:.3f} s wall")
    return out


def _time_step_paths(what: str, run: dict, graph, warmup: int, n: int, reps: int,
                     profile_n: int, card: str) -> dict:
    """Both paths of a train step on the card: ``run["eager"](k)`` queues k
    eager steps, ``run["graph"](k)`` k steps through the step graph
    (``graph``). Each path warms up (the graph path also through its own
    eager steps and its capture), then ``reps`` runs of ``n`` steps in turns
    (eager, graph, graph, eager, ...) give the wall ms per step to the device
    (median and spread) and the host's us per step (until the last step is
    queued); a trace of ``profile_n`` more steps through ``utils/profiling``
    gives the device's busy ms per step, read against the median wall, and
    its operations per step."""
    from vectorquantizedcpc_tpu_torch.training.step_graph import WARMUP_STEPS
    from vectorquantizedcpc_tpu_torch.utils.profiling import device_time, trace

    run["eager"](warmup)
    run["graph"](WARMUP_STEPS + 1 + warmup)
    torch.cuda.synchronize()
    walls, hosts = {p: [] for p in run}, {p: [] for p in run}
    for rep in range(reps):
        for path in (("eager", "graph") if rep % 2 == 0 else ("graph", "eager")):
            start = time.perf_counter()
            run[path](n)
            hosts[path].append((time.perf_counter() - start) / n * 1e6)
            torch.cuda.synchronize()
            walls[path].append((time.perf_counter() - start) / n * 1e3)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for path in ("eager", "graph"):
            with trace(Path(tmp) / path, DEVICE) as prof:
                run[path](profile_n)
            dev = device_time(prof, profile_n)
            ms, busy = float(np.median(walls[path])), dev["device_busy_ms"]
            out[path] = {"ms": ms, "spread_ms": max(walls[path]) - min(walls[path]),
                         "wall_ms": walls[path], "host_us": float(np.median(hosts[path])),
                         "device_busy_ms": busy,
                         "idle_share": None if busy is None else 1 - busy / ms,
                         "device_ops_per_step": dev["device_ops_per_step"]}
            device = "device time not measured (the trace holds none)" if busy is None else (
                f"device busy {busy:.3f} ms per step (trace of {profile_n} steps), idle "
                f"{(1 - busy / ms) * 100:.2f} %, {dev['device_ops_per_step']:.1f} device "
                f"operations per step; largest per step: " + "; ".join(
                    f"{key[:48]} x{count:g} {t_ms:.4f} ms" for key, count, t_ms in dev["largest"]))
            print(f"timing {what}, {path} path: wall {ms:.3f} ms per step (median of {reps} runs "
                  f"of {n}: {', '.join(f'{w:.3f}' for w in walls[path])}; spread "
                  f"{out[path]['spread_ms']:.3f} ms), host {out[path]['host_us']:.1f} us per step "
                  f"queued; {device}  [{card}]")
    out["graph"].update(capture_s=graph.capture_s, pool_bytes=graph.pool_bytes)
    print(f"timing {what}, graph: {graph.captures} capture in {graph.capture_s:.3f} s, its pool "
          f"{graph.pool_bytes / 2**20:.1f} MiB; {graph.eager_steps} eager warm-up steps and "
          f"{graph.replays} replays in this phase  [{card}]")
    return out


# Data parallelism and sharded serving (phases 4i-4l).
DP_CPC_STEPS, DP_VOC_STEPS = 3, 2  # phase 4j's eager steps on two ranks
DP_RANK_LIMIT_S = 300  # phase 4j's two rank processes, start-up and build cache included
DP_PRECISIONS = ("bfloat16", "float32")
DP_EMA_REL = 1e-2  # of the buffer's largest element, bf16
# Phase 4j's bounds against one process on the global batches. float32 (the
# CPC step only): tests/test_torch_parallel.py's (later-step losses 1e-4,
# 99 % of the weights within 0.1 lr, EMA 1e-3). bfloat16, both steps: the
# train step's loss bound (MAX_STEP_LOSS_REL), DP_EMA_REL, and shares of the
# weights within 0.1 lr set below the H100's readings at seed 0 (CPC 97.9 %,
# vocoder 98.07 % and 98.56 %); every weight within 2 lr a step. A rank
# that trained on half the batch, or a wrong B 16 backward, moves most
# weights by a whole lr step.
DP_TOLERANCES = {
    "float32": {"cpc_loss": 1e-4, "cpc_share": 0.99, "ema": 1e-3},
    "bfloat16": {"cpc_loss": MAX_STEP_LOSS_REL, "voc_loss": MAX_STEP_LOSS_REL,
                 "cpc_share": 0.95, "voc_share": 0.97, "ema": DP_EMA_REL},
}
SHARDED_SLOTS = 8  # phase 4k: 2 shards of 4 slots on one card against 1 of 8


def _cpc_group(seed: int, conf, n: int):
    """``n`` CPC steps' inputs on the card: mels (n, S, U, 80, T), the
    stacked negatives and learning rates."""
    from vectorquantizedcpc_tpu_torch.models.cpc import sample_negative_indices

    cc = conf.model.cpc
    t = conf.data.dataset.cpc.clip_length_mel
    rng = np.random.default_rng(seed + 20)
    mels = torch.from_numpy(rng.normal(size=(n, cc.n_speakers_per_batch,
                                             cc.n_utterances_per_speaker, 80, t)).astype(
        np.float32)).to(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 20)
    negs = [sample_negative_indices(cc, t // 2 - cc.n_prediction_steps // 2, gen)
            for _ in range(n)]
    stacked = (torch.stack([u for u, _ in negs]), torch.stack([q for _, q in negs]))
    return mels, stacked, [4e-4 * (i + 1) / n for i in range(n)]


def _voc_group(seed: int, conf, k: int):
    batches = [_voc_batch(seed + i, conf) for i in range(k)]
    return tuple(torch.stack([b[j] for b in batches]) for j in range(3))


def phase_world_one(seed: int, card: str) -> dict:
    """Phase 4i: a process group of one rank on NCCL, through the step graph:
    GRAPH_CPC_STEPS CPC and GRAPH_VOC_STEPS vocoder steps with the gradient
    and metric all_reduce (and the VQ statistics') inside the CUDA graph, the
    same bits as the trainers without a group; the graph holds each training
    kernel once a step; both step times in turns."""
    import torch.distributed as dist

    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.training.cpc import CPCTrainer

    start = time.perf_counter()
    conf = load_conf([f"seed={seed}"])
    mels, negs, lrs = _cpc_group(seed, conf, GRAPH_CPC_STEPS)
    audio, vmels, spk = _voc_group(seed, conf, GRAPH_VOC_STEPS)
    vlrs = [conf.training_vocoder.model.optim.learning_rate] * GRAPH_VOC_STEPS
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    out = {}
    try:
        group = dist.group.WORLD
        paths = (
            ("CPC", lambda g: CPCTrainer(conf, DEVICE, g),
             lambda tr: tr.train_steps(mels, negs, lrs)["loss"],
             lambda tr: {"encoder": tr.encoder, "cpc": tr.cpc}, TRAIN_KERNELS, _train_counts,
             GRAPH_CPC_STEPS),
            ("vocoder", lambda g: _voc_trainer(seed, conf, g),
             lambda tr: tr.train_steps(audio, vmels, spk, vlrs)["loss"],
             lambda tr: {"vocoder": tr.vocoder}, VOC_KERNELS, _voc_counts, GRAPH_VOC_STEPS),
        )
        for what, make, run, modules, kernels, counts, n in paths:
            plain = make(None)
            loss_plain = run(plain)
            grouped = make(group)
            torch.cuda.synchronize()
            counts(reset=True)
            loss_group = run(grouped)
            torch.cuda.synchronize()
            launches = counts()
            graph = check_graph(grouped.graph, kernels, n, launches, f"world 1 NCCL {what}")
            a, b = _train_state(plain, modules(plain)), _train_state(grouped, modules(grouped))
            check(set(a) == set(b), f"world 1 {what}: state names differ")
            diffs = _bit_diffs(a, b)
            if not torch.equal(loss_plain, loss_group):
                diffs["loss"] = float((loss_plain - loss_group).abs().max())
            check(not diffs, f"world 1 NCCL {what}: differs from no group: "
                             f"{dict(list(diffs.items())[:6])}")
            ms = {"no group": [], "NCCL world 1": []}
            for label, tr in (("no group", plain), ("NCCL world 1", grouped)) * 3:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(tr)
                torch.cuda.synchronize()
                ms[label].append(1e3 * (time.perf_counter() - t0) / n)
            med = {k: float(np.median(v)) for k, v in ms.items()}
            out[what] = {"launches": launches, "graph": graph, "ms": med}
            print(f"world 1 NCCL {what}: {n} steps through the step graph, the all_reduce "
                  f"inside the capture: losses, weights, buffers and Adam's state the same "
                  f"bits as without a group ({len(a)} tensors); captured a step "
                  f"{json.dumps(graph['captured_per_step'])}; step wall ms, median of 3 runs "
                  f"in turns: no group {med['no group']:.3f} "
                  f"({', '.join(f'{x:.3f}' for x in ms['no group'])}), NCCL world 1 "
                  f"{med['NCCL world 1']:.3f} ({', '.join(f'{x:.3f}' for x in ms['NCCL world 1'])})"
                  f"  [{card}]")
    finally:
        dist.destroy_process_group()
    print(f"phase 4i wall {time.perf_counter() - start:.3f} s  [{card}]")
    return out


def _agreement(got: dict, ref: dict, lr: float, steps: int, slice_of=None) -> tuple:
    """Shares of the weights within 0.1 lr of ``ref`` (all; and those
    ``slice_of`` picks) and the 4 tensors with the lowest shares; raises if
    one is more than 2 lr a step off."""
    close = total = close_s = total_s = 0
    shares = {}
    for key, r in ref.items():
        d = (got[key].double() - r.double()).abs()
        check(float(d.max()) <= 2 * lr * steps * 1.01, f"2 ranks vs one process: {key} "
                                                       f"{float(d.max())} off")
        c = int((d <= 0.1 * lr).sum())
        shares[key] = round(c / d.numel(), 4)
        close, total = close + c, total + d.numel()
        if slice_of is not None and slice_of(key):
            close_s, total_s = close_s + c, total_s + d.numel()
    worst = dict(sorted(shares.items(), key=lambda kv: kv[1])[:4])
    return close / total, (close_s / total_s if total_s else 1.0), worst


def _dp_steps(conf, inputs: dict, seed: int, group=None, mesh=None, model=None) -> dict:
    """Phase 4j's and 4m's eager steps from ``inputs``' weights, on this
    rank's share of each global batch (the whole batch without ``mesh``),
    with its shards of the weights under a ``model`` group: the losses,
    every state tensor (gathered), the rank's own tensors and the kernels'
    launches; the vocoder's only where DP_TOLERANCES has them (at bf16: its
    float32 step's plain GRU loop over 5,120 samples takes seconds)."""
    from vectorquantizedcpc_tpu_torch.models.cpc import shard_negatives
    from vectorquantizedcpc_tpu_torch.parallel.sharding import shard_batch
    from vectorquantizedcpc_tpu_torch.parallel.tensor import shard_state
    from vectorquantizedcpc_tpu_torch.training.cpc import CPCTrainer

    to = lambda x: x.to(DEVICE)
    share = lambda x: shard_batch(to(x), mesh)
    mine = lambda sd, dims: sd if model is None else shard_state(sd, dims, model)
    _train_counts(reset=True)
    tr = CPCTrainer(conf, DEVICE, group, model)
    tr.encoder.load_state_dict(mine(inputs["encoder"], tr.encoder_dims), strict=True)
    tr.cpc.load_state_dict(inputs["cpc"], strict=True)
    cpc_losses = [tr.train_step(share(m), to(u), to(q) if mesh is None else
                                shard_negatives(to(q), mesh.rank, mesh.world), lr)["loss"]
                  for m, u, q, lr in zip(inputs["mels"], inputs["utt"], inputs["seq"],
                                         inputs["lrs"])]
    torch.cuda.synchronize()
    modules = {"encoder": tr.encoder, "cpc": tr.cpc}
    out = {"cpc_losses": torch.stack(cpc_losses).cpu(), "cpc_counts": _train_counts(),
           "cpc_state": {k: v.cpu() for k, v in _train_state(tr, modules).items()},
           "cpc_own": _own_tensors(tr, modules)}
    if "voc_loss" not in DP_TOLERANCES[conf.runtime.precision]:
        return out
    del tr
    _voc_counts(reset=True)
    vt = _voc_trainer(seed, conf, group, model)
    vt.vocoder.load_state_dict(mine(inputs["vocoder"], vt.vocoder_dims), strict=True)
    voc_losses = [vt.train_step(*(share(x) for x in b), lr)["loss"]
                  for b, lr in zip(inputs["voc"], inputs["vlrs"])]
    torch.cuda.synchronize()
    out.update({"voc_losses": torch.stack(voc_losses).cpu(), "voc_counts": _voc_counts(),
                "voc_state": {k: v.cpu() for k, v in _train_state(
                    vt, {"vocoder": vt.vocoder}).items()},
                "voc_own": _own_tensors(vt, {"vocoder": vt.vocoder})})
    return out


def dp_rank(d: Path, seed: int) -> None:
    """One of phase 4j's two ranks (``--dp-rank``): eager steps of both
    trainers at each of DP_PRECISIONS on this rank's share of the global
    batches, on card 0 over gloo; writes the results."""
    global DEVICE
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.parallel.mesh import mesh_from_conf

    argv = [f"seed={seed}", "runtime.platform=cuda:0", "runtime.mesh_data=2"]
    mesh = mesh_from_conf(load_conf(argv).runtime)
    check(mesh is not None and mesh.world == 2 and mesh.device == torch.device("cuda", 0),
          f"rank mesh {mesh}")
    DEVICE = str(mesh.device)
    inputs = torch.load(d / "inputs.pt", weights_only=False)
    torch.save({p: _dp_steps(load_conf(argv + [f"runtime.precision={p}"]), inputs, seed,
                             mesh.group, mesh) for p in DP_PRECISIONS},
               d / f"rank{mesh.rank}.pt")


def phase_two_ranks(seed: int, card: str, d: Path) -> dict:
    """Phase 4j: two ranks on card 0 over gloo (NCCL refuses two ranks on
    one device), eager train_step, in two processes that time-slice the
    card: DP_CPC_STEPS CPC steps (S 8, 4 a rank) and DP_VOC_STEPS vocoder
    steps (B 32, 16 a rank). Both ranks end with the same bits. Against one
    process on the global batches: the CPC step at float32 within the
    tolerances of tests/test_torch_parallel.py (where only the selection
    pair of the kernels runs); both steps at bf16, through every training
    kernel, the losses within MAX_STEP_LOSS_REL, the EMA buffers within
    DP_EMA_REL, every weight within 2 lr a step and the shares of the
    weights within 0.1 lr at DP_TOLERANCES' bounds, below f32's: Adam turns
    the bf16 rounding of each rank's weight-gradient products (rounded once
    for the whole batch in one process) into whole lr steps wherever a
    gradient is near zero. torchrun starts the two rank processes.
    The weights are ``randomize``'s, whose codebook spreads the latents over
    many codes: at torch's inits every latent takes one code, positives and
    negatives score alike and the predictors' gradients are rounding noise."""
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.training.cpc import CPCTrainer, fold_lstm_bias

    start = time.perf_counter()
    conf = load_conf([f"seed={seed}"])
    tr = CPCTrainer(conf, DEVICE)
    randomize(tr.encoder, np.random.default_rng(seed + 31))
    randomize(tr.cpc, np.random.default_rng(seed + 32))
    fold_lstm_bias(tr.encoder)
    vt = _voc_trainer(seed, conf)
    randomize(vt.vocoder, np.random.default_rng(seed + 41))
    mels, (utt, seq), lrs = _cpc_group(seed + 30, conf, DP_CPC_STEPS)
    cpu = lambda xs: [x.cpu() for x in xs]
    inputs = {"encoder": {k: v.cpu() for k, v in tr.encoder.state_dict().items()},
              "cpc": {k: v.cpu() for k, v in tr.cpc.state_dict().items()},
              "vocoder": {k: v.cpu() for k, v in vt.vocoder.state_dict().items()},
              "mels": cpu(mels), "utt": cpu(utt), "seq": cpu(seq), "lrs": lrs,
              "voc": [cpu(_voc_batch(seed + 40 + i, conf)) for i in range(DP_VOC_STEPS)],
              "vlrs": [conf.training_vocoder.model.optim.learning_rate] * DP_VOC_STEPS}
    del tr, vt
    torch.save(inputs, d / "inputs.pt")
    torchrun = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                                 "--nproc-per-node=2", str(Path(__file__).resolve()),
                                 "--dp-rank", str(d), "--seed", str(seed)])
    try:
        code = torchrun.wait(timeout=DP_RANK_LIMIT_S)
    except subprocess.TimeoutExpired:
        torchrun.terminate()  # torchrun stops its ranks
        try:
            code = torchrun.wait(timeout=60)
        except subprocess.TimeoutExpired:
            torchrun.kill()
            code = torchrun.wait()
    check(code == 0, f"phase 4j's ranks exited with {code} (or outlasted {DP_RANK_LIMIT_S} s)")
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(2)]
    ranks_s = time.perf_counter() - start
    weights = lambda st: {k: v for k, v in st.items()
                          if not k.startswith(("adam.", "encoder.codebook.")) and
                          v.is_floating_point() and k != "encoder.rnn.bias_hh_l0"}
    results = {}
    for precision in DP_PRECISIONS:
        got, other = ranks[0][precision], ranks[1][precision]
        parts = ("cpc", "voc") if "voc_losses" in got else ("cpc",)
        for key in (f"{p}_losses" for p in parts):
            check(torch.equal(got[key], other[key]), f"two ranks {precision}: {key} differ")
        for key in (f"{p}_state" for p in parts):
            diffs = _bit_diffs(got[key], other[key])
            check(not diffs, f"two ranks {precision} end with other {key}: "
                             f"{dict(list(diffs.items())[:6])}")
        kernels = precision == "bfloat16"
        for r, rank in enumerate(ranks):
            c = rank[precision]["cpc_counts"]
            v = rank[precision].get("voc_counts", {k: 0 for k in VOC_KERNELS})
            # float32 runs the recurrences' plain loops; the selection pair always.
            want = {**{k: DP_CPC_STEPS if kernels or k.startswith("cpc_select") else 0
                       for k in TRAIN_KERNELS},
                    **{k: DP_VOC_STEPS if kernels else 0 for k in VOC_KERNELS}}
            check(all({**c, **v}[k] == n for k, n in want.items()),
                  f"rank {r} {precision} launches {c} {v}, expected {want}")
            print(f"two ranks on one card (gloo) {precision}, rank {r}: launches CPC "
                  f"{json.dumps(c)}, vocoder {json.dumps(v)}  [{card}]")
        one = _dp_steps(load_conf([f"seed={seed}", f"runtime.precision={precision}"]),
                        inputs, seed)
        tol = DP_TOLERANCES[precision]
        res = {}
        for what, lr, steps in (("cpc", max(lrs), DP_CPC_STEPS),
                                ("voc", max(inputs["vlrs"]), DP_VOC_STEPS))[:len(parts)]:
            losses = got[f"{what}_losses"].double()
            ref = one[f"{what}_losses"].double()
            res[f"{what}_loss_rel"] = rel = float(((losses - ref).abs() / ref.abs()).max())
            check(rel <= tol[f"{what}_loss"], f"two ranks {precision} vs one process, {what} "
                                              f"losses {losses.tolist()} vs {ref.tolist()}")
            share, _, worst = _agreement(weights(got[f"{what}_state"]),
                                         weights(one[f"{what}_state"]), lr, steps)
            res[f"{what}_share"], res[f"{what}_worst"] = share, worst
            if tol.get(f"{what}_share") is not None:
                check(share >= tol[f"{what}_share"], f"two ranks {precision} vs one process, "
                                                     f"{what} weights within 0.1 lr: {share}")
        ema_err = 0.0
        for key in ("encoder.codebook.ema_count", "encoder.codebook.ema_weight"):
            a, r = got["cpc_state"][key].double(), one["cpc_state"][key].double()
            ema_err = max(ema_err, float(((a - r).abs() / (r.abs() + r.abs().max())).max()))
        check(ema_err <= tol["ema"], f"two ranks {precision} vs one process, EMA {ema_err}")
        res["ema_rel"] = ema_err
        results[precision] = res
        voc_steps = (f" and {DP_VOC_STEPS} vocoder steps (B 32, 16 a rank)"
                     if len(parts) == 2 else "")
        print(f"two ranks on one card (gloo) {precision}: {DP_CPC_STEPS} CPC steps (S 8, 4 a "
              f"rank){voc_steps}, eager; both ranks the same bits; against one process on the global batches: {json.dumps(res)}; "
              f"bounds {json.dumps(tol)}  [{card}]")
    print(f"two ranks on one card (gloo): the ranks' processes {ranks_s:.3f} s wall incl. "
          f"start-up; phase 4j wall {time.perf_counter() - start:.3f} s  [{card}]")
    return {"ranks": [{"cpc": r["bfloat16"]["cpc_counts"], "vocoder": r["bfloat16"]["voc_counts"]}
                      for r in ranks], "results": results}


TP_CPC_STEPS, TP_VOC_STEPS = DP_CPC_STEPS, DP_VOC_STEPS  # phase 4m's eager steps
TP_CLIP = 1e-2  # phase 4m's gradient_clip_val: far below the first step's norm, checked
# Phase 4m's bounds against one process: phase 4j's, f32 the CPU test's,
# but the bf16 CPC share of the weights within 0.1 lr set below the H100's
# reading at seed 0 (91.65 %, f32 99.985 %; its lowest tensors the CPC
# predictors, as in 4j): the row-parallel output projection sums two bf16
# partial products where one process rounds one (the JAX package's
# rounding; its own bf16 tensor-parallel test bounds the loss at rel 2e-3
# for it), and Adam turns the predictors' noise-level gradients into whole
# lr steps. The f32 run holds the collectives to the CPU test's bounds.
TP_TOLERANCES = {"float32": DP_TOLERANCES["float32"],
                 "bfloat16": {**DP_TOLERANCES["bfloat16"], "cpc_share": 0.90}}


def _tp_argv(seed: int) -> list:
    return [f"seed={seed}", f"training_vocoder.trainer.gradient_clip_val={TP_CLIP}"]


def tp_rank(d: Path, seed: int) -> None:
    """One of phase 4m's two ranks (``--tp-rank``): one model group of 2 on
    card 0 over gloo, eager steps of both trainers at each of DP_PRECISIONS
    on the whole global batches with this rank's shards; writes the
    results."""
    global DEVICE
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.parallel.mesh import mesh_from_conf

    argv = _tp_argv(seed) + ["runtime.platform=cuda:0", "runtime.mesh_model=2"]
    mesh = mesh_from_conf(load_conf(argv).runtime)
    check(mesh is not None and mesh.world == 1 and mesh.model is not None
          and mesh.model.size == 2 and mesh.device == torch.device("cuda", 0),
          f"rank mesh {mesh}")
    DEVICE = str(mesh.device)
    inputs = torch.load(d / "inputs.pt", weights_only=False)
    torch.save({p: _dp_steps(load_conf(argv + [f"runtime.precision={p}"]), inputs, seed,
                             mesh.group, mesh, mesh.model) for p in DP_PRECISIONS},
               d / f"rank{mesh.model.rank}.pt")


def _tp_compare(ranks: list, one: dict, lrs, vlrs, tol: dict) -> tuple:
    """Phase 4m's readings of one precision: the checks between the two
    model ranks (raising), then against one process (returned with the
    failures, which the caller raises after printing them)."""
    weights = lambda st: {k: v for k, v in st.items()
                          if not k.startswith(("adam.", "encoder.codebook.")) and
                          v.is_floating_point() and k != "encoder.rnn.bias_hh_l0"}
    parts = ("cpc", "voc") if "voc_losses" in ranks[0] else ("cpc",)
    res, own, failed = {}, {}, []
    for what, lr, steps in (("cpc", max(lrs), TP_CPC_STEPS),
                            ("voc", max(vlrs), TP_VOC_STEPS))[:len(parts)]:
        a, b = ranks
        check(torch.equal(a[f"{what}_losses"], b[f"{what}_losses"]), f"4m: {what} losses differ")
        diffs = _bit_diffs(a[f"{what}_state"], b[f"{what}_state"])
        check(not diffs, f"4m: the ranks gathered other {what} states: "
                         f"{dict(list(diffs.items())[:6])}")
        (rep_a, sharded, bytes_a), (rep_b, _, bytes_b) = a[f"{what}_own"], b[f"{what}_own"]
        diffs = _bit_diffs(rep_a, rep_b)
        check(not diffs and set(rep_a) == set(rep_b),
              f"4m: {what} replicated tensors differ between the model ranks: "
              f"{dict(list(diffs.items())[:6])}")
        full = one[f"{what}_state"]
        want = sum(v.numel() * v.element_size() // (2 if k in sharded else 1)
                   for k, v in full.items() if k.endswith(("exp_avg", "exp_avg_sq"))
                   or not k.startswith("adam."))
        one_bytes = one[f"{what}_own"][2]
        check(bytes_a == bytes_b == want, f"4m: {what} rank bytes {bytes_a}, {bytes_b}, "
                                          f"expected {want} of one process's {one_bytes}")
        own[what] = {"rank_bytes": bytes_a, "one_process_bytes": one_bytes,
                     "sharded_tensors": len(sharded), "replicated_tensors": len(rep_a)}
        losses, ref = a[f"{what}_losses"].double(), one[f"{what}_losses"].double()
        res[f"{what}_loss_rel"] = rel = float(((losses - ref).abs() / ref.abs()).max())
        if rel > tol[f"{what}_loss"]:
            failed.append(f"{what} losses {losses.tolist()} vs {ref.tolist()}")
        share, _, worst = _agreement(weights(a[f"{what}_state"]), weights(full), lr, steps)
        res[f"{what}_share"], res[f"{what}_worst"] = share, worst
        if share < tol[f"{what}_share"]:
            failed.append(f"{what} weights within 0.1 lr: {share}")
    ema_err = 0.0
    for key in ("encoder.codebook.ema_count", "encoder.codebook.ema_weight"):
        a, r = ranks[0]["cpc_state"][key].double(), one["cpc_state"][key].double()
        ema_err = max(ema_err, float(((a - r).abs() / (r.abs() + r.abs().max())).max()))
    res["ema_rel"] = ema_err
    if ema_err > tol["ema"]:
        failed.append(f"EMA {ema_err}")
    return res, own, failed


def phase_two_model_ranks(seed: int, card: str, d: Path) -> dict:
    """Phase 4m: one model group of two ranks on card 0 over gloo, eager
    ``train_step`` at full width, in two processes of this script
    (``--tp-rank``, through torchrun) that time-slice the card, each rank on
    the whole batch with its shards: TP_CPC_STEPS CPC steps at S 8 (bf16
    and f32) and TP_VOC_STEPS vocoder steps at B 32 x 5,120 (bf16) with the
    clip active (TP_CLIP). The ranks' replicated tensors the same bits,
    their gathered states the same; every training kernel launched once a
    step on each rank at bf16; against one process on the same batches,
    TP_TOLERANCES (losses, EMA buffers, the shares of the weights within
    0.1 lr, every weight within 2 lr a step); each rank's bytes of weights,
    VQ buffers and Adam moments beside one process's."""
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.training.cpc import CPCTrainer, fold_lstm_bias

    start = time.perf_counter()
    conf = load_conf(_tp_argv(seed))
    tr = CPCTrainer(conf, DEVICE)
    randomize(tr.encoder, np.random.default_rng(seed + 31))
    randomize(tr.cpc, np.random.default_rng(seed + 32))
    fold_lstm_bias(tr.encoder)
    vt = _voc_trainer(seed, conf)
    randomize(vt.vocoder, np.random.default_rng(seed + 41))
    mels, (utt, seq), lrs = _cpc_group(seed + 30, conf, TP_CPC_STEPS)
    cpu = lambda xs: [x.cpu() for x in xs]
    voc = [_voc_batch(seed + 40 + i, conf) for i in range(TP_VOC_STEPS)]
    grads = torch.autograd.grad(vt.loss(*voc[0]), list(vt.vocoder.parameters()))
    norm = float(torch.stack([g.float().square().sum() for g in grads]).sum().sqrt())
    check(norm > 10 * TP_CLIP, f"4m: the first vocoder step's gradient norm {norm} does not "
                               f"clip at {TP_CLIP}")
    inputs = {"encoder": {k: v.cpu() for k, v in tr.encoder.state_dict().items()},
              "cpc": {k: v.cpu() for k, v in tr.cpc.state_dict().items()},
              "vocoder": {k: v.cpu() for k, v in vt.vocoder.state_dict().items()},
              "mels": cpu(mels), "utt": cpu(utt), "seq": cpu(seq), "lrs": lrs,
              "voc": [cpu(b) for b in voc],
              "vlrs": [conf.training_vocoder.model.optim.learning_rate] * TP_VOC_STEPS}
    del tr, vt, grads
    torch.cuda.empty_cache()
    torch.save(inputs, d / "inputs.pt")
    torchrun = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                                 "--nproc-per-node=2", str(Path(__file__).resolve()),
                                 "--tp-rank", str(d), "--seed", str(seed)])
    try:
        code = torchrun.wait(timeout=DP_RANK_LIMIT_S)
    except subprocess.TimeoutExpired:
        torchrun.terminate()  # torchrun stops its ranks
        try:
            code = torchrun.wait(timeout=60)
        except subprocess.TimeoutExpired:
            torchrun.kill()
            code = torchrun.wait()
    check(code == 0, f"phase 4m's ranks exited with {code} (or outlasted {DP_RANK_LIMIT_S} s)")
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(2)]
    ranks_s = time.perf_counter() - start
    results, failed = {}, []
    for precision in DP_PRECISIONS:
        got = [r[precision] for r in ranks]
        one = _dp_steps(load_conf(_tp_argv(seed) + [f"runtime.precision={precision}"]),
                        inputs, seed)
        tol = TP_TOLERANCES[precision]
        res, own, bad = _tp_compare(got, one, lrs, inputs["vlrs"], tol)
        results[precision] = {**res, "bytes": own}
        failed += [f"{precision} {b}" for b in bad]
        kernels = precision == "bfloat16"
        want = {**{k: TP_CPC_STEPS if kernels or k.startswith("cpc_select") else 0
                   for k in TRAIN_KERNELS},
                **{k: TP_VOC_STEPS if kernels else 0 for k in VOC_KERNELS}}
        for r, rank in enumerate(got):
            c = rank["cpc_counts"]
            v = rank.get("voc_counts", {k: 0 for k in VOC_KERNELS})
            check(all({**c, **v}[k] == n for k, n in want.items()),
                  f"4m rank {r} {precision} launches {c} {v}, expected {want}")
            print(f"two model ranks on one card (gloo) {precision}, rank {r}: launches CPC "
                  f"{json.dumps(c)}, vocoder {json.dumps(v)}  [{card}]")
        voc_steps = (f" and {TP_VOC_STEPS} vocoder steps (B 32 x 5,120, clip {TP_CLIP}, "
                     f"first-step norm {norm:.4f})" if "voc_losses" in got[0] else "")
        print(f"two model ranks on one card (gloo) {precision}: {TP_CPC_STEPS} CPC steps (S 8)"
              f"{voc_steps}, eager, each rank on the whole batch with its shards; replicated "
              f"tensors and gathered states the same bits on both ranks; against one process: "
              f"{json.dumps(res)}; bounds {json.dumps(tol)}  [{card}]")
        print(f"two model ranks {precision}: bytes of weights, VQ buffers and Adam moments a "
              f"rank against one process {json.dumps(own)}  [{card}]")
    print(f"two model ranks: the ranks' processes {ranks_s:.3f} s wall incl. start-up; phase 4m "
          f"wall {time.perf_counter() - start:.3f} s  [{card}]")
    check(not failed, f"4m against one process: {failed}")
    return {"ranks": [{"cpc": r["bfloat16"]["cpc_counts"], "vocoder": r["bfloat16"]["voc_counts"]}
                      for r in ranks], "results": results}


def phase_model_one(seed: int, card: str) -> dict:
    """Phase 4n: the tensor-parallel code path at M 1, a model group of one
    rank on NCCL, through the step graph: GRAPH_CPC_STEPS CPC and
    GRAPH_VOC_STEPS vocoder steps whose model-group collectives (the
    gathers and sums of the partitioned products, the VQ argmin's gather,
    the clip's norm) are captured in the CUDA graph, the same bits as the
    trainers without a group; the graph holds each training kernel once a
    step; both step times in turns."""
    import torch.distributed as dist

    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.parallel.tensor import ModelGroup
    from vectorquantizedcpc_tpu_torch.training.cpc import CPCTrainer

    start = time.perf_counter()
    conf = load_conf([f"seed={seed}"])
    mels, negs, lrs = _cpc_group(seed, conf, GRAPH_CPC_STEPS)
    audio, vmels, spk = _voc_group(seed, conf, GRAPH_VOC_STEPS)
    vlrs = [conf.training_vocoder.model.optim.learning_rate] * GRAPH_VOC_STEPS
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    out = {}
    try:
        model = ModelGroup(dist.group.WORLD, 0, 1)
        paths = (
            ("CPC", lambda m: CPCTrainer(conf, DEVICE, None, m),
             lambda tr: tr.train_steps(mels, negs, lrs)["loss"],
             lambda tr: {"encoder": tr.encoder, "cpc": tr.cpc}, TRAIN_KERNELS, _train_counts,
             GRAPH_CPC_STEPS, lambda tr: tr.encoder_dims),
            ("vocoder", lambda m: _voc_trainer(seed, conf, None, m),
             lambda tr: tr.train_steps(audio, vmels, spk, vlrs)["loss"],
             lambda tr: {"vocoder": tr.vocoder}, VOC_KERNELS, _voc_counts, GRAPH_VOC_STEPS,
             lambda tr: tr.vocoder_dims),
        )
        for what, make, run, modules, kernels, counts, n, dims in paths:
            plain = make(None)
            loss_plain = run(plain)
            grouped = make(model)
            check(len(dims(grouped)) > 0, f"M 1 {what}: no tensor took a model dim")
            torch.cuda.synchronize()
            counts(reset=True)
            loss_group = run(grouped)
            torch.cuda.synchronize()
            launches = counts()
            graph = check_graph(grouped.graph, kernels, n, launches, f"M 1 NCCL {what}")
            a, b = _train_state(plain, modules(plain)), _train_state(grouped, modules(grouped))
            check(set(a) == set(b), f"M 1 {what}: state names differ")
            diffs = _bit_diffs(a, b)
            if not torch.equal(loss_plain, loss_group):
                diffs["loss"] = float((loss_plain - loss_group).abs().max())
            check(not diffs, f"M 1 NCCL {what}: differs from no group: "
                             f"{dict(list(diffs.items())[:6])}")
            ms = {"no group": [], "NCCL model group of 1": []}
            for label, tr in (("no group", plain), ("NCCL model group of 1", grouped)) * 3:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(tr)
                torch.cuda.synchronize()
                ms[label].append(1e3 * (time.perf_counter() - t0) / n)
            med = {k: float(np.median(v)) for k, v in ms.items()}
            out[what] = {"launches": launches, "graph": graph, "ms": med,
                         "model_dims": len(dims(grouped))}
            print(f"M 1 NCCL {what}: {n} steps through the step graph, {len(dims(grouped))} "
                  f"tensors on the model axis, their collectives inside the capture: losses, "
                  f"weights, buffers and Adam's state the same bits as without a group "
                  f"({len(a)} tensors); captured a step "
                  f"{json.dumps(graph['captured_per_step'])}; step wall ms, median of 3 runs in "
                  f"turns: no group {med['no group']:.3f} "
                  f"({', '.join(f'{x:.3f}' for x in ms['no group'])}), model group of 1 "
                  f"{med['NCCL model group of 1']:.3f} "
                  f"({', '.join(f'{x:.3f}' for x in ms['NCCL model group of 1'])})  [{card}]")
    finally:
        dist.destroy_process_group()
    print(f"phase 4n wall {time.perf_counter() - start:.3f} s  [{card}]")
    return out


def phase_serve_sharded(seed: int, card: str, serve: dict) -> dict:
    """Phase 4k: phase 4b's 48 requests, greedy bf16, through a server of
    SHARDED_SLOTS slots in 2 shards on card 0 (one decode launch per shard
    and segment, each on its shard's stream) against one shard: the same
    classes; both servers' served samples/s, second drains."""
    from vectorquantizedcpc_tpu_torch.infer.serving import ContinuousBatcher
    from vectorquantizedcpc_tpu_torch.ops import ar_decode as ar
    from vectorquantizedcpc_tpu_torch.ops import gru_train as g

    start = time.perf_counter()
    vocoder, requests, valid = serve["vocoder"], serve["requests"], serve["valid"]
    out = {}
    card0 = f"{DEVICE}:0" if DEVICE == "cuda" else DEVICE
    for label, kwargs in (("1 shard", dict(device=card0)),
                          ("2 shards", dict(devices=[card0, card0]))):
        rates = []
        for drain in range(2):
            srv = ContinuousBatcher(vocoder, slots=SHARDED_SLOTS, segment_frames=4,
                                    max_frames=2 * max(MIX_CODES) + 32, greedy=True,
                                    precision="bf16", seed=seed, **kwargs)
            torch.cuda.synchronize()
            ar.AR_DECODE_LAUNCHES = ar.AR_DECODE_INT8_LAUNCHES = 0
            g.GRU_SCAN_LAUNCHES = g.GRU_SCAN_MASKED_LAUNCHES = 0
            t0 = time.perf_counter()
            rids = [srv.submit(z, spk) for z, spk in requests]
            waves = srv.run()
            rates.append(valid / (time.perf_counter() - t0))
            launches = {"ar_decode": ar.AR_DECODE_LAUNCHES, "gru_scan": g.GRU_SCAN_LAUNCHES,
                        "gru_scan_masked": g.GRU_SCAN_MASKED_LAUNCHES,
                        "ar_decode_int8": ar.AR_DECODE_INT8_LAUNCHES}
            shards = len(kwargs.get("devices", [0]))
            steps = int(srv.stats["steps"])
            check(launches["ar_decode"] == shards * steps and launches["ar_decode_int8"] == 0,
                  f"{label}: AR launches {launches} for {steps} steps")
            check(srv.stats["samples_out"] == valid, f"{label}: samples_out")
            if drain == 0:
                out[label] = {"waves": [waves[r] for r in rids], "launches": launches,
                              "steps": steps}
        out[label]["samples_per_s"] = rates
    same = sum(np.array_equal(a, b) for a, b in zip(out["1 shard"]["waves"],
                                                     out["2 shards"]["waves"]))
    check(same == len(requests), f"2 shards vs 1 shard, greedy: {same} of {len(requests)} "
                                 "requests the same classes")
    # Sampled: the ragged PreNet's kernels once a drain (the conditioning is
    # computed on the first shard's device and copied), a decode launch per
    # shard and segment, the same waves from one seed twice.
    sampled = []
    for _ in range(2):
        srv = ContinuousBatcher(vocoder, slots=SHARDED_SLOTS, segment_frames=4,
                                max_frames=2 * max(MIX_CODES) + 32, precision="bf16",
                                seed=seed, devices=[card0, card0])
        torch.cuda.synchronize()
        ar.AR_DECODE_LAUNCHES = g.GRU_SCAN_LAUNCHES = g.GRU_SCAN_MASKED_LAUNCHES = 0
        rids = [srv.submit(z, spk) for z, spk in requests]
        waves = srv.run()
        sampled.append([waves[r] for r in rids])
        steps = int(srv.stats["steps"])
        launches = {"ar_decode": ar.AR_DECODE_LAUNCHES, "gru_scan": g.GRU_SCAN_LAUNCHES,
                    "gru_scan_masked": g.GRU_SCAN_MASKED_LAUNCHES}
        check(launches == {"ar_decode": 2 * steps, "gru_scan": 2, "gru_scan_masked": 2},
              f"2 shards sampled: launches {launches} for {steps} steps")
    check(all(np.array_equal(a, b) for a, b in zip(*sampled)),
          "2 shards sampled: two drains with one seed gave other waves")
    out["2 shards sampled"] = {"launches": launches, "steps": steps}
    for label in ("1 shard", "2 shards"):
        o = out[label]
        print(f"serve sharded, {label} on card 0, {SHARDED_SLOTS} slots, greedy bf16: "
              f"{len(requests)} requests, {valid} samples in {o['steps']} segment steps; "
              f"launches {json.dumps(o['launches'])}; served samples/s, first and second drain "
              f"{o['samples_per_s'][0]:.1f}, {o['samples_per_s'][1]:.1f}  [{card}]")
    print(f"serve sharded: 2 shards gave 1 shard's classes for {same} of {len(requests)} "
          f"requests; sampled, 2 shards launched {json.dumps(launches)} in {steps} steps and "
          f"gave the same waves twice from seed {seed}; phase 4k wall {time.perf_counter() - start:.3f} s  [{card}]")
    return {label: {k: v for k, v in o.items() if k != "waves"} for label, o in out.items()}


def phase_cli_two_cards(seed: int, card: str, d: Path) -> Optional[dict]:
    """Phase 4l: the train_cpc CLI at runtime.mesh_data=2, NCCL, one rank a
    card, on phase 4d's corpus; only where two cards are."""
    from vectorquantizedcpc_tpu_torch.cli import train_cpc

    if torch.cuda.device_count() < 2:
        print(f"phase 4l (train_cpc CLI at runtime.mesh_data=2 over NCCL) did not run: "
              f"{torch.cuda.device_count()} card on this machine, it needs 2  [{card}]")
        return None
    start = time.perf_counter()
    argv = _corpus_args(d) + [f"checkpoint_dir={d / 'ckpt_dp'}", "training.cpc.n_epochs=4",
                              "training.cpc.checkpoint_interval=4",
                              "training.cpc.log_interval=2", f"seed={seed}",
                              "runtime.mesh_data=2"]
    check(train_cpc.main(argv) is None, "the launching CLI returned a trainer")
    ckpts = sorted(p.name for p in (d / "ckpt_dp").glob("*.pt"))
    check(ckpts == ["model.ckpt-4.pt"], f"2-card checkpoints {ckpts}")
    seconds = time.perf_counter() - start
    print(f"train_cpc CLI on 2 cards (NCCL): 4 epochs x 2 steps, {ckpts}; {seconds:.3f} s "
          f"wall incl. both ranks' start-up  [{card}]")
    return {"seconds": seconds}


def phase_cli_two_cards_model(seed: int, card: str, d: Path) -> Optional[dict]:
    """Phase 4o: the train_cpc CLI at runtime.mesh_model=2, NCCL, one rank a
    card, on phase 4d's corpus; only where two cards are."""
    from vectorquantizedcpc_tpu_torch.cli import train_cpc

    if torch.cuda.device_count() < 2:
        print(f"phase 4o (train_cpc CLI at runtime.mesh_model=2 over NCCL) did not run: "
              f"{torch.cuda.device_count()} card on this machine, it needs 2  [{card}]")
        return None
    start = time.perf_counter()
    argv = _corpus_args(d) + [f"checkpoint_dir={d / 'ckpt_tp'}", "training.cpc.n_epochs=4",
                              "training.cpc.checkpoint_interval=4",
                              "training.cpc.log_interval=2", f"seed={seed}",
                              "runtime.mesh_model=2"]
    check(train_cpc.main(argv) is None, "the launching CLI returned a trainer")
    ckpts = sorted(p.name for p in (d / "ckpt_tp").glob("*.pt"))
    check(ckpts == ["model.ckpt-4.pt"], f"2-card checkpoints {ckpts}")
    seconds = time.perf_counter() - start
    print(f"train_cpc CLI on 2 cards at mesh_model 2 (NCCL): 4 epochs x 2 steps, {ckpts}; "
          f"{seconds:.3f} s wall incl. both ranks' start-up  [{card}]")
    return {"seconds": seconds}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--dp-rank", type=Path, help="run one of phase 4j's ranks (internal)")
    parser.add_argument("--tp-rank", type=Path, help="run one of phase 4m's ranks (internal)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if args.dp_rank is not None:
        dp_rank(args.dp_rank, args.seed)
        return 0
    if args.tp_rank is not None:
        tp_rank(args.tp_rank, args.seed)
        return 0

    # Phase 1: the card.
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    print(f"device: {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} visible")

    # Phase 2: build from the checkout's sources.
    from vectorquantizedcpc_tpu_torch.ops import _build

    start = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"build: {lib_path.name} in {time.perf_counter() - start:.3f} s")
    print(_build.build_log)

    # Phase 3: each kernel against its plain version.
    start = time.perf_counter()
    compared_dual = phase_compare_dual(args.seed, card)
    compared = phase_compare(args.seed, card)
    compared_int8 = phase_compare(args.seed, card, "int8")
    compared_gru = phase_compare_gru(args.seed, card)
    compared_masked_grid = phase_compare_gru_masked_grid(args.seed, card)
    compared_lstm = phase_compare_lstm(args.seed, card)
    compared_train = phase_compare_train(args.seed, card)
    compared_lstm_grid = phase_compare_lstm_grid(args.seed, card)
    compared_gru_train = phase_compare_gru_train(args.seed, card)
    print(f"phase 3: {time.perf_counter() - start:.3f} s wall")
    # Phase 4: the main paths, counts zeroed just before and read just after each.
    start = time.perf_counter()
    converted = phase_convert(args.seed, card)
    converted_int8 = phase_convert(args.seed, card, "int8")
    converted_auto = phase_convert(args.seed, card, "auto")
    serve = phase_serve(args.seed, card)
    launches, launches_int8 = serve["launches"], serve["launches_int8"]
    served_dual = phase_serve_dual(args.seed, card, serve)
    sharded = phase_serve_sharded(args.seed, card, serve)
    exported = phase_export(args.seed, card)
    with tempfile.TemporaryDirectory() as tmp:
        trained = phase_train(args.seed, card, Path(tmp))
        phase_cli_two_cards(args.seed, card, Path(tmp))
        phase_cli_two_cards_model(args.seed, card, Path(tmp))
        phase_train_step(args.seed, card)
        mid = time.perf_counter()
        trained_voc = phase_train_vocoder(args.seed, card, Path(tmp))
        print(f"phase 4e vocoder training: {time.perf_counter() - mid:.3f} s wall")
        mid = time.perf_counter()
        data_plane = phase_data_plane(args.seed, card, Path(tmp), trained, trained_voc)
        print(f"phase 4p data plane: {time.perf_counter() - mid:.3f} s wall")
        wide = phase_wide(args.seed, card, Path(tmp))
    phase_train_vocoder_step(args.seed, card)
    phase_graph_vs_eager(args.seed, card)
    world_one = phase_world_one(args.seed, card)
    with tempfile.TemporaryDirectory() as tmp:
        two_ranks = phase_two_ranks(args.seed, card, Path(tmp))
    model_one = phase_model_one(args.seed, card)
    with tempfile.TemporaryDirectory() as tmp:
        two_model = phase_two_model_ranks(args.seed, card, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        jax_ckpt = phase_jax_checkpoints(args.seed, card, Path(tmp))
        phase_async_checkpoints(args.seed, card, Path(tmp))
    from vectorquantizedcpc_tpu_torch.ops import ar_decode as ar

    from vectorquantizedcpc_tpu_torch.ops import cpc_select as cs
    from vectorquantizedcpc_tpu_torch.ops import gru_train as g
    from vectorquantizedcpc_tpu_torch.ops import lstm_scan as ls

    stamped = (ar.AR_DECODE_STAMPED_LAUNCHES, g.GRU_SCAN_TRAIN_STAMPED_LAUNCHES,
               g.GRU_SCAN_BWD_STAMPED_LAUNCHES, ls.LSTM_SCAN_STAMPED_LAUNCHES,
               ls.LSTM_SCAN_BWD_STAMPED_LAUNCHES, ls.LSTM_SCAN_GRID_STAMPED_LAUNCHES,
               ls.LSTM_SCAN_GRID_BWD_STAMPED_LAUNCHES, cs.CPC_SELECT_STAMPED_LAUNCHES,
               cs.CPC_SELECT_BWD_STAMPED_LAUNCHES)
    check(stamped == (0,) * 9, f"a main path launched a stamped kernel: {stamped}")
    print(f"phase 4: {time.perf_counter() - start:.3f} s wall; the stamped AR, GRU grid, LSTM "
          f"cluster, LSTM grid and selection kernels launched {stamped} times in phases 1-4")
    # Phase 5: times beside the bound.
    start = time.perf_counter()
    timing, ar_ms_by_batch = phase_time(args.seed, card)
    timing_dual = phase_time_dual(args.seed, card)
    stamps = phase_stamps(args.seed, card)
    gru_stamps = phase_gru_stamps(args.seed, card)
    timing_gru = phase_time_gru(args.seed, card)
    timing_masked_grid = phase_time_gru_masked_grid(args.seed, card)
    lstm_stamps = phase_lstm_stamps(args.seed, card)
    timing_lstm = phase_time_lstm(args.seed, card)
    timing_lstm_h256 = phase_time_lstm_grid_h256(args.seed, card)
    lstm_grid_stamps = phase_lstm_grid_stamps(args.seed, card)
    timing_lstm_grid = phase_time_lstm_grid(args.seed, card)
    phase_time_serve(serve, ar_ms_by_batch["bf16"], card)
    select_stamps = phase_select_stamps(args.seed, card)
    timing_train = phase_time_train(args.seed, card)
    print(f"timing train_cpc CLI (phase 4d, 2 steps an epoch, through the step graph): logged "
          f"{trained['logged_steps_per_s']} steps/s over each 5 epochs, data loading and the "
          f"group's copy included; the first group holds the warm-up and the capture  [{card}]")
    timing_voc = phase_time_vocoder(args.seed, card)
    wait = trained_voc["profiler_report"]["data_wait"][1]
    voc_ms, cpc_ms = timing_voc["step"]["ms"], timing_train["step"]["ms"]
    print(f"timing data plane: train_vocoder CLI (phase 4e) data_wait {wait:.3f} ms per step "
          f"(mean of {trained_voc['profiler_report']['data_wait'][2]}), train_dispatch "
          f"{trained_voc['profiler_report']['train_dispatch'][1]:.3f} ms, beside the vocoder "
          f"graph step {voc_ms:.3f} ms; assembly per batch (4p) CPC "
          f"{data_plane['CPC']['sample_batch']['ms']:.3f} ms by sample_batch, "
          f"{data_plane['CPC']['per_item']['ms']:.3f} ms per item, vocoder "
          f"{data_plane['vocoder']['sample_batch']['ms']:.3f} / "
          f"{data_plane['vocoder']['per_item']['ms']:.3f} ms; the train_cpc CLI (4d) logged "
          f"{trained['logged_steps_per_s']} steps/s beside the CPC graph step {cpc_ms:.3f} ms "
          f"= {1e3 / cpc_ms:.1f} steps/s  [{card}]")
    report_lstm(lstm_stamps, timing_lstm, timing_train, timing_lstm_h256, timing_voc,
                timing_masked_grid, exported, card)
    print(f"phase 5: {time.perf_counter() - start:.3f} s wall")

    source = "vectorquantizedcpc_tpu_torch/ops/csrc/"
    kernels = [
        {
            "name": "ar_decode",
            "route": "cuda",
            "source": source + "ar_decode.cu",
            "replaces": "vectorquantizedcpc_tpu/ops/ar_decode.py:218",
            "launches": launches[8]["ar_decode"],
            "launches_by_path": {
                "convert": converted["ar_decode"],
                **{f"serve_{k}_slots": v["ar_decode"] for k, v in launches.items()},
                "convert_jax_checkpoints": jax_ckpt["convert"]["ar_decode"],
                "serve_jax_checkpoints": jax_ckpt["serve"]["ar_decode"],
                "serve_8_slots_2_shards": sharded["2 shards"]["launches"]["ar_decode"],
            },
            "max_abs_err": compared["max_abs_err"],
            **timing["bf16"],
            "ms_by_batch": ar_ms_by_batch["bf16"],
            "stamps_us_per_step": stamps["bf16"],
            "library_ms": None,
        },
        {
            "name": "ar_decode_int8",
            "route": "cuda",
            "source": source + "ar_decode.cu",
            "replaces": "vectorquantizedcpc_tpu/ops/ar_decode.py:218",
            "launches": launches_int8[8]["ar_decode_int8"],
            "launches_by_path": {
                "convert_int8": converted_int8["ar_decode_int8"],
                "convert_auto": converted_auto["ar_decode_int8"],
                **{f"serve_{k}_slots": v["ar_decode_int8"] for k, v in launches_int8.items()},
                "vocoder_validation": trained_voc["launches_int8"]["ar_decode_int8"],
            },
            "max_abs_err": compared_int8["max_abs_err"],
            **timing["int8"],
            "ms_by_batch": ar_ms_by_batch["int8"],
            "stamps_us_per_step": stamps["int8"],
            "library_ms": None,
        },
        {
            "name": "dual_decode",
            "route": "cuda",
            "source": source + "dual_decode.cu",
            "replaces": None,  # the dual softmax head has no JAX counterpart
            "launches": served_dual["launches"]["dual_decode"],
            "launches_by_path": {"serve_8_slots": served_dual["launches"]["dual_decode"],
                                 "serve_8_slots_step": served_dual["launches_step"]},
            "max_abs_err": compared_dual["max_abs_err"],
            **timing_dual,
            "library_ms": None,
        },
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": source + "gru_scan.cu",
            "replaces": f"vectorquantizedcpc_tpu/ops/gru_train.py:{line}",
            "launches": launches[8][name],
            "launches_by_path": {"serve_8_slots": launches[8][name],
                                 "serve_jax_checkpoints": jax_ckpt["serve"][name],
                                 "serve_8_slots_2_shards": sharded["2 shards"]["launches"][name],
                                 "serve_8_slots_2_shards_sampled":
                                     sharded["2 shards sampled"]["launches"][name]},
            "max_abs_err": compared_gru[name],
            **timing_gru[name],
        }
        for name, line in (("gru_scan", 59), ("gru_scan_masked", 245))
    ] + [
        {
            "name": "gru_scan_masked_grid",
            "route": "cuda",
            "source": source + "gru_train.cu",
            "replaces": "vectorquantizedcpc_tpu/ops/gru_train.py:245",
            "launches": wide["serve"]["gru_scan_masked_grid"],
            "max_abs_err": compared_masked_grid,
            **timing_masked_grid,
        }
    ] + [
        {
            "name": "lstm_scan",
            "route": "cuda",
            "source": source + "lstm_scan.cu",
            "replaces": "vectorquantizedcpc_tpu/ops/lstm_scan.py:48",
            "launches": exported["launches"],
            "launches_by_path": {"export": exported["launches"],
                                 "export_jax_checkpoint": jax_ckpt["export"]["lstm_scan"]},
            "max_abs_err": compared_lstm,
            **timing_lstm["export"],
            "training_shape": timing_lstm["training"],
            "stamps_us_per_step": lstm_stamps["export"]["forward"],
            "grid_h256_ms": timing_lstm_h256["lstm_scan"],
        }
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": source + src,
            "replaces": f"vectorquantizedcpc_tpu/ops/{line}",
            "launches": trained["launches"][name],
            "launches_by_path": {"train_cpc": trained["launches"][name],
                                 "train_cpc_jax_resume": jax_ckpt["train_cpc"][name],
                                 "nccl_world_1": world_one["CPC"]["launches"][name],
                                 "two_ranks_gloo": [r["cpc"][name] for r in two_ranks["ranks"]],
                                 "nccl_model_group_1": model_one["CPC"]["launches"][name],
                                 "two_model_ranks_gloo": [r["cpc"][name]
                                                          for r in two_model["ranks"]]},
            "captured_per_step": trained["graph"]["captured_per_step"][name],
            "graph_replays": trained["graph"]["replays"],
            "max_abs_err": compared_train[name],
            **timing_train[name],
            **({"stamps_us_per_step": lstm_stamps["training"][kernel],
                "grid_h256_ms": timing_lstm_h256[name]} if kernel else {}),
            **({"stamps_us": select_stamps[stamped]} if stamped else {}),
        }
        for name, src, line, kernel, stamped in (
            ("lstm_scan_train", "lstm_scan.cu", "lstm_scan.py:48", "training forward", None),
            ("lstm_scan_bwd", "lstm_scan.cu", "lstm_scan.py:105", "backward", None),
            ("cpc_select", "cpc_select.cu", "cpc_select.py:65", None, "forward"),
            ("cpc_select_bwd", "cpc_select.cu", "cpc_select.py:106", None, "backward"),
        )
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": source + "gru_train.cu",
            "replaces": f"vectorquantizedcpc_tpu/ops/gru_train.py:{line}",
            "launches": trained_voc["launches"][name],
            "launches_by_path": {"train_vocoder": trained_voc["launches"][name],
                                 "train_vocoder_jax_resume": jax_ckpt["train_vocoder"][name],
                                 "nccl_world_1": world_one["vocoder"]["launches"][name],
                                 "two_ranks_gloo": [r["vocoder"][name]
                                                    for r in two_ranks["ranks"]],
                                 "nccl_model_group_1": model_one["vocoder"]["launches"][name],
                                 "two_model_ranks_gloo": [r["vocoder"][name]
                                                          for r in two_model["ranks"]]},
            "captured_per_step": trained_voc["graph"]["captured_per_step"][name],
            "graph_replays": trained_voc["graph"]["replays"],
            "max_abs_err": compared_gru_train[name],
            **timing_voc[name],
            "stamps_us_per_step": gru_stamps[kernel],
        }
        for name, line, kernel in (("gru_scan_train", 59, "forward"),
                                   ("gru_scan_bwd", 114, "backward"))
    ] + [
        {
            "name": "lstm_scan_grid",
            "route": "cuda",
            "source": source + "lstm_grid.cu",
            "replaces": "vectorquantizedcpc_tpu/ops/lstm_scan.py:48",
            "launches": wide["train"]["lstm_scan_grid_train"] + wide["export"]["lstm_scan_grid"],
            "launches_by_path": {"train_cpc_512": wide["train"]["lstm_scan_grid_train"],
                                 "export_512": wide["export"]["lstm_scan_grid"]},
            "captured_per_step": wide["graph"]["captured_per_step"]["lstm_scan_grid_train"],
            "graph_replays": wide["graph"]["replays"],
            "max_abs_err": compared_lstm_grid["lstm_scan_grid"],
            **timing_lstm_grid["lstm_scan_grid"],
            "stamps_us_per_step": lstm_grid_stamps["forward"],
        },
        {
            "name": "lstm_scan_grid_bwd",
            "route": "cuda",
            "source": source + "lstm_grid.cu",
            "replaces": "vectorquantizedcpc_tpu/ops/lstm_scan.py:105",
            "launches": wide["train"]["lstm_scan_grid_bwd"],
            "captured_per_step": wide["graph"]["captured_per_step"]["lstm_scan_grid_bwd"],
            "graph_replays": wide["graph"]["replays"],
            "max_abs_err": compared_lstm_grid["lstm_scan_grid_bwd"],
            **timing_lstm_grid["lstm_scan_grid_bwd"],
            "stamps_us_per_step": lstm_grid_stamps["backward"],
        },
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
