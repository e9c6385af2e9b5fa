"""Continuous batching of utterances over the AR decode kernel.

The counterpart of the JAX package's ``infer/serving.py``. The AR decode is
latency-bound: a step at B = 8 costs about what it costs at B = 1, so a
server should always decode a full batch. A fixed pool of decode **slots**
advances together through fixed **segments** of ``segment_frames``
conditioning frames (``segment_frames * hop`` samples), one launch of the
AR decode kernel per segment (``fused_ar_decode_segment``), which hands the
state (h, prev) on to the next. A stream retires the moment its frames are
consumed and a queued request takes the freed slot mid-flight. The AR
recursion is causal and per row, so what other slots hold never changes a
stream's samples: chaining segments reproduces a single-shot decode.

- :meth:`ContinuousBatcher.run`, the planned drain: request lengths are
  known at submission, so which request occupies which slot at which
  segment is computed on the host up front (``compute_drain_schedule``,
  longest request first into the slot that frees first). The conditioning
  of every queued request is built in one pass into staging rows; each
  schedule step then resets the fresh slots, gathers every slot's window
  of conditioning and launches one segment. Each segment's samples are
  copied to the host as its launch ends, on a side stream into a small
  ring of pinned slots (``STAGING_SLOTS``), and written into their
  requests' waveforms between later launches, while the card decodes:
  only the last segments are left for :meth:`~ContinuousBatcher.result`.
- :meth:`ContinuousBatcher.step`, the incremental mode: admission into
  freed slots, one segment across all slots, retirement.

Spans (``utils/profiling.py``): ``serving.condition`` (a conditioning
pass), ``serving.launch`` (one segment's host pass, with its ``segment``),
``serving.admit`` (one admission of ``step()``, with its ``rid``),
``serving.fetch`` (the host's wait for samples on their way to it: a
drain segment's copy, or a request of ``step()``) and ``serving.expand``
(samples into waveforms: a drain segment's pieces, with its ``segment``,
or a request of ``step()``, with its ``rid``).

Sampling noise differs from segment to segment: the launch of global
segment k gets the seed ``segment_seed(seed, k)``.

The vocoder's head decides the decode (``ops/heads.py``, picked once): a
vocoder with the dual softmax head (``rnnms.output=dual16``) is served the
same way through ``ops/dual_decode.py``: the segments hand on (h, c_prev,
f_prev), the samples are 16-bit (256 c + f), ``result`` joins them into
linear PCM, (256 c + f) / 32767.5 - 1, and ``stats["samples_out"]`` counts
16-bit samples. It decodes in bf16 only ("int8" and "auto" raise) and on
one device.

``devices=[...]`` shards the slots over several devices, one decode launch
per shard and segment (the JAX server's ``mesh=``; ``ContinuousBatcher``).
"""

import contextlib
import heapq
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device
from ..models.vocoder import (
    Vocoder,
    build_conditioning_frames,
    build_conditioning_frames_ragged,
)
from ..ops.ar_decode import (  # noqa: F401 (DecodeState: the benchmark's faults build it here)
    MAX_BATCH,
    DecodeState,
    fused_ar_decode_segment,
    project_cond_frames,
    segment_seed,
)
from ..ops.dual_decode import fused_dual_decode_segment
from ..ops.heads import Dual16Head, decode_head
from ..utils.profiling import span

__all__ = ["ContinuousBatcher", "compute_drain_schedule"]

# Pinned host slots per shard that a drain's segments are copied into. A slot
# is reused once the host has taken the segment in it, so the host queues at
# most this many segments ahead of the last one it took: on the card, three
# stay queued behind the one that runs while the host waits for a slot.
STAGING_SLOTS = 4


def compute_drain_schedule(s_count, sf, hop, slots_live, queued, rid_row):
    """Drain schedule tables (a copy of the JAX package's).

    Each slot runs its requests back to back; the queue, in its order, goes
    into the slot that frees first, ties to the lower slot index (an
    (end_step, slot) min-heap).

    Args:
        s_count: number of slots; sf: segment frames; hop: samples per frame.
        slots_live: per slot ``[rid, row, pos, total]`` or None (requests
            already in a slot; they run from step 0).
        queued: ``(rid, row, total)`` in admission order.
        rid_row: rid -> conditioning row.
    Returns:
        (rows_t (n_steps, slots) int32 with -1 for idle, pos_t int32,
         fresh_t bool, rid_sched {rid: (slot, first_step, nseg)},
         rid_pos0 {rid: 0} for the queued rids, valid sample count)
    """
    assigns = []  # (rid, slot, start_step, pos0, total, is_new)
    ends = [0] * s_count
    for i in range(s_count):
        a = slots_live[i]
        if a is not None:
            rid, _row, pos0, total = a
            assigns.append((rid, i, 0, pos0, total, False))
            ends[i] = -(-(total - pos0) // sf)
    heap = [(ends[i], i) for i in range(s_count)]
    heapq.heapify(heap)
    for rid, _row, total in queued:
        t0, i = heapq.heappop(heap)
        assigns.append((rid, i, t0, 0, total, True))
        heapq.heappush(heap, (t0 + -(-total // sf), i))
    n_steps = max(
        (t0 + -(-(total - pos0) // sf) for _rid, _i, t0, pos0, total, _n in assigns),
        default=0,
    )
    rows_t = np.full((n_steps, s_count), -1, np.int32)
    pos_t = np.zeros((n_steps, s_count), np.int32)
    fresh_t = np.zeros((n_steps, s_count), np.bool_)
    rid_sched = {}
    rid_pos0 = {}
    valid = 0
    for rid, i, t0, pos0, total, is_new in assigns:
        nseg = -(-(total - pos0) // sf)
        rows_t[t0 : t0 + nseg, i] = rid_row[rid]
        pos_t[t0 : t0 + nseg, i] = pos0 + sf * np.arange(nseg)
        if is_new:
            fresh_t[t0, i] = True
            rid_pos0[rid] = 0
        rid_sched[rid] = (i, t0, nseg)
        valid += (total - pos0) * hop
    return rows_t, pos_t, fresh_t, rid_sched, rid_pos0, valid


@dataclass
class _Slot:
    rid: Optional[int] = None
    pos_frames: int = 0
    total_frames: int = 0


def _to_host(classes: torch.Tensor) -> np.ndarray:
    return classes.cpu().numpy()


@dataclass
class _Drain:
    """A planned drain's tables, for placing its segments' samples: the
    conditioning row and frame position of every (step, slot), each row's
    rid, the global index of its first segment, and ``last``, the events
    after its last launch on each shard (None until that launch is queued;
    each None on the CPU)."""

    rows_t: np.ndarray
    pos_t: np.ndarray
    row_rid: Dict[int, int]
    first_segment: int
    last: Optional[list] = None

    def decoding(self) -> bool:
        """Whether the last launch has not yet completed on the device."""
        return self.last is None or not all(e is None or e.query() for e in self.last)


@dataclass
class _Landing:
    """A shard's samples of one drain step (rows of the shard, sf * hop) on
    the host (``host``), or on their way there: ``done`` is the copy's event
    (None on the CPU: there at once), ``decoded`` the launch's output, held
    until the copy is done."""

    drain: _Drain
    step: int
    shard: "_Shard"
    host: np.ndarray
    done: Optional[torch.cuda.Event] = None
    decoded: Optional[torch.Tensor] = None

    def landed(self) -> bool:
        return self.done is None or self.done.query()


class _Shard:
    """One device's slots ``[first, first + n)``: its decode weights, pool of
    conditioning rows, output buffer and decode state, (on a card, when
    there are several shards) its own stream, and (on a card) the side
    stream and pinned slots that a drain's segments are copied through."""

    def __init__(self, index: int, device: torch.device, first: int, n: int,
                 weights, max_frames: int, hop: int, seg_samples: int, head,
                 own_stream: bool):
        self.index, self.device, self.first, self.n = index, device, first, n
        self.weights = weights
        hidden, proj3h = weights.wh.shape
        self.pool = torch.zeros(n, max_frames, proj3h, dtype=torch.bfloat16, device=device)
        self.out_buf = torch.zeros(n, max_frames * hop, dtype=torch.int32, device=device)
        self.state = head.init_state(n, hidden, device)
        on_card = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if own_stream and on_card else None
        self.copies = torch.cuda.Stream(device) if on_card else None
        # (sf * hop, rows): the kernels' own (steps, rows) order, so each
        # copy is one contiguous transfer.
        self.staging = [torch.empty(seg_samples, n, dtype=torch.int32, pin_memory=True)
                        for _ in range(STAGING_SLOTS if on_card else 0)]
        self.staged = 0  # copies queued: the next fills slot staged % STAGING_SLOTS
        self.untaken = 0  # landings the host has not taken: each holds its slot

    def mark(self) -> Optional[torch.cuda.Event]:
        """An event after the launches queued so far (None on the CPU)."""
        if self.copies is None:
            return None
        event = torch.cuda.Event()
        event.record(self.stream if self.stream is not None
                     else torch.cuda.current_stream(self.device))
        return event

    @contextlib.contextmanager
    def launching(self):
        """Work queued inside runs on this shard's stream, after everything
        queued before on its device."""
        if self.stream is None:
            yield
            return
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            yield

    def join(self) -> None:
        """The device's stream waits for this shard's queued work (so that
        what it frees is never reused under a pending read)."""
        if self.stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self.stream)


def _weights_on(weights, device: torch.device):
    return type(weights)(*(t.to(device) if isinstance(t, torch.Tensor) else t for t in weights))


class ContinuousBatcher:
    """Continuous-batching decode server over a fixed slot pool.

    >>> server = ContinuousBatcher(vocoder, slots=8)
    >>> rid = server.submit(z_indices, speaker)   # enqueue
    >>> waves = server.run()                      # drain -> {rid: wave}

    Runs on ``device``, else on the CUDA card; raises without a card unless
    ``device="cpu"`` (the kernels' plain versions). The vocoder is moved
    there. ``greedy=True`` decodes by argmax, deterministically.
    ``precision`` "auto" resolves at every launch's batch: the slots of a
    shard.

    Sharded (``devices=[...]``, the JAX server's ``mesh=``): the slots
    divide over the devices, shard j holding slots ``[j slots / D, (j + 1)
    slots / D)`` with its own pool, decode state and output buffer on
    device j. A segment step queues every shard's decode launch, each on
    its shard's own stream, before anything waits; no collective runs in
    the loop. The schedule and the conditioning rows are computed once, on
    the first device (copied to the others), so greedy output is the
    one-device server's. Sampling folds the shard index into each
    segment's seed, as JAX folds the axis index into its key: shards draw
    other noise for the same request, from the same seed.
    """

    def __init__(
        self,
        vocoder: Vocoder,
        slots: int = 8,
        segment_frames: int = 32,
        max_frames: int = 2048,
        precision: str = "bf16",
        greedy: bool = False,
        seed: int = 0,
        device: Optional[Union[str, torch.device]] = None,
        devices: Optional[Sequence[Union[str, torch.device]]] = None,
    ):
        if devices is not None and device is not None:
            raise ValueError("give device or devices, not both")
        devices = [resolve_device(d) for d in (devices if devices else [device])]
        n_shards = len(devices)
        if slots % n_shards:
            raise ValueError(f"slots={slots} must divide over the {n_shards} devices")
        per = slots // n_shards
        self._device = devices[0]
        self._head = decode_head(vocoder.conf.rnnms, precision, self._device)
        if n_shards > 1 and not self._head.shardable:
            raise ValueError(f"rnnms.output={vocoder.conf.rnnms.output} serves on one device; "
                             "sharded serving is RNN_MS's")
        # The plain version (CPU) takes any slot count, as the JAX server does.
        if per < 1 or any(d.type == "cuda" for d in devices) and per > MAX_BATCH:
            raise ValueError(
                f"slots={slots}: a server needs at least one slot, and on the card "
                f"the AR decode kernel takes at most {MAX_BATCH} rows a shard "
                "(kMaxBatch in ops/csrc/ar_decode.cu)"
            )
        self._vocoder = vocoder.to(self._device).eval()
        conf = vocoder.conf.rnnms
        self._slots = slots
        self._per_shard = per
        self._segment_frames = segment_frames
        self._max_frames = max_frames + segment_frames  # slack for the last segment
        self._hop = conf.upsampling_t
        self._greedy = greedy
        self._seed = seed
        self._weights = self._head.prep_weights(self._vocoder, per)
        by_device = {self._device: self._weights}
        self._shards = []
        for j, d in enumerate(devices):
            if d not in by_device:
                by_device[d] = _weights_on(self._weights, d)
            self._shards.append(_Shard(j, d, j * per, per, by_device[d], self._max_frames,
                                       self._hop, segment_frames * self._hop, self._head,
                                       n_shards > 1))
        self._slot_meta = [_Slot() for _ in range(slots)]
        self._queue: Deque[tuple] = deque()
        # step()'s finished rids -> their classes on the device
        self._pending: Dict[int, torch.Tensor] = {}
        # A drain's segments not yet taken by the host, in launch order, and
        # its unfinished rids -> [waveform (None until its first piece lands),
        # pieces still to come, samples]
        self._landings: Deque[_Landing] = deque()
        self._streaming: Dict[int, list] = {}
        self._results: Dict[int, np.ndarray] = {}
        self._next_rid = 0
        self._submitted: Dict[int, float] = {}  # rid -> host clock at submit, until admitted
        self._step_count = 0
        self._samples_out = 0
        self._dispatch_wall = 0.0
        self._admitted = 0
        self._queue_wait = 0.0
        self._expanded_in_flight = 0

    # ------------------------------------------------------------------ API

    def submit(self, z_indices, speaker: int) -> int:
        """Enqueue an utterance (codes (Tz,) + target speaker); returns its rid.

        Over-length requests are refused here, before anything is in flight.
        """
        z = np.asarray(z_indices, np.int64)
        total_frames = 2 * z.shape[0]
        capacity = self._max_frames - self._segment_frames
        if total_frames > capacity:
            raise ValueError(f"utterance of {total_frames} frames exceeds max_frames={capacity}")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append((rid, z, int(speaker)))
        self._submitted[rid] = time.perf_counter()
        return rid

    @torch.no_grad()
    def step(self) -> List[int]:
        """Admit into free slots, decode one segment across all slots, retire.

        Returns the rids that finished in this step. Does not wait for the
        device; fetch finished waves with :meth:`result` or :meth:`run`.
        """
        self._admit()
        live = [i for i, s in enumerate(self._slot_meta) if s.rid is not None]
        if not live:
            return []
        start = time.perf_counter()
        sf, hop = self._segment_frames, self._hop
        classes = []
        with span("serving.launch", segment=self._step_count):
            for shard in self._shards:
                with shard.launching():
                    seg = self._gather(
                        [(shard.pool, i) for i in range(shard.n)],
                        [s.pos_frames
                         for s in self._slot_meta[shard.first: shard.first + shard.n]],
                    )
                    out, shard.state = self._decode_segment(
                        shard.weights, seg, shard.state,
                        self._launch_seed(self._step_count, shard),
                    )
                    classes.append(out)
            for shard in self._shards:
                shard.join()
        self._step_count += 1
        finished: List[int] = []
        for i in live:
            slot = self._slot_meta[i]
            shard, row = self._shard_of(i)
            p = slot.pos_frames * hop
            shard.out_buf[row, p : p + sf * hop] = classes[shard.index][row]
            self._samples_out += min(slot.total_frames - slot.pos_frames, sf) * hop
            slot.pos_frames += sf
            if slot.pos_frames >= slot.total_frames:
                self._pending[slot.rid] = shard.out_buf[row, : slot.total_frames * hop].clone()
                finished.append(slot.rid)
                self._slot_meta[i] = _Slot()
        self._dispatch_wall += time.perf_counter() - start
        return finished

    def result(self, rid: int) -> np.ndarray:
        """A finished stream's float32 waveform (waits for the device).

        A request of a drain whose last segments the host has not taken yet
        takes them, in launch order, until the request is whole."""
        if rid in self._pending:
            with span("serving.fetch"):
                classes = _to_host(self._pending.pop(rid))
            with span("serving.expand", rid=rid):
                self._results[rid] = self._head.to_wave(classes)
        while rid in self._streaming:
            self._take()
        return self._results[rid]

    def run(self, materialize: bool = True, wait: bool = True) -> Dict[int, np.ndarray]:
        """Drain the queue and every stream in flight (planned drain).

        The drain writes each segment's samples into their requests'
        waveforms as its launches complete, but for the last segments.
        ``materialize=False`` leaves those to :meth:`result` and returns
        only the waveforms finished before the call; ``wait=False`` also
        skips the final synchronisation with the card, so the call returns
        once every launch is queued.
        """
        returned = dict(self._results)
        if self._queue or any(s.rid is not None for s in self._slot_meta):
            self._drain_planned(wait)
        if not materialize:
            return returned
        while self._landings:
            self._take()
        for rid in list(self._pending):
            self.result(rid)
        return dict(self._results)

    @property
    def stats(self) -> Dict[str, float]:
        """Counters since the server was made, each a sum, so that two
        snapshots subtract: ``steps`` (segments launched), ``samples_out``
        (requests' samples decoded), ``dispatch_wall_s`` (host seconds in
        ``step()`` and the planned drain), ``admitted`` (requests taken from
        the queue: into a slot by ``step()``, into the plan by ``run()``),
        ``queue_wait_s`` (their host seconds from ``submit``) and
        ``expanded_in_flight`` (drain samples written into their waveforms
        before the drain's last launch had completed on the device)."""
        return {
            "samples_out": float(self._samples_out),
            "dispatch_wall_s": self._dispatch_wall,
            "steps": float(self._step_count),
            "admitted": float(self._admitted),
            "queue_wait_s": self._queue_wait,
            "expanded_in_flight": float(self._expanded_in_flight),
        }

    # ------------------------------------------------------------ internals

    def _shard_of(self, slot: int):
        """(the shard holding ``slot``, the slot's row in that shard)."""
        return self._shards[slot // self._per_shard], slot % self._per_shard

    def _decode_segment(self, weights, seg, state, seed):
        """One segment's launch: (classes or 16-bit samples, the state after).
        The head's segment decode is looked up in this module at each call,
        so that swapping the module's name swaps the launch (the benchmark's
        planted faults and controls do)."""
        launch = (fused_dual_decode_segment if isinstance(self._head, Dual16Head)
                  else fused_ar_decode_segment)
        return launch(weights, seg, state, seed, self._hop, self._greedy)

    def _launch_seed(self, segment: int, shard: _Shard) -> int:
        """The seed of a shard's launch of global segment ``segment``: the
        shard index folded in when there are several."""
        seed = segment_seed(self._seed, segment)
        return seed if len(self._shards) == 1 else segment_seed(seed, shard.index)

    def _land(self, shard: _Shard, drain: _Drain, step: int, classes: torch.Tensor) -> None:
        """Send a launch's samples (rows of the shard, sf * hop) to the host:
        on a card, a copy into the shard's next pinned slot on its side
        stream, after the launch, which the next launches do not wait for;
        on the CPU they are there."""
        shard.untaken += 1
        if shard.copies is None:
            self._landings.append(_Landing(drain, step, shard, classes.numpy()))
            return
        host = shard.staging[shard.staged % STAGING_SLOTS]
        shard.staged += 1
        shard.copies.wait_stream(torch.cuda.current_stream(shard.device))
        with torch.cuda.stream(shard.copies):
            host.copy_(classes.t(), non_blocking=True)
            done = torch.cuda.Event()
            done.record(shard.copies)
        self._landings.append(_Landing(drain, step, shard, host.numpy().T, done, classes))

    def _free_slot(self, shard: _Shard) -> None:
        """Take landings until the shard's next pinned slot is free (the host
        takes each shard's in the order they were staged): the one wait on
        the card while launches remain to queue."""
        while shard.staging and shard.untaken >= STAGING_SLOTS:
            self._take()

    def _take_landed(self) -> None:
        """Take the landings whose copies are done, in launch order."""
        while self._landings and self._landings[0].landed():
            self._take()

    def _take(self) -> None:
        """Take the oldest landing (waiting for its copy) and write each live
        row's piece into its request's waveform, at its frame position; a
        request whose last piece this is is finished."""
        landing = self._landings.popleft()
        with span("serving.fetch"):
            if landing.done is not None:
                landing.done.synchronize()
        drain, shard, k = landing.drain, landing.shard, landing.step
        seg_samples = landing.host.shape[1]
        with span("serving.expand", segment=drain.first_segment + k):
            decoding = drain.decoding()
            cols = slice(shard.first, shard.first + shard.n)
            expanded = 0
            for row, (r, pos) in enumerate(zip(drain.rows_t[k, cols], drain.pos_t[k, cols])):
                if r < 0:
                    continue
                rid = drain.row_rid[r]
                entry = self._streaming[rid]
                if entry[0] is None:  # here, while the card decodes: a job's thousands
                    # of allocations in the plan would hold back its first launch
                    entry[0] = np.empty(entry[2], np.float32)
                wave, off = entry[0], pos * self._hop
                piece = landing.host[row, : min(seg_samples, wave.shape[0] - off)]
                wave[off : off + piece.shape[0]] = self._head.to_wave(piece)
                expanded += piece.shape[0]
                entry[1] -= 1
                if not entry[1]:
                    self._results[rid] = wave
                    del self._streaming[rid]
            if decoding:
                self._expanded_in_flight += expanded
        shard.untaken -= 1

    def _gather(self, rows, positions) -> torch.Tensor:
        """Every slot's (sf, 3H) window: rows[i] = (buffer, row), at positions[i]."""
        sf = self._segment_frames
        return torch.stack([buf[r, p : p + sf] for (buf, r), p in zip(rows, positions)])

    def _condition(self, zs: np.ndarray, speakers: np.ndarray, n_frames=None) -> torch.Tensor:
        """Codes -> staging rows (G, 2 max_codes + pad, 3H) bf16 on the first
        device; the width is a multiple of the segment, so every window of a
        valid row fits."""
        with span("serving.condition"):
            z = torch.from_numpy(zs).to(self._device)
            spk = torch.from_numpy(speakers).to(self._device)
            if n_frames is None:
                cond = build_conditioning_frames(self._vocoder, z, spk)
            else:
                nf = torch.from_numpy(n_frames).to(self._device)
                cond = build_conditioning_frames_ragged(
                    self._vocoder, z, spk, nf, use_kernel=True
                ).float()
            rows = project_cond_frames(self._weights, cond)
            pad = -rows.shape[1] % self._segment_frames
            return torch.nn.functional.pad(rows, (0, 0, 0, pad))

    def _admitted_now(self, rids) -> None:
        """Count ``rids`` as taken from the queue, with their waits."""
        now = time.perf_counter()
        for rid in rids:
            self._queue_wait += now - self._submitted.pop(rid)
            self._admitted += 1

    def _admit(self) -> None:
        for i, slot in enumerate(self._slot_meta):
            if slot.rid is not None or not self._queue:
                continue
            rid, z, speaker = self._queue.popleft()
            with span("serving.admit", rid=rid):
                self._admitted_now([rid])
                shard, row = self._shard_of(i)
                cond = self._condition(z[None], np.asarray([speaker]))[0, : 2 * z.shape[0]]
                shard.pool[row].zero_()
                shard.pool[row, : cond.shape[0]] = cond.to(shard.device)
                self._head.reset_row(shard.state, row)
                self._slot_meta[i] = _Slot(rid=rid, pos_frames=0, total_frames=2 * z.shape[0])

    @torch.no_grad()
    def _drain_planned(self, wait: bool) -> None:
        start = time.perf_counter()
        s_count, sf, hop = self._slots, self._segment_frames, self._hop
        inflight = [
            (i, m.rid, m.pos_frames, m.total_frames)
            for i, m in enumerate(self._slot_meta)
            if m.rid is not None
        ]
        new_reqs = list(self._queue)
        self._queue.clear()
        self._admitted_now([rid for rid, _z, _s in new_reqs])

        # Staging rows: the slots in flight (rows 0..slots-1, in their
        # shards' pools), then the conditioning of every new request.
        row_loc = []  # global row -> (buffer, row in buffer)
        rid_row: Dict[int, int] = {}
        rid_total: Dict[int, int] = {}
        if inflight:
            for i in range(s_count):
                shard, row = self._shard_of(i)
                row_loc.append((shard.pool, row))

        def add_rows(items, buf):
            for j, (rid, z, _spk) in enumerate(items):
                rid_row[rid] = len(row_loc)
                rid_total[rid] = 2 * z.shape[0]
                row_loc.append((buf, j))

        if new_reqs and not self._greedy:
            # One ragged pass over every queued request: the PreNet kernels.
            mc = max(z.shape[0] for _r, z, _s in new_reqs)
            zs = np.zeros((len(new_reqs), mc), np.int64)
            for j, (_rid, z, _spk) in enumerate(new_reqs):
                zs[j, : z.shape[0]] = z
            spks = np.asarray([s for _r, _z, s in new_reqs], np.int64)
            n_frames = np.asarray([2 * z.shape[0] for _r, z, _s in new_reqs], np.int64)
            add_rows(new_reqs, self._condition(zs, spks, n_frames))
        elif new_reqs:
            # Greedy: per-length groups through the f32 PreNet, the single
            # shot's arithmetic.
            groups: Dict[int, list] = {}
            for item in new_reqs:
                groups.setdefault(item[1].shape[0], []).append(item)
            for n_codes in sorted(groups):
                items = groups[n_codes]
                zs = np.stack([z for _r, z, _s in items])
                spks = np.asarray([s for _r, _z, s in items], np.int64)
                add_rows(items, self._condition(zs, spks))

        slots_live: List[Optional[list]] = [None] * s_count
        rid_pos0: Dict[int, int] = {}
        for i, rid, pos, total in inflight:
            slots_live[i] = [rid, i, pos, total]
            rid_row[rid] = i
            rid_total[rid] = total
            rid_pos0[rid] = pos
        # Longest first: the drain ends when the last slot does.
        queued = sorted(
            ((rid, rid_row[rid], rid_total[rid]) for rid, _z, _s in new_reqs),
            key=lambda q: -q[2],
        )
        rows_t, pos_t, fresh_t, rid_sched, pos0_map, valid = compute_drain_schedule(
            s_count, sf, hop, slots_live, queued, rid_row
        )
        rid_pos0.update(pos0_map)

        copies: Dict[tuple, torch.Tensor] = {}  # staging rows copied to another shard's device

        def on(buf: torch.Tensor, device: torch.device) -> torch.Tensor:
            if buf.device == device:
                return buf
            key = (id(buf), device)
            if key not in copies:
                copies[key] = buf.to(device)
            return copies[key]

        drain = _Drain(rows_t, pos_t, {r: rid for rid, r in rid_row.items()}, self._step_count)
        for rid, (slot, _s0, nseg) in rid_sched.items():
            n, pos0, wave = rid_total[rid] * hop, rid_pos0[rid], None
            if pos0 or not nseg:
                wave = np.empty(n, np.float32)
            if pos0:  # what the request decoded before the drain
                shard, row = self._shard_of(slot)
                wave[: pos0 * hop] = self._head.to_wave(_to_host(shard.out_buf[row, : pos0 * hop]))
            if nseg:
                self._streaming[rid] = [wave, nseg, n]
            else:
                self._results[rid] = wave

        for k in range(rows_t.shape[0]):
            for shard in self._shards:
                self._free_slot(shard)
            with span("serving.launch", segment=self._step_count + k):
                for shard in self._shards:
                    cols = slice(shard.first, shard.first + shard.n)
                    with shard.launching():
                        for row in np.flatnonzero(fresh_t[k, cols]):
                            self._head.reset_row(shard.state, row)
                        # Idle slots (row -1) decode their own pool's row 0;
                        # nothing reads their samples.
                        rows = [(on(row_loc[r][0], shard.device), row_loc[r][1]) if r >= 0
                                else (shard.pool, 0) for r in rows_t[k, cols]]
                        seg = self._gather(rows, pos_t[k, cols].tolist())
                        classes, shard.state = self._decode_segment(
                            shard.weights, seg, shard.state,
                            self._launch_seed(self._step_count + k, shard),
                        )
                        self._land(shard, drain, k, classes)
            if k == rows_t.shape[0] - 1:
                drain.last = [shard.mark() for shard in self._shards]
            self._take_landed()
        for shard in self._shards:
            shard.join()

        if wait:
            for d in {shard.device for shard in self._shards if shard.device.type == "cuda"}:
                torch.cuda.synchronize(d)
        self._step_count += rows_t.shape[0]
        self._samples_out += valid
        self._dispatch_wall += time.perf_counter() - start
        self._slot_meta = [_Slot() for _ in range(s_count)]
