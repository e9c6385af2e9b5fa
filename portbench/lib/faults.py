"""Faults planted in the timed path, which the judge must catch.

``planted(cell, fault)`` swaps one function of the program for a broken
one while the block runs:

- ``state_unchanged``: a step that hands its state on unchanged (the
  decode's carry between segments; Adam's update);
- ``half_batch``: half of the batch left out, the mean taken over the rest
  (the decode runs half the slots; a training step's second half of rows
  repeats its first);
- ``altered_token``: a token altered where it is produced (one class a
  row and segment; a training step's loss, as the step returns it, 5 %
  off);
- ``stale_batch`` (training on a card only): the step graph's replays
  train on the batch it was captured with, not on the batch they are
  given (the set-up steps are sound; the window's are not).

The drivers' tests plant them on the CPU; ``readings.py --fault`` plants
them on the card to read the judged numbers they give (``stale_batch``
only there: the CPU has no graph).
"""

import contextlib

import torch

FAULTS = ("state_unchanged", "half_batch", "altered_token")
CARD_FAULTS = ("stale_batch",)


def _serving(fault):
    from vectorquantizedcpc_tpu_torch.infer import serving as srv

    real = srv.fused_ar_decode_segment

    def broken(weights, cond, state, seed, hop, greedy=False):
        if fault == "half_batch":
            half = cond.shape[0] // 2
            classes, new = real(weights, cond[:half],
                                srv.DecodeState(state.h[:half], state.prev[:half]), seed, hop,
                                greedy)
            full = torch.full((cond.shape[0], classes.shape[1]), 128, dtype=classes.dtype,
                              device=classes.device)
            full[:half] = classes
            h, prev = state.h.clone(), state.prev.clone()
            h[:half], prev[:half] = new.h, new.prev
            return full, srv.DecodeState(h, prev)
        classes, new = real(weights, cond, state, seed, hop, greedy)
        if fault == "state_unchanged":
            return classes, state
        classes = classes.clone()
        classes[:, 5] = (classes[:, 5] + 1) % 256
        return classes, new

    return [(srv, "fused_ar_decode_segment", broken)]


def _stale_batch():
    from vectorquantizedcpc_tpu_torch.training import step_graph as sg

    real = sg.StepGraph.step

    def broken(self, inputs, lr):
        graph = self._graphs.get(tuple((tuple(x.shape), x.dtype) for x in inputs))
        if graph is None:
            return real(self, inputs, lr)
        sg.set_lr(self.optimizer, lr)
        graph.graph.replay()
        self.replays += 1
        return {k: v.clone() for k, v in graph.outputs.items()}

    return [(sg.StepGraph, "step", broken)]


def _training(cell, fault):
    if fault == "stale_batch":
        return _stale_batch()
    if fault == "state_unchanged":
        return [(torch.optim.Adam, "step", lambda self, closure=None: None)]
    if "vocoder" in cell:
        from vectorquantizedcpc_tpu_torch.training.vocoder import VocoderTrainer as trainer
    else:
        from vectorquantizedcpc_tpu_torch.training.cpc import CPCTrainer as trainer
    real = trainer._step

    def broken(self, *inputs):
        if fault == "half_batch":
            cut = []
            for i, x in enumerate(inputs):
                if "cpc" in cell and i == 1:
                    cut.append(x)  # the utterance indices serve every speaker
                    continue
                axis = 1 if ("cpc" in cell and i == 2) else 0
                half = x.shape[axis] // 2
                x = x.clone()
                x.narrow(axis, half, half).copy_(x.narrow(axis, 0, half))
                cut.append(x)
            return real(self, *cut)
        out = real(self, *inputs)
        out["loss"] = out["loss"] * 1.05
        return out

    return [(trainer, "_step", broken)]


@contextlib.contextmanager
def planted(cell: str, fault: str):
    if fault not in FAULTS + CARD_FAULTS:
        raise ValueError(f"unknown fault {fault!r}: {FAULTS + CARD_FAULTS}")
    patches = _serving(fault) if "serve" in cell else _training(cell, fault)
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    try:
        for obj, name, new in patches:
            setattr(obj, name, new)
        yield
    finally:
        for obj, name, old in saved:
            setattr(obj, name, old)
