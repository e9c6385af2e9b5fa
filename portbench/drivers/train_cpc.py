"""CPC encoder training: epoch groups assembled on the host while the card runs.

The program's ``CPCTrainer`` (encoder, VQ-EMA codebook, context LSTM, CPC
predictors and Adam, drawn from the seed) is driven as its ``train_model``
loop drives it: each group of ``epochs_per_dispatch`` epochs is assembled
from ``CPCMelSpkDataset`` through ``PrefetchLoader`` (S speakers a batch, U
clips each), with each step's negatives from ``sample_negative_indices``
on a generator seeded per epoch, staged in one ``stage`` copy and stepped
through ``train_steps`` (the CUDA graph of the step). Nothing waits for the
card between groups, so the next group is assembled while the card runs the
last. ``cpc_frames_per_s`` is S x U x clip mel frames a step over the
window, from its start to the end of the device's work.
"""

import torch
from torch.profiler import record_function

from ..lib import harness, inputs, program, training
from ..lib.trace import Tracer
from ..reference import feed as ref_feed
from ..reference import lowp
from ..reference import train as ref_train

CHECK_STEPS = 3


def run(run) -> None:
    from vectorquantizedcpc_tpu_torch.data.datasets import CPCMelSpkDataset
    from vectorquantizedcpc_tpu_torch.data.loader import PrefetchLoader
    from vectorquantizedcpc_tpu_torch.models.cpc import sample_negative_indices
    from vectorquantizedcpc_tpu_torch.training.cpc import CPCTrainer, negatives_generator
    from vectorquantizedcpc_tpu_torch.training.step_graph import stage

    t = run.traffic
    control = getattr(run, "control", False)
    conf = program.port_conf(run.config, {
        "training.cpc.epochs_per_dispatch": t["epochs_per_dispatch"],
        "runtime.precision": t["precision"]})
    cc = conf.model.cpc
    s, u = cc.n_speakers_per_batch, cc.n_utterances_per_speaker
    clip = conf.data.dataset.cpc.clip_length_mel
    length = clip // 2 - cc.n_prediction_steps // 2
    lr = t["lr"]
    data_dir = run.workdir / "features"
    inputs.write_features(data_dir, run.config["corpus"], run.seed,
                          conf.data.dataset.mel_stft_stride, conf.sampling_rate,
                          conf.dim_mel_freq, mulaw=False)
    loader_seed = inputs.sub_seed(run.seed, "loader") % (1 << 31)
    trainer = CPCTrainer(conf, run.device)
    enc_state = inputs.fill_from_seed(trainer.encoder, inputs.sub_seed(run.seed, "encoder"),
                                      zero=("rnn.bias_hh_l0",))
    cpc_state = inputs.fill_from_seed(trainer.cpc, inputs.sub_seed(run.seed, "cpc"))
    start = dict(enc_state, **cpc_state)
    dataset = CPCMelSpkDataset(True, conf.data.dataset, data_dir, seed=loader_seed)
    loader = PrefetchLoader(dataset, batch_size=s, shuffle=True, drop_last=True,
                            seed=loader_seed)
    steps_per_epoch = len(loader)

    def assemble(epochs):
        """A group's batches and negatives, as ``train_model`` assembles them."""
        mels, utts, seqs = [], [], []
        for e in epochs:
            loader.set_epoch(e)
            gen = negatives_generator(loader_seed, e, run.device)
            it = iter(loader)
            try:
                for m, _spk in it:
                    utt, seq = sample_negative_indices(cc, length, gen, run.device)
                    mels.append(m)
                    utts.append(utt)
                    seqs.append(seq)
            finally:
                it.close()
        return mels, utts, seqs

    def dispatch(mels, utts, seqs):
        return trainer.train_steps(stage(mels, run.device),
                                   (torch.stack(utts), torch.stack(seqs)), [lr] * len(mels))

    named = {n: p for n, p in list(trainer.encoder.named_parameters())
             + list(trainer.cpc.named_parameters()) if n != "rnn.bias_hh_l0"}
    losses, fed, grads = [], [], None
    if not control:
        # Set-up: epoch 1's first three steps, one at a time, through the
        # window's call and feed (two eager, then the capture).
        mels, utts, seqs = assemble([1])
        for i in range(CHECK_STEPS):
            fed.append([mels[i]])
            losses.append(float(dispatch(mels[i:i + 1], utts[i:i + 1], seqs[i:i + 1])
                                ["loss"][0]))
            if i == 0:
                grads = training.first_gradient(trainer.optimizer, named)
        after = {k: v.detach().float().cpu().clone() for k, v in
                 list(trainer.encoder.state_dict().items()) + list(trainer.cpc.state_dict().items())}
        neg_fed = (utts[:CHECK_STEPS], seqs[:CHECK_STEPS])
    harness.device_sync(run.device)

    tracer = Tracer(run.trace, run.device, t["trace"]["start_s"], t["trace"]["length_s"])
    run.tracer = tracer
    epd = t["epochs_per_dispatch"]
    lstm_call = {"T": clip // 2, "B": s * u, "H": conf.dim_cpc_context}
    select_call = {"K": cc.n_prediction_steps // 2, "S": s, "U": u, "N": cc.n_negatives,
                   "L": length, "Z": conf.dim_latent}
    steps, wait_s, traced_steps, traced_wait, epoch = 0, 0.0, 0, 0.0, 2
    t0 = run.window_start = harness.clock()
    while not control and harness.clock() - t0 < run.seconds:
        tracer.tick(harness.clock() - t0)
        w0 = harness.clock()
        with record_function("bench.assemble"):
            group = assemble(range(epoch, epoch + epd))
        w = harness.clock() - w0
        with record_function("bench.train_steps"):
            dispatch(*group)
        n = len(group[0])
        steps += n
        wait_s += w
        epoch += epd
        if tracer.active:
            traced_steps += n
            traced_wait += w
            run.calls.setdefault("lstm_scan", []).extend([lstm_call] * n)
            run.calls.setdefault("cpc_select", []).extend([select_call] * n)
    harness.device_sync(run.device)
    t_end = harness.clock()
    tracer.close()
    run.memory_peak_bytes = harness.peak_memory(run.device)
    run.attempted = steps
    run.e2e["cpc_frames_per_s"] = steps * s * u * clip / max(t_end - t0, 1e-9)
    run.counters.update(conf=run.config["conf"], steps=steps, data_wait_s=wait_s,
                        traced_steps=traced_steps, traced_wait_s=traced_wait,
                        clips=s * u, frames=clip, steps_per_epoch=steps_per_epoch)
    run.note(f"{steps} steps in {t_end - t0:.3f} s; assembly {wait_s:.3f} s")

    del trainer
    if torch.device(run.device).type == "cuda":
        torch.cuda.empty_cache()
    dev = run.device
    feat = ref_feed.Features(data_dir)
    gen = ref_feed.negatives_generator(loader_seed, 1, dev)
    ref_batches, ref_negs = [], []
    for b in range(CHECK_STEPS):
        mels_b = ref_feed.cpc_batch(feat, loader_seed, 1, b, s, u, clip)
        utt, seq = ref_feed.negatives(gen, cc.n_prediction_steps // 2, s, u, cc.n_negatives,
                                      length, dev)
        ref_batches.append((torch.from_numpy(mels_b).to(dev), utt, seq))
        ref_negs.append((utt, seq))
    state_dev = {k: v.to(dev) for k, v in start.items()}
    t_ref = harness.clock()
    ref = ref_train.cpc_steps( state_dev, ref_batches,
                                [lr] * CHECK_STEPS, s, cc.n_prediction_steps)
    if control:
        losses, grads, after = ref_train.cpc_steps(state_dev, ref_batches, [lr] * CHECK_STEPS,
                                                   s, cc.n_prediction_steps, lowp.fp8_mm)
        fed = [[b[0].cpu().numpy()] for b in ref_batches]
        neg_fed = ([n[0] for n in ref_negs], [n[1] for n in ref_negs])
    checks, leaves = training.judge(losses, grads, after, ref[0], ref[1], ref[2], start)
    feed = training.feed_check(
        fed + [[a.cpu().numpy(), b.cpu().numpy()] for a, b in zip(*neg_fed)],
        [[b[0].cpu().numpy()] for b in ref_batches]
        + [[a.cpu().numpy(), b.cpu().numpy()] for a, b in ref_negs])
    checks.append(feed)
    run.judged(checks)
    run.note(f"losses {losses} reference {ref[0]}; {leaves}; reference took "
             f"{harness.clock() - t_ref:.3f} s")
