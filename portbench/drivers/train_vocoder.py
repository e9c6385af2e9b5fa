"""Vocoder training: the step graph fed by the prefetch loader, for the window.

The program's ``VocoderTrainer`` (vocoder and Adam beside a frozen encoder,
all drawn from the seed) takes batches of B clips (mu-law samples, mels,
speakers) from the program's ``MulawMelSpkDataset.sample_batch`` through
its ``PrefetchLoader``, over features written from the seed, staged by the
program's ``stage`` and stepped through ``train_steps`` (the CUDA graph of
the whole step), groups of ``steps_per_dispatch`` steps as the trainer's
loop dispatches them. No validation and no save run in the window.
``vocoder_samples_per_s`` is B x clip x hop samples a step over the window,
from its start to the end of the device's work after its last dispatch.

Judged (``lib/training.py``): the three set-up steps from the seed, and,
once the window has closed, two more replays of the step graph from the
state the window left, on the feed's next batches; and Adam's step count
against the steps dispatched.
"""

import torch
from torch.profiler import record_function

from ..lib import harness, inputs, program, training
from ..lib.trace import Tracer
from ..reference import feed as ref_feed
from ..reference import lowp
from ..reference import train as ref_train

CHECK_STEPS = 3  # set-up steps judged
WINDOW_CHECK_STEPS = 2  # replays judged after the window


def _batches(loader):
    epoch = 0
    while True:
        epoch += 1
        loader.set_epoch(epoch)
        it = iter(loader)
        try:
            for b, item in enumerate(it):
                yield epoch, b, item
        finally:
            it.close()


def run(run) -> None:
    from vectorquantizedcpc_tpu_torch.data.datasets import MulawMelSpkDataset
    from vectorquantizedcpc_tpu_torch.data.loader import PrefetchLoader
    from vectorquantizedcpc_tpu_torch.training.step_graph import stage
    from vectorquantizedcpc_tpu_torch.training.vocoder import VocoderTrainer

    t = run.traffic
    spd = t["steps_per_dispatch"]
    conf = program.port_conf(run.config, {"training_vocoder.trainer.steps_per_dispatch": spd,
                                          "runtime.precision": t["precision"]})
    hop, clip = conf.data.dataset.mel_stft_stride, conf.data.dataset.clip_length_mel
    size = conf.data.loader.batch_size
    lr = conf.training_vocoder.model.optim.learning_rate
    data_dir = run.workdir / "features"
    inputs.write_features(data_dir, run.config["corpus"], run.seed, hop, conf.sampling_rate,
                          conf.dim_mel_freq, mulaw=True)
    loader_seed = inputs.sub_seed(run.seed, "loader") % (1 << 31)
    encoder, enc_state = program.seeded_encoder(conf, run.seed, run.device, frozen=True)
    trainer = VocoderTrainer(conf, encoder, run.device)
    voc_state = inputs.fill_from_seed(trainer.vocoder, inputs.sub_seed(run.seed, "vocoder"))
    dataset = MulawMelSpkDataset(True, conf.data.dataset, data_dir, seed=loader_seed)
    loader = PrefetchLoader(dataset, batch_size=size, shuffle=True, drop_last=True,
                            seed=loader_seed)
    feed = _batches(loader)

    def dispatch(group):
        audio, mel, spk = (stage([b[i] for b in group], run.device) for i in range(3))
        return trainer.train_steps(audio, mel, spk, [lr] * len(group))["loss"]

    def judged_steps(count, before=None):
        """(fed (epoch, batch, arrays), losses, first gradient, parameters
        after) of ``count`` single steps through the window's call and feed."""
        fed, losses, grads = [], [], None
        for step in range(count):
            epoch, b, item = next(feed)
            fed.append((epoch, b, [x.copy() for x in item]))
            losses.append(float(dispatch([item])[0]))
            if step == 0:
                grads = training.first_gradient(trainer.optimizer, params, before)
        return fed, losses, grads, {k: p.detach().float().cpu().clone()
                                    for k, p in params.items()}

    # Set-up: three single steps (two eager, then the capture), judged.
    params = dict(trainer.vocoder.named_parameters())
    setup = judged_steps(CHECK_STEPS)
    harness.device_sync(run.device)

    tracer = Tracer(run.trace, run.device, t["trace"]["start_s"], t["trace"]["length_s"])
    run.tracer = tracer
    call = {"T": clip * hop, "B": size,
            "H": conf.training_vocoder.model.network.rnnms.wave_ar.size_h_rnn}
    steps, wait_s, traced_steps, traced_wait = 0, 0.0, 0, 0.0
    t0 = run.window_start = harness.clock()
    while harness.clock() - t0 < run.seconds:
        tracer.tick(harness.clock() - t0)
        w0 = harness.clock()
        with record_function("bench.assemble"):
            group = [next(feed)[2] for _ in range(spd)]
        w = harness.clock() - w0
        with record_function("bench.train_steps"):
            dispatch(group)
        steps += spd
        wait_s += w
        if tracer.active:
            traced_steps += spd
            traced_wait += w
            run.calls.setdefault("gru_train", []).extend([call] * spd)
    harness.device_sync(run.device)
    t_end = harness.clock()
    tracer.close()
    run.memory_peak_bytes = harness.peak_memory(run.device)
    # The window's path: two more replays from the state the window left.
    state = training.optimizer_state(trainer.optimizer, params)
    window = judged_steps(WINDOW_CHECK_STEPS, state["exp_avg"])
    feed.close()
    step_off = abs(state["step"] - (CHECK_STEPS + steps))
    run.attempted = steps
    run.e2e["vocoder_samples_per_s"] = steps * size * clip * hop / max(t_end - t0, 1e-9)
    run.counters.update(conf=run.config["conf"], steps=steps, data_wait_s=wait_s,
                        traced_steps=traced_steps, traced_wait_s=traced_wait,
                        batch=size, samples=clip * hop)
    run.note(f"{steps} steps in {t_end - t0:.3f} s; data wait {wait_s:.3f} s")

    del trainer, encoder
    if torch.device(run.device).type == "cuda":
        torch.cuda.empty_cache()
    feat = ref_feed.Features(data_dir)
    dev = run.device
    enc_dev = {k: v.to(dev) for k, v in enc_state.items()}
    clip_val = conf.training_vocoder.trainer.gradient_clip_val
    control = getattr(run, "control", False)
    checks, t_ref = [harness.Check("adam_step_off", step_off, 0)], harness.clock()
    stages = [("setup", "", setup, voc_state, None),
              ("window", "window_", window, state["params"],
               (state["exp_avg"], state["exp_avg_sq"], state["step"]))]
    for stage_name, prefix, (fed, losses, grads, after), start, adam in stages:
        if stage_name not in getattr(run, "judge_stages", ("setup", "window")):
            continue
        ref_batches = [ref_feed.vocoder_batch(feat, loader_seed, e, b, size, clip, hop)
                       for e, b, _ in fed]
        as_dev = [tuple(torch.from_numpy(x).to(dev) for x in rb) for rb in ref_batches]
        start_dev = {k: v.to(dev) for k, v in start.items()}
        lrs = [lr] * len(fed)
        ref = ref_train.vocoder_steps(start_dev, enc_dev, as_dev, lrs, hop, clip_val,
                                      adam_state=adam)
        if control:  # the reference in float8 in the program's place
            losses, grads, after = ref_train.vocoder_steps(start_dev, enc_dev, as_dev, lrs,
                                                           hop, clip_val, lowp.fp8_mm, adam)
            fed = [(e, b, rb) for (e, b, _), rb in zip(fed, ref_batches)]
        stage_checks, leaves = training.judge(losses, grads, after, ref[0], ref[1], ref[2],
                                              start, prefix)
        checks += stage_checks
        checks.append(training.feed_check([f[2] for f in fed], ref_batches,
                                          prefix + "feed_off"))
        run.note(f"{prefix}losses {losses} reference {ref[0]}; {leaves}")
    run.judged(checks)
    run.note(f"Adam's step count {state['step']} after {CHECK_STEPS} + {steps} steps; the "
             f"reference took {harness.clock() - t_ref:.3f} s")
