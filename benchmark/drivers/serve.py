"""Serving driver: one client keeping ``in_flight`` studies in flight,
in-memory int16 volumes, closed loop.

The client hands a host int16 volume to ``infer.predict_device`` on the
runner that ``infer.make_runner`` builds (on-device windowing, the
window gather, the chunked forwards, the Gaussian stitch, the argmax),
which queues the volume's device work and returns; while the card works
through the studies in flight, the host queues the next one, and only
then takes the oldest study's label crop to host memory.  That is the
serving CLI's own pipeline (``infer.serve_volumes`` queues the next
volume while a writer downloads the last), in one thread.  A request's
latency runs from the hand-off until its labels are in host memory.
Requests started in the window count; the window ends when the last of
them completes, and the rate is all of them over all its time.

Traffic keys: ``volume_shape``, ``stride`` (factor of the roi),
``coverage`` (``crop`` or ``pad``), ``chunk`` (null: the runner's
default), ``in_flight`` (studies queued on the card at once), ``pool``
(distinct volumes; request ``k`` serves volume ``k % pool``),
``warmup_s`` (seconds of requests before the window: the card's clocks
and the host settle), ``trace_units`` and ``label_units`` (volumes of
the traced run's passes, at the same load), ``sample`` (finished
volumes checked against the reference), ``limits``.

Checked: a sample of the finished volumes, drawn from the seed.  The
reference (``benchmark/reference``, fp32) stitches the same volume's
class probabilities; ``prob_gap`` is the widest gap, over every voxel,
by which the probability of the served label lies below the reference's
best.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from benchmark import arith, common, generate
from benchmark.reference import model as ref_model
from benchmark.reference import serve as ref_serve


def _runner_args(cell):
    t = cell.traffic
    conf = cell.hparams()
    return conf, dict(chunk=t.get("chunk"), stride=float(t["stride"]),
                      device_windowing=True, coverage=t["coverage"])


def _template(conf):
    return ref_model.SwinUnetR(ref_model.model_keys(conf))


def inputs(cell):
    """(weights seed, host volumes) of the cell's seed."""
    t = cell.traffic
    vols = generate.ct_volumes(cell.sub_seed("volumes"), int(t["pool"]),
                               tuple(t["volume_shape"]), common.DEVICE)
    return cell.sub_seed("weights"), vols


def forward_calls(cell, n_windows: int):
    """The window batch of each forward of one volume."""
    chunk = cell.traffic.get("chunk")
    chunk = int(chunk) if chunk else (n_windows if n_windows <= 32 else 16)
    return [min(chunk, n_windows - i) for i in range(0, n_windows, chunk)]


class Client:
    """The closed loop: ``depth`` studies in flight, request numbers in
    order, ``predict(volume)`` queuing one study's device work and
    returning its label crop on the device."""

    def __init__(self, depth: int, predict, volumes):
        self.depth = depth
        self.predict = predict
        self.volumes = volumes
        self.next = 0

    def run(self, deadline=None, total=None, done=None, events=None):
        """Serve requests until ``deadline`` (none started after it) or
        until ``total`` have started; ``done(k, t0, t1, labels)`` for
        each, in order.  Returns the host clock when the last one
        completed."""
        first, end = self.next, None
        flight = deque()
        while True:
            more = (total is None or self.next - first < total) and \
                (deadline is None or time.perf_counter() < deadline)
            if more and len(flight) < self.depth:
                k = self.next
                self.next += 1
                if events is not None:
                    events.mark("volume")
                t0 = time.perf_counter()
                flight.append((k, t0, self.predict(
                    self.volumes[k % len(self.volumes)])))
                continue
            if not flight:
                return end
            k, t0, crop = flight.popleft()
            labels = crop.cpu().numpy()
            end = time.perf_counter()
            if done is not None:
                done(k, t0, end, labels)


def run(cell) -> common.Outcome:
    from medical_image_segmentation_with_visual_prompts_tpu_torch import infer
    t = cell.traffic
    conf, kw = _runner_args(cell)
    roi = tuple(conf["roi_size"])
    wseed, volumes = inputs(cell)
    model = infer.build_model(conf, device=common.DEVICE)
    model.load_state_dict(generate.weights(_template(conf), wseed,
                                           common.DEVICE))
    runner = infer.make_runner(conf, model, **kw)
    _, _, starts = ref_serve.plan(volumes[0].shape, roi, kw["stride"],
                                  kw["coverage"])
    n_windows = len(starts)

    def predict(vol):
        return infer.predict_device(runner, roi, vol)[0]

    client = Client(int(t["in_flight"]), predict, volumes)
    client.run(deadline=time.perf_counter() + float(t["warmup_s"]))
    client.run(total=client.depth)      # at least the pipeline's depth
    common.sync()
    setup_end = time.perf_counter()
    sample = common.Sample(int(t["sample"]), cell.sub_seed("sample"))
    lat, metrics, ctx = [], {}, None

    def done(k, t0, t1, labels):
        lat.append(t1 - t0)
        sample.offer(k, labels)

    if cell.trace:
        def units(n, events):
            client.run(total=n, done=done, events=events)

        events = common.ForwardEvents(model)
        ctx = common.traced(units, int(t["trace_units"]),
                            int(t["label_units"]), events)
        ctx["forward_ms"] = [common.ForwardEvents.forward_ms(u)
                             for u in events.units("volume")]
        ctx["per_unit"] = "volume"
        calls = forward_calls(cell, n_windows)
        ctx["model_flops_per_unit"] = sum(arith.forward_flops(conf, b, roi)
                                          for b in calls)
        ctx["b1_work_per_unit"] = [w for b in calls
                                   for w in arith.b1_work(conf, b, roi)]
    else:
        t_start = time.perf_counter()
        t_end = client.run(deadline=t_start + cell.seconds, done=done)
        metrics = {"volumes_per_s": len(lat) / (t_end - t_start),
                   "volume_latency_p95_ms": 1e3 * float(np.percentile(lat,
                                                                      95))}
    n = len(lat)
    peak = common.memory_peak()
    del runner, model, client
    common.free_memory()
    gap = check(cell, wseed, volumes, sample.items)
    limits = cell.traffic["limits"]
    return common.Outcome(
        {k: v for k, v in metrics.items() if k in cell.end_to_end},
        {"prob_gap": (gap, limits["prob_gap"])}, n, 0, peak, setup_end, ctx)


def reference_net(cell, wseed, arith_mode: str):
    conf, _ = _runner_args(cell)
    return ref_model.reference_model(
        conf, generate.weights(_template(conf), wseed, common.DEVICE),
        common.DEVICE, ref_model.Arith(arith_mode))


def reference_probs(cell, net, volume):
    conf, kw = _runner_args(cell)
    with ref_model.strict_fp32():
        return ref_serve.stitched_probs(net, volume, tuple(conf["roi_size"]),
                                        kw["stride"], kw["coverage"],
                                        common.DEVICE)[0]


def check(cell, wseed, volumes, served) -> float:
    """Widest probability gap of the served labels ``[(request, labels)]``
    under the fp32 reference."""
    net = reference_net(cell, wseed, "fp32")
    worst = 0.0
    by_volume = {}
    for req, labels in served:
        by_volume.setdefault(req % len(volumes), []).append(labels)
    for v, labels_list in sorted(by_volume.items()):
        probs = reference_probs(cell, net, volumes[v])
        best = probs.max(-1).values
        for labels in labels_list:
            if tuple(labels.shape) != tuple(probs.shape[:3]):
                return 1.0
            got = torch.as_tensor(labels.astype(np.int64),
                                  device=probs.device)
            if int(got.max()) >= probs.shape[-1] or int(got.min()) < 0:
                return 1.0
            chosen = probs.gather(-1, got[..., None])[..., 0]
            worst = max(worst, float((best - chosen).max()))
        del probs, best
        common.free_memory()
    return worst


def control(cell) -> float:
    """``prob_gap`` of the reference in fp8 put in the program's place,
    on as many volumes as a run checks."""
    wseed, volumes = inputs(cell)
    net = reference_net(cell, wseed, "fp8")
    served = []
    for v in range(min(int(cell.traffic["sample"]), len(volumes))):
        probs = reference_probs(cell, net, volumes[v])
        served.append((v, probs.argmax(-1).to(torch.uint8).cpu().numpy()))
        del probs
    del net
    common.free_memory()
    return check(cell, wseed, volumes, served)
