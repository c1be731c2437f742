"""Serving driver of MedSAM: one client keeping ``in_flight`` box-prompted
studies in flight, in-memory int16 volumes, closed loop.

A request is a study: a volume and one 3D box ``(x0, y0, x1, y1, z0,
z1)``.  The client hands both to ``infer.predict_device(runner, None,
volume, box=box)`` on the runner that ``infer.make_runner`` builds for a
MedSAM model (the raw upload windowed on the device, the box's slices
resized to 1024^2, the encoder in batches of ``slice_batch`` slices, the
prompt encoder and the mask decoder over all of them, sigmoid, bilinear
resize, threshold, paste), which queues the study's device work and
returns; the client queues the next study and only then takes the
oldest study's label volume to host memory (``drivers/serve.py``'s
``Client``).  Latency and the window as there.

Traffic keys: ``volume_shape``, ``pool`` (distinct volumes),
``boxes_per_volume`` (request ``k`` serves box ``k % (pool x
boxes_per_volume)``, of volume ``that // boxes_per_volume``),
``box_slices`` (consecutive slices a box spans, from a seeded start),
``box_side`` (the least and the most pixels of a box's x and y sides,
drawn inside the slice), ``in_flight``, ``warmup_s``, ``trace_units``,
``label_units``, ``sample``, ``limits``.

Checked: ``sample`` of the finished studies, drawn from the seed.  The
reference (``benchmark/reference/medsam.py``, fp32, TF32 off) computes
MedSAM's probabilities slice by slice on the card; ``prob_gap`` is the
widest gap, over every voxel of the box's slices, by which the
reference's probability of the served label lies below the reference's
best.  A study with a label outside its box's slices reads 1.  A study
whose reference masks are degenerate is rejected: each label must hold
5 % or more of the box's pixels, or the check could not see a wrong
answer there (the seeded weights segment no anatomy, and a box inside
the uniform bright ellipsoid can come out all one label).  The draw
keeps ``SPARE`` times ``sample`` studies in its seeded order and checks
the first ``sample`` that are not rejected; with fewer, ``prob_gap``
reads 1.

The traced run also records CUDA events at the hooks of the image
encoder, around the prompt encoder and the mask decoder, and around
each encoder block's attention core (after its ``qkv`` projection,
before its ``proj``): ``forward_ms`` (encoder, prompt encoder and mask
decoder per study), ``image_encoder_ms``, ``mask_decoder_ms`` and
``attn_ms`` per study, which the per-layer metrics read.
"""

from __future__ import annotations

# First: the parent of the commit that added MedSAM has no such module,
# and fails here, within seconds.
from medical_image_segmentation_with_visual_prompts_tpu_torch.models \
    import sam as _sam  # noqa: F401,I001

import time

import numpy as np
import torch

from benchmark import arith_medsam, common, generate
from benchmark.drivers.serve import Client
from benchmark.reference import medsam as ref

DEGENERATE = 0.05       # least share of a box's pixels each label holds
SPARE = 3               # studies drawn per checked study


def requests(cell) -> list:
    """The cell's distinct requests ``[(volume index, box)]``, drawn from
    the seed."""
    t = cell.traffic
    h, w, d = t["volume_shape"]
    n, (lo, hi) = int(t["box_slices"]), t["box_side"]
    rng = np.random.default_rng(cell.sub_seed("boxes"))
    out = []
    for v in range(int(t["pool"])):
        for _ in range(int(t["boxes_per_volume"])):
            z0 = int(rng.integers(0, d - n + 1))
            sx, sy = (int(s) for s in rng.integers(lo, hi + 1, size=2))
            x0 = int(rng.integers(0, w - sx + 1))
            y0 = int(rng.integers(0, h - sy + 1))
            out.append((v, (x0, y0, x0 + sx, y0 + sy, z0, z0 + n)))
    return out


def inputs(cell):
    """(weights seed, host volumes, requests) of the cell's seed."""
    t = cell.traffic
    vols = generate.ct_volumes(cell.sub_seed("volumes"), int(t["pool"]),
                               tuple(t["volume_shape"]), common.DEVICE)
    return cell.sub_seed("weights"), vols, requests(cell)


def weights(conf: dict, seed: int, device) -> dict:
    """A state dict under segment_anything's names, drawn from ``seed``:
    ``generate.weights``' rules, then the LayerNorm2d scales 1 + 0.1 N and
    shifts 0.1 N, the absolute position embedding 0.02 N and the Fourier
    matrix N(0, 1) (SAM's own draw).  Last, two means taken out, so that
    no seed gives every mask one offset (all one label: the check could
    not read it): the upscaler's last transposed conv is made zero-mean
    over its input channels (the GELU above it has a positive mean), and
    the last layer of each hypernetwork MLP zero-sum over its outputs (a
    mask's logit is their product with the upscaled embedding)."""
    with torch.device("meta"):
        template = ref.MedSAM(conf)
    state = generate.weights(template, seed, device)
    gen = torch.Generator(device=device).manual_seed(int(seed) ^ 0x5A17)
    norms2d = {f"{name}.{leaf}" for name, mod in template.named_modules()
               if isinstance(mod, ref.LayerNorm2d)
               for leaf in ("weight", "bias")}
    for name in sorted(state):
        if name in norms2d:
            base, sd = (1.0 if name.endswith("weight") else 0.0), 0.1
        elif name.endswith("pos_embed"):
            base, sd = 0.0, 0.02
        elif name.endswith("positional_encoding_gaussian_matrix"):
            base, sd = 0.0, 1.0
        else:
            continue
        state[name] = base + sd * torch.randn(state[name].shape,
                                              generator=gen, device=device)
    up = "mask_decoder.output_upscaling.3.weight"
    state[up] = state[up] - state[up].mean(0, keepdim=True)
    dec = template.mask_decoder
    for i, hyper in enumerate(dec.output_hypernetworks_mlps):
        last = f"mask_decoder.output_hypernetworks_mlps.{i}.layers." \
            f"{len(hyper.layers) - 1}"
        for leaf in (".weight", ".bias"):
            t = state[last + leaf]
            state[last + leaf] = t - t.mean(0, keepdim=True)
    return state


class SamEvents:
    """CUDA events at the model's hooks (none off the card, as in the
    harness's CPU tests): the image encoder's entry and exit, the prompt
    encoder's entry and the mask decoder's exit, and each encoder block's
    attention core (after ``qkv``, before ``proj``)."""

    def __init__(self, model):
        self.marks: list = []
        self.handles = []
        if common.DEVICE != "cuda":
            return
        enc = model.image_encoder
        hooks = [(enc.register_forward_pre_hook, "enc0"),
                 (enc.register_forward_hook, "enc1"),
                 (model.prompt_encoder.register_forward_pre_hook, "dec0"),
                 (model.mask_decoder.register_forward_hook, "dec1")]
        for blk in enc.blocks:
            hooks += [(blk.attn.qkv.register_forward_hook, "att0"),
                      (blk.attn.proj.register_forward_pre_hook, "att1")]
        self.handles = [reg(self._mark(tag)) for reg, tag in hooks]

    def _mark(self, tag):
        def hook(*_args, **_kw):
            evt = torch.cuda.Event(enable_timing=True)
            evt.record()
            self.marks.append((tag, evt))
        return hook

    def mark(self, tag: str) -> None:
        self.marks.append((tag, None))

    def remove(self) -> None:
        for h in self.handles:
            h.remove()
        self.handles = []

    def per_unit(self, start: str, end: str) -> list:
        """Per ``volume`` unit, the summed ms from each ``start`` event to
        the next ``end`` event."""
        out, open_evt = [], None
        for tag, evt in self.marks:
            if tag == "volume":
                out.append(0.0)
            elif tag == start:
                open_evt = evt
            elif tag == end and open_evt is not None and out:
                out[-1] += open_evt.elapsed_time(evt)
                open_evt = None
        return out


def run(cell) -> common.Outcome:
    from medical_image_segmentation_with_visual_prompts_tpu_torch import infer
    t = cell.traffic
    conf = cell.hparams()
    wseed, volumes, reqs = inputs(cell)
    model = infer.build_model(conf, device=common.DEVICE)
    model.load_state_dict(weights(conf, wseed, common.DEVICE))
    runner = infer.make_runner(conf, model)

    def predict(req):
        v, box = req
        return infer.predict_device(runner, None, volumes[v], box=box)[0]

    client = Client(int(t["in_flight"]), predict, reqs)
    client.run(deadline=time.perf_counter() + float(t["warmup_s"]))
    client.run(total=client.depth)
    common.sync()
    setup_end = time.perf_counter()
    sample = common.Sample(SPARE * int(t["sample"]), cell.sub_seed("sample"))
    lat, metrics, ctx = [], {}, None

    def done(k, t0, t1, labels):
        lat.append(t1 - t0)
        sample.offer(k, labels)

    if cell.trace:
        def units(n, events):
            client.run(total=n, done=done, events=events)

        events = SamEvents(model)
        ctx = common.traced(units, int(t["trace_units"]),
                            int(t["label_units"]), events)
        enc = events.per_unit("enc0", "enc1")
        dec = events.per_unit("dec0", "dec1")
        ctx.update(image_encoder_ms=enc, mask_decoder_ms=dec,
                   attn_ms=events.per_unit("att0", "att1"),
                   forward_ms=[a + b for a, b in zip(enc, dec)],
                   per_unit="study")
        n = int(t["box_slices"])
        ctx["model_flops_per_unit"] = arith_medsam.study_flops(conf, n)
        ctx["attn_work_per_unit"] = arith_medsam.attention_work(
            conf, n, int(conf["slice_batch"]))
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
    gap, detail = check(cell, wseed, volumes, reqs, sample.items)
    return common.Outcome(
        {k: v for k, v in metrics.items() if k in cell.end_to_end},
        {"prob_gap": (gap, cell.traffic["limits"]["prob_gap"])}, n, 0,
        peak, setup_end, ctx, detail)


def reference_net(cell, wseed, arith_mode: str) -> ref.MedSAM:
    conf = cell.hparams()
    with torch.device(common.DEVICE):
        net = ref.MedSAM(conf, ref.Arith(arith_mode))
    net.load_state_dict(weights(conf, wseed, common.DEVICE))
    return net.eval()


def check(cell, wseed, volumes, reqs, served):
    """Widest probability gap of the first ``sample`` served label volumes
    ``[(request, labels)]`` (in the draw's order) whose reference masks
    are not degenerate, under the fp32 reference; and what it came
    from."""
    net = reference_net(cell, wseed, "fp32")
    want = int(cell.traffic["sample"])
    worst, detail, rejected, checked = 0.0, {}, [], 0
    probs_of = {}
    for k, labels in served:
        if checked == want:
            break
        spec = k % len(reqs)
        v, box = reqs[spec]
        x0, y0, x1, y1, z0, z1 = box
        vol = volumes[v]
        if tuple(labels.shape) != tuple(vol.shape[:3]):
            return 1.0, {"request": k, "fault": "shape"}
        outside = np.concatenate([labels[:, :, :z0], labels[:, :, z1:]],
                                 axis=-1)
        if outside.any():
            return 1.0, {"request": k, "fault": "labels outside the box"}
        if spec not in probs_of:
            probs_of[spec] = ref.study_probs(net, vol, box, common.DEVICE)
        probs = probs_of[spec]
        fg = float((probs[y0:y1, x0:x1] > 0.5).float().mean())
        if not DEGENERATE <= fg <= 1.0 - DEGENERATE:
            rejected.append([k, round(fg, 4)])
            continue
        checked += 1
        got = torch.as_tensor(labels[:, :, z0:z1], device=probs.device)
        chosen = torch.where(got > 0, probs, 1.0 - probs)
        gap = float((torch.maximum(probs, 1.0 - probs) - chosen).max())
        if gap >= worst:
            worst, detail = gap, {"request": k, "box": list(box),
                                  "foreground": fg}
    del net, probs_of
    common.free_memory()
    detail.update(checked=checked, rejected=rejected)
    if checked < want:
        return 1.0, dict(detail, fault="too few studies with both labels")
    return worst, detail


def control(cell) -> float:
    """``prob_gap`` of the reference in fp8 put in the program's place,
    on as many requests as a run draws."""
    wseed, volumes, reqs = inputs(cell)
    net = reference_net(cell, wseed, "fp8")
    served = []
    for k in range(min(SPARE * int(cell.traffic["sample"]), len(reqs))):
        v, box = reqs[k]
        probs = ref.study_probs(net, volumes[v], box, common.DEVICE)
        labels = np.zeros(volumes[v].shape[:3], np.uint8)
        labels[:, :, box[4]:box[5]] = (probs > 0.5).cpu().numpy()
        served.append((k, labels))
    del net
    common.free_memory()
    return check(cell, wseed, volumes, reqs, served)[0]
