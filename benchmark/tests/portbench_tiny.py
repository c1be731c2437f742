"""Tiny CPU versions of the benchmark's cells, for its tests: the cell's
own configuration and traffic files with the widths, depth and sizes cut
so that a run takes seconds on the CPU in fp32.  ``cpu_harness`` points
the harness's few card calls at the CPU (the harness itself runs on the
card only)."""

from __future__ import annotations

import copy

from torch.profiler import ProfilerActivity

from benchmark import common

TINY_MODEL = dict(
    hidden_channels=[8, 16, 32, 64], num_heads_encoder=2,
    num_heads_decoder=2, attn_window_size=[4, 4, 2], pos_bias_embed_dim=8,
    tokens_per_prompt_encoder=4, tokens_per_prompt_decoder=4,
    contrastive_coding_dim=16, compute_dtype="float32",
    roi_size=[16, 16, 8], seg_input_size=[16, 16, 8])
TINY_TRAFFIC = {
    "serve": dict(volume_shape=[40, 36, 10], in_flight=2, pool=3,
                  warmup_s=0.0, trace_units=2, label_units=1, sample=2),
    "train_phase1": dict(batch=2, pool=3, trace_units=2, label_units=1),
    "train_downstream": dict(batch=2, pool=3, trace_units=2, label_units=1),
}


def tiny_cell(workload: str, seed: int = 123456789012, seconds: float = 0.3,
              trace: bool = False) -> common.Cell:
    manifest = common.load_manifest()
    cell = common.load_cell(manifest, workload, seed, seconds, trace)
    cell.config = copy.deepcopy(cell.config)
    cell.config["hparams"].update(TINY_MODEL)
    cell.traffic = dict(cell.traffic, **TINY_TRAFFIC[cell.traffic["driver"]])
    return cell


class _NoEvents:
    """``common.ForwardEvents`` without CUDA events (none on the CPU)."""

    def __init__(self, *_args, **_kw):
        pass

    def mark(self, _tag):
        pass

    def remove(self):
        pass

    def units(self, _tag):
        return []


def cpu_harness(monkeypatch) -> None:
    """Run the harness on the CPU: inputs and weights made there, no
    card synchronisation, events or memory statistics."""
    monkeypatch.setattr(common, "DEVICE", "cpu")
    monkeypatch.setattr(common, "sync", lambda: None)
    monkeypatch.setattr(common, "memory_peak", lambda: 0)
    monkeypatch.setattr(common, "ForwardEvents", _NoEvents)
    monkeypatch.setattr(common, "device_activity",
                        lambda: ProfilerActivity.CPU)
    monkeypatch.setattr(common, "device_info", lambda peak, chips=1: {
        "platform": "cpu", "kind": "cpu", "count": chips,
        "memory_peak_bytes": int(peak)})
