"""``norm_kernel_share.*``'s reader: nothing to read without the program's
``layer_norm.*`` counters (a program from before the LayerNorm kernel),
else 100 x kernel launches over launches and plain calls; and a toy run of a
training and a serving cell reads it (0 on the CPU: the plain version)."""
import os

import pytest
import torch

import toy
from h100_bench import harness
from ssl_vit_video_analytics_tpu_torch.utils import tracing

torch.set_num_threads(2)  # test workers share the host


def _reader(name):
    path = harness.reader_path(os.path.join(harness.HERE, "metrics"), name)
    assert os.path.basename(path) == "norm_kernel_share.py"
    return harness.load_module(path, "h100_bench.metrics.norm_kernel_share")


@pytest.mark.parametrize("name", ["norm_kernel_share.train", "norm_kernel_share.serve"])
def test_the_reader_reads_nothing_without_the_counters_and_the_share_with_them(
        monkeypatch, name):
    read = _reader(name).read
    for counts in ({}, {"host_syncs": 3, "weights.prepared_calls": 59},
                   {"layer_norm.launches": 0, "layer_norm.plain_calls": 0}):
        monkeypatch.setattr(tracing, "counters", lambda c=counts: dict(c))
        assert read({}) is None
    for counts, share in (({"layer_norm.launches": 41}, 100.0),
                          ({"layer_norm.launches": 41, "layer_norm.plain_calls": 0}, 100.0),
                          ({"layer_norm.launches": 0, "layer_norm.plain_calls": 25}, 0.0),
                          ({"layer_norm.launches": 30, "layer_norm.plain_calls": 10}, 75.0)):
        monkeypatch.setattr(tracing, "counters", lambda c=counts: dict(c))
        assert read({}) == share


@pytest.mark.parametrize("workload,name", [("b_pretrain.clip16", "norm_kernel_share.train"),
                                           ("serve_ee.b8", "norm_kernel_share.serve")])
def test_a_toy_run_reads_its_share(workload, name):
    """On the CPU every LayerNorm takes the plain version: the share is 0."""
    cell = toy.cell(workload, trace=True)
    before = tracing.counters()
    line = harness.result_line(cell, harness.run_cell(cell))
    after = tracing.counters()
    assert after["layer_norm.plain_calls"] > before.get("layer_norm.plain_calls", 0)
    assert after["layer_norm.launches"] == before.get("layer_norm.launches", 0)
    assert line["metrics"][name]["value"] == 0.0
