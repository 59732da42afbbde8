"""``prepared_share.serve``'s reader: nothing to read without the program's
``weights.*`` counters (a program from before prepared weights), else 100 x
prepared calls over prepared and cast calls; and a toy serving run reads
it."""
import os

import torch

import toy
from h100_bench import harness
from ssl_vit_video_analytics_tpu_torch.utils import tracing

torch.set_num_threads(2)  # test workers share the host

NAME = "prepared_share.serve"


def _reader():
    path = harness.reader_path(os.path.join(harness.HERE, "metrics"), NAME)
    assert os.path.basename(path) == f"{NAME}.py"
    return harness.load_module(path, "h100_bench.metrics.prepared_share_serve")


def test_the_reader_reads_nothing_without_the_counters_and_the_share_with_them(monkeypatch):
    read = _reader().read
    for counts in ({}, {"host_syncs": 3, "early_exit.frames": 16},
                   {"weights.prepared_calls": 0, "weights.cast_calls": 0}):
        monkeypatch.setattr(tracing, "counters", lambda c=counts: dict(c))
        assert read({}) is None
    for prepared, cast in ((59, 0), (0, 35), (177, 59)):
        counts = {"weights.prepared_calls": prepared, "weights.cast_calls": cast}
        monkeypatch.setattr(tracing, "counters", lambda c=counts: dict(c))
        assert read({}) == 100.0 * prepared / (prepared + cast)


def test_a_toy_serving_run_reads_its_share():
    """The toy cell serves in fp32 on the CPU: its linears run on prepared
    weights and its fp32 ConvBNActs on the per-call path (nothing to cast)."""
    cell = toy.cell("serve_ee.b8", trace=True)
    before = tracing.counters()
    line = harness.result_line(cell, harness.run_cell(cell))
    after = tracing.counters()
    prepared, cast = (after[k] - before.get(k, 0)
                      for k in ("weights.prepared_calls", "weights.cast_calls"))
    assert prepared > 0 and cast > 0
    assert 0 < line["metrics"][NAME]["value"] < 100
