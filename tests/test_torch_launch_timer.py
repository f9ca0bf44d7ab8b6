"""The launch timer (``ops/launch_timer.py``): off by default, on only
inside ``recording()``, and untouched by walks and inserts on the CPU,
which launch no kernel."""

import numpy as np
import torch

from rnabloom_tpu_torch.ops import cell_insert as ci
from rnabloom_tpu_torch.ops import launch_timer


def test_off_by_default():
    assert launch_timer._active is None
    assert launch_timer.begin(torch.device("cpu")) is None
    launch_timer.end(None, torch.device("cpu"), "walk_pair", 64)  # nothing open: a no-op


def test_recording_nests_and_restores():
    with launch_timer.recording() as outer:
        assert launch_timer._active is outer
        with launch_timer.recording() as inner:
            assert launch_timer._active is inner and inner is not outer
        assert launch_timer._active is outer
    assert launch_timer._active is None
    assert outer.launches == [] and inner.launches == []


def test_cpu_inserts_record_nothing():
    table = torch.zeros(1 << 10, dtype=torch.uint8)
    idx = torch.from_numpy(np.random.default_rng(0).integers(0, 1 << 10, 500))
    with launch_timer.recording() as rec:
        ci.cell_insert(table, idx, "set")
    assert rec.launches == []
    assert int(table.sum()) == int(torch.unique(idx).numel())
