"""The measurement helpers of chip_smoke.py that run on the host.

``device_ms_by_name`` reads a ``torch.profiler`` window. The profiler also
puts a user annotation such as ``Optimizer.step#Adam.step`` on the device's
timeline, as a range over the kernels it launched; counting it as device
time counts those kernels twice (on the H100 it doubled the device time of
a DLRM epoch's optimizer step). The window here is made of stand-in events.
"""

from types import SimpleNamespace

import torch

import chip_smoke

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def _event(key, device_type, us, annotation=False):
    return SimpleNamespace(key=key, device_type=device_type,
                           self_device_time_total=us,
                           is_user_annotation=annotation)


class _Window:
    def __init__(self, events):
        self.events = events

    def key_averages(self):
        return self.events


def test_device_time_skips_annotations_and_host_ops():
    window = _Window([
        _event("multi_tensor_apply_kernel", CUDA, 1500.0),
        _event("embedding_backward_kernel", CUDA, 500.0),
        _event("Optimizer.step#Adam.step", CUDA, 1600.0, annotation=True),
        _event("aten::add_", CPU, 900.0),
    ])
    by_name = chip_smoke.device_ms_by_name(window)
    assert by_name == {"multi_tensor_apply_kernel": 1.5,
                       "embedding_backward_kernel": 0.5}
    share = chip_smoke.device_share(window, 8.0)
    assert share["device_busy_ms"] == 2.0
    assert share["device_busy_share"] == 0.25


def test_no_device_time_reads_none():
    share = chip_smoke.device_share(_Window([_event("aten::mm", CPU, 5.0)]), 1.0)
    assert share["device_busy_ms"] is None and share["device_busy_share"] is None
