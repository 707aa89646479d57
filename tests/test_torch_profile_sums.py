"""``chip_smoke.profile_sums`` — the one-pass summary of a profiler trace
that the card's profiled phases print — against ``key_averages()`` on a
CPU trace: every host op's self time (within 1e-3 relative) and count
equal, nested and same-name-merged ranges included. (A CPU trace has no
device events; on the card the device sums are compared the same way.)"""

import pathlib
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def test_profile_sums_match_key_averages():
    torch.manual_seed(0)
    w = torch.randn(64, 64, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with record_function("step"):
                with record_function("step"):        # merged into its twin
                    y = torch.tanh(torch.randn(16, 64) @ w).sum()
                y.backward()
            with record_function("outer"):
                torch.ones(3).add_(1)
    device, host = chip_smoke.profile_sums(prof)
    want = {e.key: (e.self_cpu_time_total, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CPU}
    assert device == {}
    assert set(host) == set(want)
    for k, (us, n) in want.items():
        assert host[k][1] == n, k
        assert abs(host[k][0] - us) <= 1e-3 * max(1.0, abs(us)), k
