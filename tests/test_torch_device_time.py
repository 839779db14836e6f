"""The readers of a ``profiled`` window (diagnostics/device_time.py) on a
stand-in profile: each leaves out the lead kernels that ``profiled``
enqueues ahead of the call, so no caller counts or times them. Only
``profiled`` itself needs the card (chip_smoke.py phases 10 and 11)."""

from types import SimpleNamespace

from torch.autograd import DeviceType

from dycoreplanet_tpu_torch.diagnostics import device_time as dtm


class _Profile:
    """The parts of torch.profiler's profile that the readers use."""

    def __init__(self, device, host):
        self._events = [
            SimpleNamespace(device_type=DeviceType.CUDA, name=name,
                            time_range=SimpleNamespace(start=t0, end=t1))
            for name, t0, t1 in device]
        self._host = [SimpleNamespace(key=k, count=c) for k, c in host]

    def events(self):
        return self._events

    def key_averages(self):
        return self._host


LEAD = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
K2 = "void forcing_kernel<float, true, false>(Args)"
K4 = "void thomas_kernel<float>(Args)"


def _profile():
    lead = [(LEAD, 0.0, 1.0)] * 170          # 30 of the 200 lost
    return _Profile(
        lead + [(K2, 10.0, 14.0), (K4, 14.0, 15.0), (K4, 15.0, 16.5),
                ("memset", 16.5, 16.5)],
        [("cudaLaunchKernel", dtm.LEAD_KERNELS + 3),
         ("cudaMemsetAsync", 1)])


def test_readers_leave_out_the_lead():
    """device_events, device_rows, host_launches and count_kernels see the
    call's work only: its 4 device activities, the 2 kernel names of
    nonzero time by device ms, its 3 kernel launches, K2 once and K4
    twice."""
    prof = _profile()
    assert [e.name for e in dtm.device_events(prof)] == [K2, K4, K4,
                                                         "memset"]
    assert dtm.device_rows(prof) == [(K2, 4.0e-3, 1), (K4, 2.5e-3, 2)]
    assert dtm.host_launches(prof) == 3
    assert dtm.count_kernels(prof, ("forcing", "tridiag", "correct")) == {
        "forcing": 1, "tridiag": 2, "correct": 0}
    assert dtm.LEAD_NAME in LEAD and dtm.wrapper_of(LEAD) is None
