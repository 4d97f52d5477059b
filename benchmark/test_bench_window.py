"""The window's arithmetic on fake timings, the sweep's least time on a
small counts tensor with known zeros, and the device trace's reductions."""
import numpy as np
import pytest

from benchmark import peaks, readers, run
from benchmark.trace import DeviceTrace


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


class FakeEntry:
    """Items of the given seconds and sweeps; the clock moves as they run."""

    def __init__(self, clock, seconds, sweeps=250):
        self.clock, self.seconds, self.sweeps, self.started = clock, seconds, sweeps, 0

    def item(self, k):
        self.started += 1
        self.clock.t += self.seconds[k]
        return self.sweeps


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    monkeypatch.setattr(run.time, "perf_counter", c)
    return c


def test_starts_an_item_only_while_time_left_exceeds_the_last(clock):
    entry = FakeEntry(clock, [9.0, 10.0, 11.0, 12.0, 1.0])
    window, item_s, sweeps, failed = run.loop(entry, 40.0, None, print)
    # after 9, 19, 30 s: 10 s left is not more than the last item's 11 s
    assert item_s == [9.0, 10.0, 11.0] and window == 30.0 and sweeps == 750
    assert failed == 0 and entry.started == 3


def test_always_one_item(clock):
    entry = FakeEntry(clock, [55.0, 1.0])
    window, item_s, _, _ = run.loop(entry, 40.0, None, print)
    assert item_s == [55.0] and window == 55.0


def test_traced_runs_a_fixed_count(clock):
    entry = FakeEntry(clock, [1.0] * 10)
    _, item_s, _, _ = run.loop(entry, float("inf"), 3, print)
    assert len(item_s) == 3


def test_a_failed_item_ends_the_window(clock):
    class Broken(FakeEntry):
        def item(self, k):
            if k == 1:
                raise RuntimeError("broken")
            return super().item(k)

    window, item_s, sweeps, failed = run.loop(Broken(clock, [2.0] * 5), 40.0, None,
                                              lambda s: None)
    assert (item_s, sweeps, failed) == ([2.0], 250, 1)


def test_rates_over_the_whole_window():
    w = run.Window(seconds=30.0, item_s=[9.0, 10.0, 11.0], sweeps=750, setup_s=12.5)
    assert readers.per_item_s(w) == 10.0          # bin_wall_s, chain_s
    assert readers.sweeps_per_s(w) == 25.0        # all sweeps over all time
    assert run.reader("bin_wall_s")(w) == run.reader("chain_s")(w) == 10.0
    assert run.reader("sweeps_per_s")(w) == 25.0
    assert run.reader("setup_s")(w) == 12.5
    empty = run.Window()
    assert readers.per_item_s(empty) is None and readers.sweeps_per_s(empty) is None


def test_spans_read_the_mean_or_nothing():
    w = run.Window(spans={"grid_wall_s": [18.0, 20.0], "genes_wall_s": []})
    assert run.reader("grid_s.bin")(w) == 19.0
    assert run.reader("genes_s.bin")(w) is None


def test_sweep_work_counts_observed_bases_only():
    counts = np.zeros((10, 3, 4), np.int32)
    counts[:, :, 0] = 7          # 30 observed cells' bases
    counts[0, 0, 1] = 2          # one more
    observed = int((counts > 0).sum())
    assert observed == 31
    G = 4
    assert peaks.sweep_logs(observed, G) == (4 * G + 4) * 31
    V, S = counts.shape[:2]
    cells, row = V * S, 16 * V * S
    fused = 3 * row + 2 * 4 * V * G + 16 * V * G + 2 * 4 * S * G + 64 + 4 * V + 8 * S
    apply = 3 * row + 4 * V * G + 4 * S * G + S + 64 + 4 * S
    assert peaks.sweep_bytes(V, S, G) == fused + apply
    assert cells == 30
    least = peaks.sweep_least_s(V, S, G, observed)
    assert least == max(peaks.sweep_logs(observed, G) / peaks.LOG_RATE,
                        (fused + apply) / peaks.MEM_RATE)


def test_the_bound_against_the_frozen_kernel_work():
    """The sweep's work is the port's kernel_work of the fused and
    apply/eta kernels, with the logs of every base observed."""
    from desman_tpu_torch import kernel_bench

    V, S, G = 1000, 16, 5
    logs = sum(kernel_bench.kernel_work(k, V, S, G)[0]
               for k in ("fused_sweep", "gamma_apply_eta"))
    nbytes = sum(kernel_bench.kernel_work(k, V, S, G)[1]
                 for k in ("fused_sweep", "gamma_apply_eta"))
    assert peaks.sweep_bytes(V, S, G) == nbytes
    assert peaks.sweep_logs(4 * V * S, G) == logs
    assert (peaks.LOG_RATE, peaks.MEM_RATE) == (kernel_bench.LOG_RATE,
                                                kernel_bench.MEM_RATE)


def _trace():
    # two overlapping ops, a gap of 3, one op, a gap of 1
    return DeviceTrace(intervals=[(0.0, 2.0, "a"), (1.0, 3.0, "b"), (6.0, 7.0, "c"),
                                  (8.0, 8.5, "a")],
                       window_s=10.0, by_name={"a": 2.5, "b": 2.0, "c": 1.0})


def test_device_trace_reductions():
    t = _trace()
    assert t.busy_s() == 4.5 and t.events == 4
    assert t.idle_gaps() == [["before c", 3.0], ["before a", 1.0]]
    assert t.device_ops(2) == [["a", 2.5], ["b", 2.0]]


def test_trace_readers():
    w = run.Window(seconds=10.0, item_s=[5.0, 5.0], sweeps=500, trace=_trace(),
                   shape=(10, 3, 4), observed=31)
    assert run.reader("idle_share.chain")(w) == pytest.approx(0.55)
    assert run.reader("idle_share.v1e5")(w) == pytest.approx(0.55)
    assert run.reader("launches_per_sweep.chain")(w) == 4 / 500
    assert run.reader("device_busy_ms.v1e5")(w) == pytest.approx(4.5e3 / 500)
    assert run.reader("bin_device_s")(w) == pytest.approx(4.5 / 2)
    least = peaks.sweep_least_s(10, 3, 4, 31) * 500
    assert run.reader("sweep_roofline.v1e5")(w) == pytest.approx(100 * least / 4.5)
    # nothing on the device: every trace reader reads nothing, never 0
    w.trace = DeviceTrace(intervals=[], window_s=10.0)
    for name in ("idle_share.chain", "launches_per_sweep.chain", "device_busy_ms.v1e5",
                 "sweep_roofline.v1e5", "bin_device_s"):
        assert run.reader(name)(w) is None
