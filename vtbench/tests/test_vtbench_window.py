"""The window's arithmetic and the trace's reduction."""

import pytest

from vtbench import harness, readers, trace, window


def record(times, work=100, units="frames"):
    return harness.Record(units=units, work=work, iter_s=times, window_s=sum(times),
                          setup_s=1.0)


def test_rate_is_all_work_over_the_whole_window():
    assert window.rate(100, 10, 2.0) == 500.0
    rec = record([0.1] * 10)
    assert readers.rate_mrays(rec, "frames") == pytest.approx(100 * 10 / 1.0 / 1e6)
    assert readers.rate_mrays(rec, "steps") is None


def test_p95_is_over_every_sample():
    times = [0.01 * (i + 1) for i in range(100)]  # 10 .. 1000 ms
    assert readers.p95_ms(record(times), "frames") == pytest.approx(950.5)
    assert window.percentile([3.0], 95) == 3.0


def test_a_stall_moves_the_rate_and_the_tail():
    base = [0.07] * 200
    stalled = list(base)
    for i in range(40, 60):  # twenty frames of a stall, a tenth of the window
        stalled[i] = 0.5
    a, b = record(base), record(stalled)
    assert readers.rate_mrays(b, "frames") < 0.7 * readers.rate_mrays(a, "frames")
    assert readers.p95_ms(b, "frames") > 5 * readers.p95_ms(a, "frames")
    one = list(base)
    one[100] = 5.0  # one long frame: the rate sees it, all of it
    assert readers.rate_mrays(record(one), "frames") == pytest.approx(
        100 * 200 / (0.07 * 199 + 5.0) / 1e6)


def test_busy_union_gaps_and_breakdown():
    total, gaps = trace.union_ns([(0, 10), (5, 20), (30, 40), (40, 45)])
    assert total == 35 and gaps == [(20, 30)]
    it = trace.Iteration(index=3, wall_s=50e-9,
                         device=[("void traverse_kernel<0, 0>(Tables)", 0, 10),
                                 ("lookup_kernel<3>", 5, 20),
                                 ("Memset (Device)", 30, 40), ("elementwise", 40, 45)],
                         host=[("aten::nonzero", 18, 35), ("cudaStreamSynchronize", 22, 28)])
    tr = trace.Trace(iterations=[it])
    assert tr.busy_s == pytest.approx(35e-9) and tr.window_s == pytest.approx(50e-9)
    assert tr.family_counts() == {"K1": 1, "K4": 1}
    assert len(tr.kernels()) == 3
    bd = tr.breakdown()
    assert bd["idle_gaps"] == [["cudaStreamSynchronize", pytest.approx(10e-9)]]
    assert bd["device_ops"][0][0] == "lookup_kernel<3>"
    rec = record([0.05])
    rec.trace, rec.bounds = tr, {"K1": 5e-9, "K4": 7.5e-9}
    assert readers.roofline_pct(rec, "frames") == pytest.approx(50.0)
    assert readers.busy_pct(rec, "frames") == pytest.approx(70.0)
    assert readers.kernels_per_iteration(rec, "frames") == 3


@pytest.mark.parametrize("name,fam", [
    ("void (anonymous namespace)::traverse_kernel<0, 0>(Tables, float const*)", "K1"),
    ("_ZN12_GLOBAL__N_115traverse_kernelILi1ELi0EEEv6Tables", "K2"),
    ("void (anonymous namespace)::traverse_kernel<0, 1>(Tables)", "K1"),
    ("exit_kernel(Tables, float const*)", "K3"),
    ("void (anonymous namespace)::lookup_bwd_kernel<3, true>(float const*)", "K4bwd"),
    ("void (anonymous namespace)::lookup_kernel<1>(float const*)", "K4"),
    ("void at::native::elementwise_kernel<128, 2>", None)])
def test_kernel_families(name, fam):
    assert trace.family(name) == fam


def test_traced_run_records_its_samples():
    """A traced run on the CPU: the samples are recorded, spread over the
    window, and the spans of the other steps are kept."""
    import time

    import torch

    from vtbench import spec

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        res = harness.run_cell(spec.cell("monu.train_step"), 2147483921, 2.0, True, "cpu",
                               time.time(), render={"width": 128, "height": 16},
                               drive_check=False)
    finally:
        torch.set_num_threads(n)
    assert res["correct"], res["limits"]
    assert res["device"]["window_s"] > 0
    assert {"train.fwd_ms", "train.grad_ms", "train.step_ms_p95"} <= set(res["metrics"])
