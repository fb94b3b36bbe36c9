"""The program's spans and the launches of device time, on hand-made
events: crediting, the linked share, the mirrors on the device's
timeline, and the readers that use them."""
from types import SimpleNamespace

import pytest
import torch

from portbench.harness import cells, spans, trace


def linked():
    """Two blocks of a loop.  ``k_late`` is launched in the first block's
    sweep and runs while the host is in the second block's draws."""
    host = [
        (trace.LABEL, 0.0, 20.0),
        ("cudaLaunchKernel", 1.0, 1.1),
        ("cudaLaunchKernel", 3.0, 3.1),
        ("cudaLaunchKernel", 4.0, 4.1),
        ("cudaLaunchKernel", 12.0, 12.1),
    ]
    program = [
        ("engine.block", 0.5, 9.0),
        ("engine.draws", 0.5, 2.0),
        ("engine.sweep", 2.5, 8.0),
        ("engine.block", 10.0, 16.0),
        ("engine.draws", 10.0, 13.0),
        ("summary.block", 16.5, 18.0),
    ]
    device = [
        ("k_draw", 1.2, 2.0),
        ("k_sweep", 3.2, 5.0),
        ("k_late", 9.0, 11.0),     # launched at 4.0, in the sweep
        ("k_draw2", 12.2, 13.0),
        ("k_after", 21.0, 22.0),   # outside the window
    ]
    return device, host + program, [1.0, 3.0, 4.0, 12.0, None], program


def test_a_kernel_is_credited_to_the_span_open_at_its_launch():
    tr = spans.Linked(*linked())
    assert tr.launched_in("engine.sweep") == pytest.approx(1.8 + 2.0)
    assert tr.launched_in("engine.draws") == pytest.approx(0.8 + 0.8)
    assert tr.launched_in("engine.block") == pytest.approx(5.4)  # any depth
    assert tr.launched_in("summary.block") == 0.0
    assert tr.launched_share("engine.sweep") == pytest.approx(
        100 * 3.8 / 5.4)
    assert tr.launched_share("summary.block") is None
    assert tr.span_count("engine.block") == 2


def test_idle_is_credited_to_the_span_open_while_the_card_waits():
    tr = spans.Linked(*linked())
    # busy: 1.2-2, 3.2-5, 9-11, 12.2-13
    loop = ("engine.block", "summary.block")
    # idle in blocks: 0.5-1.2, 2-3.2, 5-9, 11-12.2, 13-16; summary 16.5-18
    assert tr.idle_in(loop) == pytest.approx(
        0.7 + 1.2 + 4.0 + 1.2 + 3.0 + 1.5)
    # less the draws (0.5-2 and 10-13): 0.7 and 1.2 go
    assert tr.idle_in(loop, outside=("engine.draws",)) == pytest.approx(
        1.2 + 4.0 + 3.0 + 1.5)
    assert tr.idle_in(("no.such.span",)) == 0.0


def test_a_trace_below_the_linked_share_raises():
    device, host, launched, program = linked()
    launched[2] = None        # 2.0 of 5.4 s of device time unlinked
    with pytest.raises(spans.Unlinked):
        spans.Linked(device, host, launched, program)
    # a trace with no device time has nothing to link
    spans.Linked([], host, [], program)


def test_launches_and_spans_leave_every_reading_as_it_was():
    device, host, launched, program = linked()
    bare = trace.Trace(device, host)
    full = spans.Linked(device, host, launched, program)
    for reading in ("window_s", "busy_s"):
        assert getattr(full, reading) == getattr(bare, reading)
    assert full.device == bare.device and full.host == bare.host
    assert full.busy_intervals() == bare.busy_intervals()
    assert full.kernels() == bare.kernels()
    assert full.device_s() == bare.device_s()
    assert full.device_s("k_") == bare.device_s("k_")
    assert full.count() == bare.count()
    assert full.device_ops() == bare.device_ops()
    assert full.idle_gaps() == bare.idle_gaps()
    # the program's spans name the gaps where the parent's said ``host``
    parent = trace.Trace(device, [s for s in host if s not in program])
    assert "host" in dict(parent.idle_gaps())
    assert "host" not in dict(bare.idle_gaps())


class Event:
    """A profiler event as ``kineto_results.events()`` gives it."""

    def __init__(self, name, lo, hi, device=False, kind="cpu_op", corr=0,
                 annotation=None):
        self._name, self._lo, self._hi = name, lo, hi
        self._device, self._kind, self._corr = device, kind, corr
        if annotation is not None:
            self.is_user_annotation = lambda: annotation

    def name(self):
        return self._name

    def start_ns(self):
        return self._lo * 1e9

    def duration_ns(self):
        return (self._hi - self._lo) * 1e9

    def device_type(self):
        return "DeviceType.CUDA" if self._device else "DeviceType.CPU"

    def activity_type(self):
        return self._kind

    def correlation_id(self):
        return self._corr


def events(with_flag: bool):
    """One experiment holding one span with one kernel launched in it,
    and the span's mirror on the device's timeline."""
    f = (lambda v: v) if with_flag else (lambda v: None)
    return [
        Event(trace.LABEL, 0.0, 10.0, kind="user_annotation",
              annotation=f(True)),
        Event("engine.sweep", 1.0, 5.0, kind="user_annotation",
              annotation=f(True)),
        # a torch op numbers its correlation apart from the CUDA calls
        Event("aten::add", 2.0, 2.5, corr=7, annotation=f(False)),
        Event("cudaLaunchKernel", 2.1, 2.2, kind="cuda_runtime", corr=7,
              annotation=f(False)),
        Event("add_kernel", 3.0, 4.0, device=True, kind="kernel", corr=7,
              annotation=f(False)),
        Event("engine.sweep", 1.0, 5.0, device=True,
              kind="gpu_user_annotation", corr=3, annotation=f(True)),
        Event(trace.LABEL, 0.0, 10.0, device=True,
              kind="gpu_user_annotation", annotation=f(True)),
    ]


@pytest.mark.parametrize("with_flag", [True, False],
                         ids=["is_user_annotation", "activity_type"])
def test_a_span_mirrored_on_the_device_is_no_device_activity(with_flag):
    tr = spans.from_events(events(with_flag))
    assert [d[0] for d in tr.device] == ["add_kernel"]
    assert tr.busy_s == pytest.approx(1.0)
    assert [s[0] for s in tr.spans] == ["engine.sweep"]
    assert tr.launched == [pytest.approx(2.1)]
    assert tr.launched_share("engine.sweep") == pytest.approx(100.0)


# -- the readers ----------------------------------------------------------------

SPAN_METRICS = {
    "engine.sweep_device_share": 100 * 3.8 / 5.4,
    "engine.draws_device_share": 100 * 1.6 / 5.4,
    "summary.device_share": None,       # nothing launched in it
    "attribution.device_share": None,
    "engine.host_idle_share": 100 * (1.2 + 4.0 + 3.0 + 1.5) / 20.0,
}


def context(window_trace, device="cuda"):
    """What a reader sees of a run: its ``trace``, and the cell's entry
    that the second profiled pass runs, recording the paths it ran."""
    ran = []
    entry = SimpleNamespace(run=lambda ctx, source: ran.append(source))
    return SimpleNamespace(trace=window_trace, device=torch.device(device),
                           profiled_experiments=2,
                           cell=SimpleNamespace(entry=entry),
                           source=lambda path: path), ran


def read(name, ctx):
    specs = {m["name"]: m for m in cells.load_bench()["per_layer"]}
    return cells.load_metric(specs[name]).read(ctx)


def test_the_span_metrics_read_a_second_profiled_pass(monkeypatch):
    device, host, launched, program = linked()
    passes = []

    def capture(fn):
        fn()
        passes.append(1)
        return spans.Linked(device, host, launched, program)

    monkeypatch.setattr(spans, "capture", capture)
    ctx, ran = context(trace.Trace(device, host))
    for name, value in SPAN_METRICS.items():
        assert read(name, ctx) == (None if value is None
                                   else pytest.approx(value)), name
    assert len(passes) == 1          # once a run, kept on the context
    assert ran == [(spans.SPAN_PATH,), (spans.SPAN_PATH + 1,)]


@pytest.mark.parametrize("why", ["no spans", "cpu", "untraced"])
def test_the_span_metrics_fall_silent_without_a_reading(monkeypatch, why):
    def capture(fn):
        raise AssertionError("profiled again")

    monkeypatch.setattr(spans, "capture", capture)
    device, host, _, _ = linked()
    bare_host = [s for s in host if s[0] not in spans.PROGRAM]
    window = {"no spans": trace.Trace(device, bare_host),   # a parent
              "cpu": trace.Trace(device, host),
              "untraced": None}[why]
    ctx, ran = context(window, "cpu" if why == "cpu" else "cuda")
    for name in SPAN_METRICS:
        assert read(name, ctx) is None, name
    assert ran == []


def test_an_unlinked_pass_is_profiled_again_then_refused(monkeypatch):
    device, host, launched, program = linked()
    tries = []

    def capture(fn):
        tries.append(1)
        if len(tries) == 1:
            raise spans.Unlinked("dropped")
        return spans.Linked(device, host, launched, program)

    monkeypatch.setattr(spans, "capture", capture)
    ctx, _ = context(trace.Trace(device, host))
    assert spans.of(ctx).span_count("engine.block") == 2
    assert len(tries) == 2

    def never(fn):
        raise spans.Unlinked("dropped")

    monkeypatch.setattr(spans, "capture", never)
    ctx, _ = context(trace.Trace(device, host))
    with pytest.raises(RuntimeError):
        spans.of(ctx)
