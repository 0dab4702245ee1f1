"""The idle time's split over the program's layers (`portbench/layers.py`)
on synthetic stretches: rows and spans in seconds, as `events_of` hands
them over."""

import pathlib
import random
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import layers  # noqa: E402


def _row(s, e, launch=None, thread=None):
    return (s, e, launch, thread)


def test_gaps_are_split_at_span_edges():
    device = [_row(0.0, 1.0), _row(3.0, 4.0)]
    spans = [("halogen.driver.step", 1, 0.5, 2.0),
             ("halogen.wrap.forward", 1, 2.25, 2.5)]
    by_layer, by_span = layers.charge(layers.idle_gaps(device, 0.0, 4.0),
                                      spans)
    assert by_layer == pytest.approx({"driver": 1.0, "wrappers": 0.25,
                                      "loop": 0.0, "outside": 0.75})
    assert by_span == pytest.approx({"halogen.driver.step": 1.0,
                                      "halogen.wrap.forward": 0.25})


def test_two_threads_are_ranked_by_layer():
    """The fit loop's thread and autograd's: wrappers > driver > loop,
    whatever the depth; within a layer the innermost span."""
    device = [_row(0.0, 1.0), _row(3.0, 4.0)]
    spans = [("halogen.loop.step", 1, 0.0, 4.0),
             ("halogen.loop.backward", 1, 0.9, 3.5),
             ("halogen.driver.pixels", 1, 1.0, 2.0),
             ("halogen.wrap.backward", 2, 1.5, 2.5)]
    by_layer, by_span = layers.charge(layers.idle_gaps(device, 0.0, 4.0),
                                      spans)
    assert by_layer == pytest.approx({"driver": 0.5, "wrappers": 1.0,
                                      "loop": 0.5, "outside": 0.0})
    assert by_span == pytest.approx({"halogen.driver.pixels": 0.5,
                                      "halogen.wrap.backward": 1.0,
                                      "halogen.loop.backward": 0.5})


def test_a_gap_under_no_span_is_outside():
    device = [_row(0.0, 1.0), _row(2.0, 3.0)]
    spans = [("halogen.loop.step", 1, 2.2, 2.8),  # over busy time only
             ("aten::mul", 1, 1.0, 2.0),  # not a span of the program
             ("halogen.unknown.x", 1, 1.0, 2.0)]
    by_layer, by_span = layers.charge(layers.idle_gaps(device, 0.0, 3.5),
                                      spans)
    assert by_layer == pytest.approx({"driver": 0.0, "wrappers": 0.0,
                                      "loop": 0.0, "outside": 1.5})
    assert by_span == {}


@pytest.mark.parametrize("seed", range(5))
def test_the_shares_sum_to_the_idle_share(seed):
    rng = random.Random(seed)
    at, device = 0.0, []
    for _ in range(200):
        s = at + rng.uniform(0.0, 1e-3)
        at = s + rng.uniform(1e-5, 1e-3)
        device.append(_row(s, at))
    wall = at + 1e-3
    names = ["halogen.driver.pixels", "halogen.wrap.forward",
             "halogen.loop.step", "halogen.wrap.backward"]
    spans = []
    for _ in range(300):
        s = rng.uniform(0.0, wall)
        spans.append((rng.choice(names), rng.choice((1, 2)), s,
                      min(wall, s + rng.uniform(0.0, 5e-3))))
    by_layer, by_span = layers.charge(layers.idle_gaps(device, 0.0, wall),
                                      spans)
    busy = sum(r[1] - r[0] for r in device)
    assert sum(by_layer.values()) / wall == pytest.approx(1 - busy / wall)
    assert sum(by_span.values()) == pytest.approx(
        sum(v for k, v in by_layer.items() if k != "outside"))


def test_readback_counts_the_copies_enqueued_inside_its_span():
    spans = [("halogen.driver.step", 1, 0.0, 10.0),
             ("halogen.driver.readback", 1, 6.0, 9.0),
             ("halogen.driver.readback", 2, 1.0, 2.0)]
    device = [_row(6.5, 8.5, 6.2, 1),  # enqueued inside: counts
              _row(5.5, 6.5, 5.9, 1),  # enqueued before it
              _row(1.2, 1.4, 1.1, 1),  # inside the other thread's span
              _row(9.5, 9.6, 9.5, 1),  # after it
              _row(6.6, 6.7, None, None)]  # no launch found
    assert layers.readback_s(device, spans) == pytest.approx(2.0)


def test_self_time_leaves_out_nested_spans():
    spans = [("halogen.driver.step", 1, 0.0, 10.0),
             ("halogen.driver.chunks", 1, 1.0, 6.0),
             ("halogen.driver.pixels", 1, 2.0, 5.0),
             ("halogen.driver.readback", 1, 7.0, 9.0),
             ("halogen.driver.step", 1, 11.0, 12.0),
             ("halogen.wrap.backward", 2, 3.0, 4.0)]
    assert layers.self_times(spans) == {
        "halogen.driver.step": (2, pytest.approx(4.0)),
        "halogen.driver.chunks": (1, pytest.approx(2.0)),
        "halogen.driver.pixels": (1, pytest.approx(3.0)),
        "halogen.driver.readback": (1, pytest.approx(2.0)),
        "halogen.wrap.backward": (1, pytest.approx(1.0))}


def test_a_program_without_spans_or_counters():
    device = [_row(0.0, 1.0, 0.0, 1), _row(2.0, 3.0, 1.9, 1)]
    got = layers.reduce_layers(device, [], 0.0, 4.0)
    assert got["layer_idle_s"]["outside"] == pytest.approx(2.0)
    assert got["readback_s"] == 0.0 and got["spans"] == {}
    assert layers.kernel_calls(None, None) is None


def test_kernel_calls_sum_launches_and_calls():
    before = {"megakernel.launches": 10, "megakernel.recorded": 4,
              "adjoint.sweep_launches": 4, "sky.order_calls": 1,
              "trace.wavefront_syncs": 7}
    after = {"megakernel.launches": 74, "megakernel.recorded": 68,
             "adjoint.sweep_launches": 68, "sky.order_calls": 3,
             "trace.wavefront_syncs": 9}
    assert layers.kernel_calls(before, after) == 64 + 64 + 2
