"""The cards a run is given and the cards it reports: the count of the cards
used, the driver's wait for each card, the device profile grouped by card,
the state of each card, and a run on several devices that works on all of
them or on its home card alone. The last runs on four cards (`cards4`,
skips without them); the rest on the CPU in seconds."""

import bisect
import os
import random
import types
from collections import defaultdict

import pytest
import torch

from benchmark import drivers, run, spec
from benchmark.frozen import device_profile, host_pace
from benchmark.tests import tiny

SEED = 2**31 + 4099


@pytest.mark.parametrize("rises,ops,want", [
    ([5, 0, 0, 0], None, 1),
    ([5, 6, 7, 8], None, 4),
    ([5, 6, 7, 8], [3, 3, 3, 3], 4),
    ([5, 6, 7, 8], [3, 0, 3, 3], 3),  # memory but no operation: not used
    ([5, 0, 0, 0], [3, 0, 0, 0], 1),
    ([0, 0, 0, 0], None, 0),
    ([5], None, 1),
])
def test_cards_used(rises, ops, want):
    assert run.cards_used(rises, ops) == want


def test_driver_waits_for_every_card(tiny_dir, monkeypatch):
    cell = tiny.cell("frame_1080p_d6_orbit", tiny_dir)
    seen = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: seen.append(d))
    devs = [f"cuda:{i}" for i in range(4)]
    drv = drivers.Driver(torch, cell, SEED, devs)
    assert drv.dev == torch.device("cuda:0")
    drv.sync()
    assert seen == [torch.device(d) for d in devs]
    seen.clear()
    one = drivers.Driver(torch, cell, SEED, "cpu")
    assert one.devs == [torch.device("cpu")] and one.dev == torch.device("cpu")
    one.sync()
    assert seen == []


def _one_list(events, window_s, units):
    """The profile's numbers with every device operation in one list, as
    they were read before the cards were told apart: the reference."""
    device = [(s, e, n) for n, c, s, e in events if c is not None and e > s]
    by_name = defaultdict(float)
    for s, e, n in device:
        by_name[n] += e - s
    busy = device_profile.union([(s, e) for s, e, _ in device])
    busy_s = sum(e - s for s, e in busy)
    host = sorted((s, e, n) for n, c, s, e in events if c is None)
    starts = [h[0] for h in host]
    gaps = defaultdict(float)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        name = "no host operation"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 400, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        gaps[name] += s1 - e0
    return dict(window_s=window_s, busy_s=busy_s, ops=len(device),
                by_name=dict(by_name), idle_gaps=dict(gaps), units=units)


def _events(card_of, n=400, seed=5):
    """Device operations (some overlapping, some empty) launched under
    nested host operations, on the card that `card_of(i)` names."""
    r = random.Random(seed)
    out = []
    for i in range(n):
        t = r.random()
        out.append((f"host_{i % 7}", None, t - 0.01 * r.random(), t + 0.01 * r.random()))
        out.append((f"kernel_{i % 5}", card_of(i), t, t + r.choice([0.0, 1e-4, 3e-3])))
    out.append(("aten::sort", None, 0.0, 1.0))
    r.shuffle(out)
    return out


def test_profile_of_one_card_is_the_one_list():
    events = _events(lambda i: 0)
    got = device_profile.summarize(events, 1.25, 3)
    want = _one_list(events, 1.25, 3)
    for key, value in want.items():
        assert got[key] == value, key  # equal, not close
    assert got["busy_s_per_device"] == {0: want["busy_s"]}
    assert got["ops_per_device"] == {0: want["ops"]}
    assert device_profile.summarize([("host", None, 0.0, 1.0)], 1.0, 1) is None


def test_profile_tells_the_cards_apart():
    # Card 0 busy over the first half of the window, card 1 over the second.
    events = [("k", 0, 0.0, 0.25), ("k", 0, 0.25, 0.5),
              ("k", 1, 0.5, 0.75), ("k", 1, 0.75, 1.0)]
    got = device_profile.summarize(events, 1.0, 1)
    assert got["busy_s"] == 0.5
    assert got["busy_s_per_device"] == {0: 0.5, 1: 0.5}
    assert got["ops_per_device"] == {0: 2, 1: 2}
    assert _one_list(events, 1.0, 1)["busy_s"] == 1.0
    # A gap of one card is idle time, though the other card is busy in it;
    # it is named by the host operation running at its middle.
    events = [("k", 0, 0.0, 0.1), ("k", 0, 0.2, 0.3), ("k", 1, 0.05, 0.25),
              ("aten::sort", None, 0.1, 0.2)]
    got = device_profile.summarize(events, 0.3, 1)
    assert got["idle_gaps"] == {"aten::sort": pytest.approx(0.1)}
    assert got["busy_s"] == pytest.approx(0.2)
    assert _one_list(events, 0.3, 1)["idle_gaps"] == {}


def test_card_state_of_each_card(monkeypatch):
    # nvidia-smi's order is not CUDA's; the UUID finds each card.
    smi = "".join(f"GPU-u{i}, NVIDIA H100 80GB HBM3, 1980 MHz, 2619 MHz, 7{i}.1 W, "
                  f"700.00 W, 3{i}\n" for i in (2, 0, 3, 1))
    monkeypatch.setattr(host_pace.subprocess, "run",
                        lambda *a, **k: types.SimpleNamespace(stdout=smi))
    props = {"uuid": lambda d: types.SimpleNamespace(uuid=f"u{d.index}"),
             "none": lambda d: types.SimpleNamespace()}
    fake = types.SimpleNamespace(cuda=types.SimpleNamespace(get_device_properties=props["uuid"]))
    devs = [torch.device(f"cuda:{i}") for i in range(4)]
    states = host_pace.card_state(fake, devs)
    assert [s["temperature.gpu"] for s in states] == ["30", "31", "32", "33"]
    assert list(states[0]) == list(host_pace.KEYS)
    assert host_pace.card_state(fake, devs[1:2]) == states[1]  # one card: its dict
    fake.cuda.get_device_properties = props["none"]  # no UUID: by index
    assert [s["temperature.gpu"] for s in host_pace.card_state(fake, devs)] == [
        "32", "30", "33", "31"]

    def no_smi(*a, **k):
        raise OSError("no nvidia-smi")

    monkeypatch.setattr(host_pace.subprocess, "run", no_smi)
    assert host_pace.card_state(fake, devs[:1]) == {}
    assert host_pace.card_state(fake, devs) == [{}] * 4


class _Products(drivers.Driver):
    """A kind of traffic of this test only: a short loop of matrix
    products on every card the run was given."""

    def cards(self):
        return self.devs

    def setup(self):
        self.xs = [torch.full((512, 512), 1.0 / 512, device=d) for d in self.cards()]
        self.unit()
        self.attempted = 0

    def unit(self):
        self.sums = [(x @ x @ x).sum() for x in self.xs]
        self.attempted += 1

    def end_to_end(self, window_s, times):
        return {"stub_ms": 1e3 * window_s / len(times)}

    def check(self):
        # Each product's entries are 1/512: the sum is 512 on every card.
        return {"off": max(abs(float(s) - 512.0) / 512.0 for s in self.sums)}


class _HomeProducts(_Products):
    """The same loop on the home card alone, though given several."""

    def cards(self):
        return [self.dev]


def _stub_cell(chips: int) -> dict:
    name = "stub_products"
    return dict(name=name, entry={"name": name, "chips": chips},
                workload={"profile_units": 3, "limits": {"off": 1e-5}},
                config=spec.load_json(os.path.join(spec.HERE, "configs",
                                                   "sphereflake_1080p_d6.json")),
                traffic={"kind": "stub"},
                end_to_end=[{"name": "stub_ms", "unit": "ms"},
                            {"name": "setup_s", "unit": "s"}],
                per_layer=[], here=spec.HERE)


def _stubbed(monkeypatch, kind):
    monkeypatch.setattr(drivers, "make", lambda t, cell, seed, devs: kind(t, cell, seed, devs))


def test_run_given_two_devices_reports_the_one_it_used(monkeypatch, capsys):
    """On the CPU two devices given are one device used."""
    _stubbed(monkeypatch, _Products)
    res = run.run(torch, _stub_cell(2), SEED, 0.2, True, ["cpu", "cpu"])["result"]
    assert res["correct"] is True, res["checks"]
    assert res["device"]["count"] == 1
    assert res["device"]["memory_peak_bytes_per_device"] == [0, 0]
    assert "benchmark: cell stub_products used 1 of 2 cards" in capsys.readouterr().err


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("kind,used", [(_Products, 4), (_HomeProducts, 1)])
def test_four_cards(kind, used, trace, cards4, monkeypatch, capsys):
    _stubbed(monkeypatch, kind)
    res = run.run(torch, _stub_cell(4), SEED, 1.0, bool(trace), cards4)["result"]
    assert res["correct"] is True, res["checks"]
    dev = res["device"]
    assert dev["count"] == used
    # A card may hold what an earlier case left (a cuBLAS workspace), so
    # the peaks of the cards left idle need not be 0 in this process.
    peaks = dev["memory_peak_bytes_per_device"]
    assert len(peaks) == 4 and dev["memory_peak_bytes"] == max(peaks) and peaks[0] > 0
    err = capsys.readouterr().err
    assert ("used 1 of 4 cards" in err) == (used == 1), err
    if trace:
        shares = [b / dev["window_s"] for b in dev["busy_s_per_device"]]
        assert sum(s > 0 for s in shares) == used, shares
        assert dev["busy_s"] > 0
