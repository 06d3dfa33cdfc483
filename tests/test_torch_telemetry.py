"""The port's telemetry against the JAX package's, on the API the module
path writes: counters, gauges, histograms (with their label sets), the
solver families, spans, and the on/off switch."""

import importlib

import pytest

from _torch_threads import one_torch_thread  # noqa: F401

PACKAGES = ("agentlib_mpc_tpu", "agentlib_mpc_torch")


@pytest.fixture()
def telemetries():
    mods = [importlib.import_module(f"{pkg}.telemetry") for pkg in PACKAGES]
    before = [t.enabled() for t in mods]
    yield mods
    for t, on in zip(mods, before):
        t.configure(enabled=on)


def _write(t, on: bool):
    t.configure(enabled=on)
    c = t.counter("parity_total", "a counter")
    c.inc(agent="a")
    c.inc(2.0, agent="a")
    c.inc(agent="b")
    t.gauge("parity_level", "a gauge").set(3, agent="a")
    h = t.histogram("parity_seconds", "a histogram")
    for v in (0.0005, 0.02, 7.0):
        h.observe(v, agent="a")
    t.solver_metrics()["failures"].inc(backend="JAXBackend")
    with t.span("parity.span", agent="a"):
        pass
    reg = t.metrics()
    return [reg.get("parity_total", agent="a"),
            reg.get("parity_total", agent="b"),
            reg.get("parity_total", agent="c"),
            reg.get("parity_level", agent="a"),
            reg.get("parity_seconds", agent="a"),
            reg.get("solver_failures_total", backend="JAXBackend"),
            reg.get("no_such_family"),
            sum(s.name == "parity.span" for s in t.recorder().spans())]


@pytest.mark.parametrize("on", [True, False], ids=["enabled", "disabled"])
def test_telemetry_records_alike(telemetries, on):
    for t in telemetries:
        t.reset()
    ref, port = (_write(t, on) for t in telemetries)
    assert port == ref


def test_solver_families_share_names_and_kinds(telemetries):
    ref, port = (t.solver_metrics() for t in telemetries)
    assert sorted(ref) == sorted(port)
    for key in ref:
        assert (port[key].name, port[key].kind, port[key].help) == \
            (ref[key].name, ref[key].kind, ref[key].help)
