"""The aux modules through both packages, on the cases of
``tests/test_aux_modules.py``: time utils, PID, the set-point generator,
the input predictor and the ``skip_mpc_intervals``/``fallback_pid``
hand-over MAS at that test's size (N=6 multiple shooting) for 3 300 s
(that test runs 4 500 s; the skipped interval and the resumption lie
within the first 3 300), plus
``data_source`` and ``mpc_on_off`` on the cases their docstrings state.
Same inputs, same outputs: floats within 1e-8 relative (float64 on the
CPU), everything else equal."""

import importlib

import numpy as np
import pytest
import torch

import agentlib_mpc_torch.modules  # noqa: F401 - registers module types
import agentlib_mpc_tpu.modules  # noqa: F401 - registers module types

from _torch_threads import one_torch_thread  # noqa: F401

PACKAGES = ("agentlib_mpc_tpu", "agentlib_mpc_torch")
RTOL = 1e-8


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


class _Host:
    """Minimal agent stand-in for module unit tests (with the device and
    dtype the port's modules read)."""

    class _Env:
        now = 0.0

    class _Broker:
        def __init__(self):
            self.sent = []

        def register_callback(self, *a, **k):
            pass

        def send_variable(self, v):
            self.sent.append((v.name, v.alias, v.value, v.shared))

    def __init__(self):
        self.id = "host"
        self.env = self._Env()
        self.data_broker = self._Broker()
        self.device = torch.device("cpu")
        self.dtype = torch.float64


def both(fn):
    ref, port = (fn(pkg) for pkg in PACKAGES)
    assert repr(port) == repr(ref)
    return port


def test_time_utils_match():
    def run(pkg):
        t = mod(pkg, "utils.time_utils")
        return [t.convert_time(2, "hours", "seconds"),
                t.convert_time(86400, "seconds", "days"),
                t.is_time_in_intervals(5, [(0, 10)]),
                t.is_time_in_intervals(11, [(0, 10)]),
                t.is_time_in_intervals(15, [(0, 10), (12, 20)])]

    assert both(run) == [7200, 1, True, False, True]


@pytest.mark.parametrize("case", [
    {"steps": [(8.0, 0.0), (8.0, 1.0)]},
    {"Ti": 10.0, "steps": [(8.0, 0.0), (8.0, 1.0), (8.0, 2.0)]},
    {"Ti": 1.0, "ub": 1.0,
     "steps": [(0.0, float(k)) for k in range(20)] + [(20.0, 21.0)]},
    {"reverse_acting": True, "steps": [(12.0, 0.0), (12.0, 1.0)]},
    {"Td": 2.0, "lb": -1.0, "steps": [(9.0, 0.0), (11.0, 0.5), (10.0, 1.0),
                                      (10.0, 1.0)]},
], ids=["proportional", "integral", "antiwindup", "reverse", "derivative"])
def test_pid_steps_match(case):
    case = dict(case)
    steps = case.pop("steps")

    def run(pkg):
        pid = mod(pkg, "modules.pid").PID(
            {"module_id": "pid", "input": {"name": "y"},
             "output": {"name": "u"}, "setpoint": 10.0, "Kp": 2.0, **case},
            _Host())
        return [(pid.do_step(y, t), pid.integral) for y, t in steps]

    out = both(run)
    assert out[0][0] is None                   # the first sample arms timing


def test_set_point_bands_and_draws_match():
    def run(pkg):
        gen = mod(pkg, "modules.setpoint_generator").SetPointGenerator(
            {"module_id": "sp", "interval": 3600, "day_start": 8,
             "day_end": 16, "seed": 3}, _Host())
        bands = [gen.band_at(h * 3600.0) for h in (10, 20, 5 * 24 + 12)]
        proc = gen.process()
        delays = [next(proc) for _ in range(3)]
        return [bands, delays, gen.agent.data_broker.sent]

    bands, _, sent = both(run)
    assert bands[0] == (292.15, 297.15) and bands[2] == (289.15, 299.15)
    assert len(sent) == 3


def test_input_predictor_matches():
    table = {"T_amb": {float(t): 280.0 + t / 100.0
                       for t in range(0, 7200, 600)}}

    def run(pkg):
        p = mod(pkg, "modules.input_prediction").InputPredictor(
            {"module_id": "weather", "data": table, "t_sample": 600,
             "prediction_horizon": 1800, "prediction_sample": 600},
            _Host())
        times, vals = p.get_prediction_at_time(1200.0)["T_amb"]
        onto = mod(pkg, "utils.sampling").sample(
            (times, vals), [0.0, 600.0], current=1200.0)
        return [times, vals, onto.tolist(), p.get_data_at_time(900.0)]

    times, vals, onto, now = both(run)
    assert len(times) == 4 and vals[0] == pytest.approx(292.0)
    np.testing.assert_allclose(onto, [292.0, 298.0])


def test_forecast_ensembles_wait_for_the_scenario_slice():
    """The forecast-ensemble hooks came with the scenario-tree slice: they
    no longer raise, and draw the JAX package's ensembles
    (tests/test_torch_scenario_tree.py holds them against the JAX
    package's bit for bit)."""
    import pandas as pd

    from agentlib_mpc_torch.modules.input_prediction import InputPredictor
    from agentlib_mpc_torch.utils.try_format import try_forecast_ensemble

    p = InputPredictor({"module_id": "w", "data": {"a": {0.0: 1.0,
                                                         600.0: 2.0}}},
                       _Host())
    times, vals = p.get_prediction_ensemble_at_time(0.0, n_scenarios=2)["a"]
    assert np.shape(vals) == (2, len(times))
    df = pd.DataFrame({"t": np.linspace(280.0, 290.0, 8)},
                      index=np.arange(8) * 3600.0)
    assert try_forecast_ensemble(df, "t", 0.0, 4, 2).shape == (2, 4)


@pytest.mark.parametrize("method,offset", [("linear", 0.0),
                                           ("previous", 0.0),
                                           ("linear", 450.0)])
def test_data_source_replay_matches(method, offset):
    """DataSource docstring: publish each column every t_sample, linear
    or zero-order hold, with data_offset shifting the lookup."""
    table = {"load": {0.0: 100.0, 600.0: 160.0, 1200.0: 130.0},
             "T_in": {0.0: 290.0, 1200.0: 291.0}}

    def run(pkg):
        src = mod(pkg, "modules.data_source").DataSource(
            {"module_id": "src", "data": table, "t_sample": 300,
             "interpolation_method": method, "data_offset": offset,
             "outputs": [{"name": "load"}]}, _Host())
        values = [src.get_data_at_time(t) for t in (0.0, 150.0, 450.0,
                                                    900.0, 5000.0)]
        proc = src.process()
        next(proc)
        return [src.columns, values, src.agent.data_broker.sent]

    columns, values, sent = both(run)
    assert columns == ["load"]
    assert sent == [("load", "load", values[0]["load"], True)]


def test_mpc_on_off_broadcasts_the_flag_and_fallback_values():
    """MPCOnOff docstring: the active flag every t_sample and, while
    inactive, the fallback control values; SkipMPCInIntervals inside its
    intervals (unit-convertible)."""
    def run(pkg):
        deact = mod(pkg, "modules.deactivate_mpc")
        host = _Host()
        skip = deact.SkipMPCInIntervals(
            {"module_id": "onoff", "t_sample": 60, "time_unit": "minutes",
             "intervals": [[10, 20]],
             "controls_when_deactivated": [{"name": "mDot", "value": 0.0}]},
            host)
        out = []
        for t in (0.0, 600.0, 1200.0, 1260.0):
            host.env.now = t
            out.append(skip.check_mpc_deactivation())
            next(skip.process())
        return [out, host.data_broker.sent]

    flags, sent = both(run)
    assert flags == [False, True, True, False]
    assert ("mDot", "mDot", 0.0, True) in sent


def make_one_room_fast(pkg):
    """tests/test_aux_modules.py's OneRoomFast, in one package."""
    m = mod(pkg, "models.model")
    v_ = mod(pkg, "models.variables")
    SubObjective = mod(pkg, "models.objective").SubObjective

    class OneRoomFast(m.Model):
        inputs = [
            v_.control_input("mDot", 0.02, lb=0.0, ub=0.05),
            v_.control_input("load", 150.0),
            v_.control_input("T_in", 290.15),
            v_.control_input("T_upper", 295.15),
        ]
        states = [v_.state("T", 295.15, lb=288.15, ub=303.15),
                  v_.state("T_slack", 0.0)]
        parameters = [v_.parameter("cp", 1000.0),
                      v_.parameter("C", 100000.0),
                      v_.parameter("s_T", 0.01), v_.parameter("r_mDot", 0.1)]
        outputs = [v_.output("T_out")]

        def setup(self, v):
            eq = m.ModelEquations()
            eq.ode("T", v.cp * v.mDot / v.C * (v.T_in - v.T) + v.load / v.C)
            eq.alg("T_out", v.T)
            eq.constraint(0.0, v.T + v.T_slack, v.T_upper)
            eq.objective = (SubObjective(v.mDot, weight=v.r_mDot, name="c")
                            + SubObjective(v.T_slack ** 2, weight=v.s_T,
                                           name="s"))
            return eq

    return OneRoomFast


def handover_configs(model_cls):
    """tests/test_aux_modules.py's hand-over MAS (with the plain LDLᵀ, and
    without QP routing: the nonlinear room never takes the QP path, and
    "auto" would spend the JAX package's sampled LQ probe on proving
    it)."""
    mpc_agent = {
        "id": "Controller",
        "modules": [
            {"module_id": "com", "type": "local_broadcast"},
            {"module_id": "mpc", "type": "mpc",
             "enable_deactivation": True,
             "optimization_backend": {
                 "type": "jax",
                 "model": {"class": model_cls},
                 "discretization_options": {"method": "multiple_shooting"},
                 "solver": {"max_iter": 40, "kkt_method": "ldl",
                        "qp_fast_path": "off"}},
             "time_step": 300, "prediction_horizon": 6,
             "inputs": [{"name": "T_in"}, {"name": "load"},
                        {"name": "T_upper"}],
             "controls": [{"name": "mDot", "value": 0.02,
                           "lb": 0, "ub": 0.05}],
             "states": [{"name": "T", "value": 297.15, "alias": "T",
                         "source": "Plant"}],
             "outputs": [{"name": "T_out", "shared": False}],
             "parameters": []},
            {"module_id": "onoff", "type": "skip_mpc_intervals",
             "t_sample": 300, "intervals": [[1500, 3000]]},
            {"module_id": "fallback", "type": "fallback_pid",
             "input": {"name": "T", "alias": "T", "source": "Plant"},
             "output": {"name": "mDot", "alias": "mDot"},
             "setpoint": 295.15, "Kp": 0.01, "Ti": 600.0,
             "lb": 0.0, "ub": 0.05, "reverse_acting": True},
        ],
    }
    plant_agent = {
        "id": "Plant",
        "modules": [
            {"module_id": "com", "type": "local_broadcast"},
            {"module_id": "room", "type": "simulator",
             "model": {"class": model_cls,
                       "states": [{"name": "T", "value": 297.15}]},
             "t_sample": 60,
             "inputs": [{"name": "mDot", "alias": "mDot"}],
             "outputs": [{"name": "T_out", "alias": "T"}]},
        ],
    }
    return [mpc_agent, plant_agent]


def test_handover_mas_matches():
    runs = {}
    for pkg in PACKAGES:
        kw = ({"device": "cpu", "dtype": torch.float64}
              if pkg == "agentlib_mpc_torch" else {})
        mas = mod(pkg, "runtime.mas").LocalMAS(
            handover_configs(make_one_room_fast(pkg)), env={"rt": False},
            **kw)
        mas.run(until=3600)
        mpc = mas.agents["Controller"].get_module("mpc")
        runs[pkg] = {
            "solves": [(r["time"], r["iterations"], r["success"])
                       for r in mpc.backend.stats_history],
            "rows": mas.agents["Plant"].get_module("room")._rows,
            "flag": mas.agents["Controller"].get_module("onoff")
            .vars["mpc_active"].value}
    ref, port = (runs[pkg] for pkg in PACKAGES)
    assert port["solves"] == ref["solves"]
    times = np.array([t for t, _, _ in port["solves"]])
    assert not np.any((times >= 1800) & (times < 3000))
    assert np.any(times >= 3000) and np.any(times < 1500)
    assert port["flag"] == ref["flag"]
    assert len(port["rows"]) == len(ref["rows"]) > 0
    for p, r in zip(port["rows"], ref["rows"]):
        assert set(p) == set(r)
        for key, value in r.items():
            np.testing.assert_allclose(p[key], value, rtol=RTOL,
                                       err_msg=f"{key} at t={r['time']}")
    outage = [r["mDot"] for r in port["rows"] if 2000 < r["time"] < 3000]
    assert max(outage) > 0.0                   # the FallbackPID cooled
    assert port["rows"][-1]["T_out"] < 296.5
