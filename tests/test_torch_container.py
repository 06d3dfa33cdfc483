"""The port's container entry point (``runtime/container.py``) and results
loaders (``utils/analysis.py``) against the JAX package's.

- the tests of ``tests/test_container.py`` on the port, with the port's
  two variables: ``AGENT_DEVICE`` (default the card) and ``AGENT_DTYPE``;
- without a card and without ``AGENT_DEVICE`` the container exits
  non-zero, in-process and as ``python -m``;
- parity: the deploy fleet's four agents (``deploy/fleet/*.json``) in one
  config file, ``MQTT_HOST=none``, ``REALTIME=0``, float64, through each
  package's ``main()``. The solver's ``qp_fast_path`` is set to the
  verdict the JAX package's sampled probe reaches on these configs (room
  off, cooler on), so the JAX side skips the probe's half minute; the rest
  of the configs is the deploy files'. The plant's temperatures agree
  within 1e-6 K, the coordinator's residuals within 1e-6 relative with the
  same ADMM iterations per round, and the room's ADMM and MPC frames
  (written by ``utils.analysis.save_results``: the containers of both
  packages skip a module whose results are a dict of frames) within
  1e-6;
- the port's loaders and slicers give the JAX package's frames on those
  CSVs;
- the fleet across process boundaries: coordinator, room and cooler as
  three ``python -m agentlib_mpc_torch.runtime.container`` processes on
  the CPU in float64, joined over the port's ``MiniBroker`` on the wall
  clock.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from agentlib_mpc_torch.runtime import container as pcontainer
from agentlib_mpc_torch.utils import analysis as panalysis
from agentlib_mpc_tpu.runtime import container as jcontainer
from agentlib_mpc_tpu.utils import analysis as janalysis
from test_mqtt import _FakeBrokerHub, _install_fake_paho

from _torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
FLEET = REPO / "deploy" / "fleet"
AGENT = {
    "id": "weather",
    "modules": [
        {"module_id": "com", "type": "local_broadcast"},
        {"module_id": "src", "type": "data_source",
         "data": {"T_amb": {0.0: 280.0, 3600.0: 290.0}},
         "t_sample": 600.0},
    ],
}
PARITY_UNTIL = 30.0
#: the JAX package's probe verdicts on the deploy configs
QP_FAST_PATH = {"CooledRoom": "off", "Cooler": "on"}


def test_load_configs_single_and_list(tmp_path):
    p1 = tmp_path / "one.json"
    p1.write_text(json.dumps(AGENT))
    assert [c["id"] for c in pcontainer.load_configs(p1)] == ["weather"]
    p2 = tmp_path / "two.json"
    p2.write_text(json.dumps([AGENT, {**AGENT, "id": "weather2"}]))
    assert [c["id"] for c in pcontainer.load_configs(p2)] == [
        "weather", "weather2"]
    assert pcontainer.load_configs(FLEET / "room.json") == \
        jcontainer.load_configs(FLEET / "room.json")


def test_build_and_run_isolated():
    mas, buses = pcontainer.build_mas([AGENT], realtime=False,
                                      mqtt_host="none", device="cpu",
                                      dtype=torch.float64)
    assert buses == [] and mas.dtype == torch.float64
    mas.run(until=1800.0)
    mod = mas.agents["weather"].get_module("src")
    assert abs(mod.get_value("T_amb") - (280.0 + 10.0 * 1800 / 3600)) < 1e-6
    mas.terminate()


def test_build_with_mqtt_bridge(monkeypatch):
    _install_fake_paho(monkeypatch, _FakeBrokerHub())
    mas, buses = pcontainer.build_mas([AGENT], realtime=False,
                                      mqtt_host="broker.local",
                                      mqtt_port=1884, device="cpu")
    assert len(buses) == 1 and buses[0].client_impl == "paho"
    assert buses[0]._client.connected == ("broker.local", 1884)
    mas.run(until=600.0)
    mas.terminate()
    for bus in buses:
        bus.close()
    assert buses[0]._client.loop_running is False


def test_main_end_to_end(tmp_path, monkeypatch):
    cfg = tmp_path / "agent.json"
    cfg.write_text(json.dumps(AGENT))
    for key, value in {"AGENT_CONFIG": str(cfg), "MQTT_HOST": "none",
                       "REALTIME": "0", "RUN_UNTIL": "1200",
                       "AGENT_DEVICE": "cpu",
                       "AGENT_DTYPE": "float64"}.items():
        monkeypatch.setenv(key, value)
    assert pcontainer.main([]) == 0
    monkeypatch.setenv("AGENT_DTYPE", "bfloat16")
    assert pcontainer.main([]) == 2


def test_main_requires_config(monkeypatch):
    monkeypatch.delenv("AGENT_CONFIG", raising=False)
    assert pcontainer.main([]) == 2


def test_no_card_and_no_device_variable_exits_non_zero(tmp_path,
                                                      monkeypatch, capsys):
    """Without a card the container does not carry on on the CPU by
    itself: it exits with code 2 and says how to ask for the CPU."""
    cfg = tmp_path / "agent.json"
    cfg.write_text(json.dumps(AGENT))
    monkeypatch.setenv("AGENT_CONFIG", str(cfg))
    monkeypatch.setenv("MQTT_HOST", "none")
    monkeypatch.delenv("AGENT_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pcontainer.main([]) == 2
    assert "AGENT_DEVICE=cpu" in capsys.readouterr().err
    env = {k: v for k, v in os.environ.items() if k != "AGENT_DEVICE"}
    env.update(AGENT_CONFIG=str(cfg), MQTT_HOST="none", REALTIME="0",
               RUN_UNTIL="600", CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-m", "agentlib_mpc_torch.runtime.container"],
        env=env, cwd=str(REPO), capture_output=True, text=True, timeout=120)
    assert out.returncode == 2, out.stdout + out.stderr
    assert "AGENT_DEVICE=cpu" in out.stderr


# -- parity of the deploy fleet -------------------------------------------------

def _fleet_configs() -> list:
    configs = []
    for name in ("coordinator", "room", "cooler"):
        cfg = json.loads((FLEET / f"{name}.json").read_text())
        configs += cfg if isinstance(cfg, list) else [cfg]
    for cfg in configs:
        for mod in cfg["modules"]:
            backend = mod.get("optimization_backend")
            if backend is not None:
                backend["solver"]["qp_fast_path"] = QP_FAST_PATH[cfg["id"]]
    return configs


def _run_main(pkg, tmp, monkeypatch, extra_env):
    """One package's container ``main()`` over the fleet configs: its
    results CSVs, and every module's frames by ``save_results`` of the
    package's ``utils.analysis`` (from the MAS ``main`` built)."""
    container, analysis = pkg
    cfg = tmp / "fleet.json"
    cfg.write_text(json.dumps(_fleet_configs()))
    for key, value in {"AGENT_CONFIG": str(cfg), "MQTT_HOST": "none",
                       "REALTIME": "0", "RUN_UNTIL": str(PARITY_UNTIL),
                       "RESULTS_DIR": str(tmp / "csv"), **extra_env}.items():
        monkeypatch.setenv(key, value)
    built = {}

    def capture(*args, **kwargs):
        built["mas"], buses = build(*args, **kwargs)
        return built["mas"], buses

    build = container.build_mas
    monkeypatch.setattr(container, "build_mas", capture)
    assert container.main([]) == 0
    analysis.save_results(built["mas"].get_results(), tmp / "frames")
    return built["mas"]


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, pkg, env in (
                ("port", (pcontainer, panalysis),
                 {"AGENT_DEVICE": "cpu", "AGENT_DTYPE": "float64"}),
                ("jax", (jcontainer, janalysis), {})):
            tmp = tmp_path_factory.mktemp(name)
            mas = _run_main(pkg, tmp, mp, env)
            out[name] = {"dir": tmp, "mas": mas}
    return out


def test_fleet_parity_plant_and_coordinator(parity):
    p, j = parity["port"]["dir"] / "csv", parity["jax"]["dir"] / "csv"
    names = sorted(f.name for f in p.iterdir())
    assert names == sorted(f.name for f in j.iterdir()) == [
        "Coordinator__coordinator.csv", "Simulation__simulator.csv"]
    ps, js = (panalysis.load_sim(d / "Simulation__simulator.csv")
              for d in (p, j))
    assert len(ps) == int(PARITY_UNTIL / 5) and (ps.index == js.index).all()
    np.testing.assert_allclose(ps["T_out"], js["T_out"], rtol=0, atol=1e-6)
    assert ps["T_out"].iloc[-1] < ps["T_out"].iloc[0]          # it cools
    pc, jc = (panalysis.load_mpc_stats(d / "Coordinator__coordinator.csv")
              for d in (p, j))
    cols = ["primal_residual", "dual_residual", "penalty_parameter"]
    assert set(cols) <= set(pc.columns)
    iters = [len(g) for _, g in pc.groupby("time")]
    assert iters == [len(g) for _, g in jc.groupby("time")]
    assert len(iters) == int(PARITY_UNTIL / 5) and iters[0] == 5
    np.testing.assert_allclose(pc[cols].to_numpy(), jc[cols].to_numpy(),
                               rtol=1e-6, atol=1e-12)
    room = parity["port"]["mas"].agents["CooledRoom"].get_module("admm")
    cooler = parity["port"]["mas"].agents["Cooler"].get_module("admm")
    assert room.backend.dtype == torch.float64
    assert not room.backend.uses_qp_fast_path
    assert cooler.backend.uses_qp_fast_path
    assert all(r["success"] for m in (room, cooler)
               for r in m.backend.stats_history)


@pytest.mark.parametrize("part,loader,index_levels", [
    ("admm", "load_admm", 3), ("mpc", "load_mpc", 2)])
@pytest.mark.parametrize("agent", ["CooledRoom", "Cooler"])
def test_fleet_parity_admm_frames(parity, agent, part, loader,
                                  index_levels):
    name = f"{agent}_admm_{part}.csv"
    pf, jf = (getattr(panalysis, loader)(parity[k]["dir"] / "frames" / name)
              for k in ("port", "jax"))
    assert pf.index.nlevels == index_levels
    assert list(pf.columns) == list(jf.columns)
    np.testing.assert_allclose(
        np.asarray(pf.index.to_frame(), dtype=float),
        np.asarray(jf.index.to_frame(), dtype=float), rtol=0, atol=1e-12)
    np.testing.assert_allclose(pf.to_numpy(dtype=float),
                               jf.to_numpy(dtype=float), rtol=0, atol=1e-6,
                               equal_nan=True)


def test_loaders_and_slicers_match_the_jax_package(parity):
    frames = parity["port"]["dir"] / "frames"
    csv = parity["port"]["dir"] / "csv"
    pd.testing.assert_frame_equal(
        panalysis.load_sim(csv / "Simulation__simulator.csv"),
        janalysis.load_sim(csv / "Simulation__simulator.csv"))
    pd.testing.assert_frame_equal(
        panalysis.load_mpc_stats(csv / "Coordinator__coordinator.csv"),
        janalysis.load_mpc_stats(csv / "Coordinator__coordinator.csv"))
    admm = {k: a.load_admm(frames / "CooledRoom_admm_admm.csv")
            for k, a in (("port", panalysis), ("jax", janalysis))}
    mpc = {k: a.load_mpc(frames / "CooledRoom_admm_mpc.csv")
           for k, a in (("port", panalysis), ("jax", janalysis))}
    pd.testing.assert_frame_equal(admm["port"], admm["jax"])
    pd.testing.assert_frame_equal(mpc["port"], mpc["jax"])
    df_a, df_m = admm["port"], mpc["port"]
    t_mid = float(np.unique(df_m.index.get_level_values(0))[2])
    for p, j in (
            (panalysis.mpc_at_time_step(df_m, t_mid, variable="mDot"),
             janalysis.mpc_at_time_step(df_m, t_mid, variable="mDot")),
            (panalysis.mpc_at_time_step(df_m, None),
             janalysis.mpc_at_time_step(df_m, None)),
            (panalysis.admm_at_time_step(df_a, 0.0, iteration=2,
                                         variable="mDot"),
             janalysis.admm_at_time_step(df_a, 0.0, iteration=2,
                                         variable="mDot")),
            (panalysis.admm_at_time_step(df_a, None),
             janalysis.admm_at_time_step(df_a, None)),
            (panalysis.first_vals_at_trajectory_index(df_m),
             janalysis.first_vals_at_trajectory_index(df_m)),
            (panalysis.last_vals_at_trajectory_index(df_m),
             janalysis.last_vals_at_trajectory_index(df_m)),
            (panalysis.convert_index(df_a, "minutes"),
             janalysis.convert_index(df_a, "minutes")),
            (panalysis.convert_index(
                panalysis.load_sim(csv / "Simulation__simulator.csv")),
             janalysis.convert_index(
                 janalysis.load_sim(csv / "Simulation__simulator.csv")))):
        if isinstance(p, pd.Series) and p.dtype == object:
            # first/last values: a Series of each solve's row
            p, j = (pd.DataFrame(list(x.values), index=x.index)
                    for x in (p, j))
        if isinstance(p, pd.DataFrame):
            pd.testing.assert_frame_equal(p, j)
        else:
            pd.testing.assert_series_equal(p, j)
    counts = panalysis.get_number_of_iterations(df_a)
    assert counts == janalysis.get_number_of_iterations(df_a)
    assert sum(counts.values()) == len(np.unique(np.asarray(
        [df_a.index.get_level_values(0)], dtype=float)))


# -- the fleet across process boundaries ----------------------------------------

def _spawn(config: Path, port: int, results: Path, until):
    env = dict(os.environ)
    env.update({"PYTHONPATH": str(REPO), "AGENT_CONFIG": str(config),
                "AGENT_DEVICE": "cpu", "AGENT_DTYPE": "float64",
                "MQTT_HOST": "127.0.0.1", "MQTT_PORT": str(port),
                "REALTIME": "1", "RESULTS_DIR": str(results),
                "LOG_LEVEL": "INFO", "OMP_NUM_THREADS": "1"})
    if until is None:
        env.pop("RUN_UNTIL", None)
    else:
        env["RUN_UNTIL"] = str(until)
    return subprocess.Popen(
        [sys.executable, "-m", "agentlib_mpc_torch.runtime.container"],
        env=env, cwd=str(REPO), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def test_fleet_across_process_boundaries(tmp_path):
    from agentlib_mpc_torch.runtime.mqtt_native import MiniBroker

    broker = MiniBroker()
    results = tmp_path / "results"
    procs = {}
    try:
        # the coordinator runs until it is stopped (SIGTERM, the
        # docker-stop path), once both participants have exited
        procs["coordinator"] = _spawn(FLEET / "coordinator.json",
                                      broker.port, results, None)
        procs["room"] = _spawn(FLEET / "room.json", broker.port, results,
                               10.0)
        procs["cooler"] = _spawn(FLEET / "cooler.json", broker.port,
                                 results, 10.0)
        logs = {}
        for name in ("room", "cooler"):
            logs[name], _ = procs[name].communicate(timeout=120)
            assert procs[name].returncode == 0, logs[name][-3000:]
        procs["coordinator"].terminate()
        logs["coordinator"], _ = procs["coordinator"].communicate(
            timeout=60)
        assert procs["coordinator"].returncode == 0, \
            logs["coordinator"][-3000:]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        broker.stop()
    assert broker.messages_routed > 0
    for agent in ("CooledRoom", "Cooler"):
        assert f"registered agent Source(agent_id='{agent}'" in \
            logs["coordinator"], logs["coordinator"][-3000:]
    stats = panalysis.load_mpc_stats(results / "Coordinator__coordinator.csv")
    assert {"primal_residual", "dual_residual",
            "penalty_parameter"} <= set(stats.columns)
    assert stats.index.get_level_values(0).nunique() >= 1
    assert np.isfinite(stats["primal_residual"].to_numpy()).all()
    sim = panalysis.load_sim(results / "Simulation__simulator.csv")
    assert len(sim) >= 2 and np.isfinite(sim["T_out"].to_numpy()).all()
