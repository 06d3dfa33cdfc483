"""Container entry point: run one agent (or a local group) from a config
file, joined to the fleet over MQTT.

Port of ``agentlib_mpc_tpu/runtime/container.py``; the port keeps its own
copy and imports nothing of the JAX package.

Counterpart of the reference's cloneMAP container entry
(``DockerfileMPC:25`` → agentlib's clonemap communicator): each container
hosts an agent process; inter-agent traffic rides an external broker.
Configuration via environment, the JAX package's variables first:

``AGENT_CONFIG``      path to a JSON agent config (reference shape:
                      ``{"id": ..., "modules": [...]}``) or a JSON list of
                      such configs (one container hosting a local group)
``MQTT_HOST``/``MQTT_PORT``  broker address (default localhost:1883);
                      set ``MQTT_HOST=none`` for an isolated container
                      (single-agent simulation, no fleet)
``MQTT_RECONNECT_MAX_DELAY``  cap (s) on the decorrelated-jitter
                      reconnect backoff (default 1.0)
``RUN_UNTIL``         simulation/wall-clock horizon in seconds
                      (default: run forever in wall-clock mode)
``REALTIME``          "1" (default) wall-clock env; "0" fast simulation
``RESULTS_DIR``       when set, every module's results frame is written
                      to ``<dir>/<agent>__<module>.csv`` on shutdown
                      (the reference's results CSVs, written by the
                      container instead of the host)
``LOG_LEVEL``         logging level (default INFO)

and the port's two, which take the place of the JAX container's
``JAX_PLATFORMS`` (its device) and JAX's x64 switch (its width):

``AGENT_DEVICE``      the torch device every agent computes on (default
                      ``cuda``, the card); ``cpu`` runs on the CPU. Without
                      a card and without this variable the container exits
                      with code 2: it never falls back to the CPU itself
``AGENT_DTYPE``       ``float32`` (default, as ``LocalMAS``) or ``float64``

Usage: ``python -m agentlib_mpc_torch.runtime.container``
"""

from __future__ import annotations

import json
import logging
import os
import signal
import sys

import torch

from agentlib_mpc_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def load_configs(path: str) -> list[dict]:
    with open(path) as fh:
        cfg = json.load(fh)
    return cfg if isinstance(cfg, list) else [cfg]


def build_mas(configs: list[dict], realtime: bool = True,
              mqtt_host: str | None = None, mqtt_port: int = 1883,
              device=None, dtype: torch.dtype = torch.float32):
    """LocalMAS over the configs on ``device`` (None: the card) in
    ``dtype``; optionally bridged onto an MQTT broker so other containers'
    agents appear as external peers."""
    import agentlib_mpc_torch.modules  # noqa: F401 - register module types
    from agentlib_mpc_torch.runtime.mas import LocalMAS

    mas = LocalMAS(configs, env={"rt": realtime, "factor": 1.0},
                   device=device, dtype=dtype)
    buses = []
    if mqtt_host and mqtt_host.lower() != "none":
        from agentlib_mpc_torch.runtime.mqtt import MqttBus

        reconnect_cap = float(
            os.environ.get("MQTT_RECONNECT_MAX_DELAY", "1.0"))
        for agent_id, agent in mas.agents.items():
            bus = MqttBus(agent_id, broker_host=mqtt_host,
                          broker_port=mqtt_port,
                          reconnect_max_delay=reconnect_cap)
            bus.attach(agent.data_broker)
            buses.append(bus)
    return mas, buses


def write_results(mas, results_dir: str) -> list[str]:
    """Persist every module's results frame as
    ``<dir>/<agent>__<module>.csv`` (reference results-CSV role)."""
    os.makedirs(results_dir, exist_ok=True)
    written = []
    for agent_id, modules in mas.get_results().items():
        for module_id, df in modules.items():
            path = os.path.join(results_dir,
                                f"{agent_id}__{module_id}.csv")
            try:
                df.to_csv(path)
                written.append(path)
            except Exception as exc:  # noqa: BLE001 - best-effort dump
                logger.warning("could not write %s: %s", path, exc)
    logger.info("wrote %d results CSVs to %s", len(written), results_dir)
    return written


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(
        level=os.environ.get("LOG_LEVEL", "INFO"),
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    config_path = os.environ.get("AGENT_CONFIG")
    if not config_path:
        print("AGENT_CONFIG must point to a JSON agent config",
              file=sys.stderr)
        return 2
    dtype_name = os.environ.get("AGENT_DTYPE", "float32")
    if dtype_name not in DTYPES:
        print(f"AGENT_DTYPE must be one of {sorted(DTYPES)}, got "
              f"{dtype_name!r}", file=sys.stderr)
        return 2
    try:
        device = resolve_device(os.environ.get("AGENT_DEVICE"))
    except RuntimeError as exc:
        print(f"{exc}; set AGENT_DEVICE=cpu to run this container on the "
              f"CPU", file=sys.stderr)
        return 2
    configs = load_configs(config_path)
    realtime = os.environ.get("REALTIME", "1") != "0"
    until_env = os.environ.get("RUN_UNTIL")
    until = float(until_env) if until_env else (
        float("inf") if realtime else 24 * 3600.0)
    mas, buses = build_mas(
        configs, realtime=realtime,
        mqtt_host=os.environ.get("MQTT_HOST", "localhost"),
        mqtt_port=int(os.environ.get("MQTT_PORT", "1883")),
        device=device, dtype=DTYPES[dtype_name])

    stop = {"flag": False}

    def _sig(_signum, _frame):
        stop["flag"] = True

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)
    try:
        if realtime:
            # run in slices so SIGTERM can land between env.run calls —
            # a finite wall-clock horizon must be interruptible too, or
            # docker stop's grace period expires and SIGKILL skips the
            # clean terminate()/close() below
            t = 0.0
            while not stop["flag"] and t < until:
                t = min(t + 5.0, until)
                mas.run(until=t)
        else:
            mas.run(until=until)
    finally:
        mas.terminate()
        results_dir = os.environ.get("RESULTS_DIR")
        if results_dir:
            try:
                write_results(mas, results_dir)
            except Exception as exc:  # noqa: BLE001 - best-effort dump:
                # a read-only mount must not leak the buses below or
                # mask an original exception from the run
                logger.warning("results dump to %s failed: %s",
                               results_dir, exc)
        for bus in buses:
            bus.close()
    logger.info("container agent(s) %s shut down cleanly",
                [c.get("id") for c in configs])
    return 0


if __name__ == "__main__":
    sys.exit(main())
