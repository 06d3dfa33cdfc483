"""The agent runtime through both packages: the scenarios of
``tests/test_runtime.py`` (event order, ``call_at``, alias/source
matching, the bus, ``LocalMAS``, stop, a second run, the ``shared`` flag)
run once through the JAX package's runtime and once through the port's,
and their event logs must be identical (the port's on the CPU, asked for
with ``device="cpu"``)."""

import importlib

import pytest

from _torch_threads import one_torch_thread  # noqa: F401

PACKAGES = ("agentlib_mpc_tpu", "agentlib_mpc_torch")


def runtime(pkg):
    """The runtime modules of one package, and a LocalMAS factory (the
    port's takes its device explicitly)."""
    mods = {name: importlib.import_module(f"{pkg}.runtime.{name}")
            for name in ("broker", "environment", "module", "mas",
                         "variables")}

    def mas(configs, **kw):
        if pkg == "agentlib_mpc_torch":
            kw.setdefault("device", "cpu")
        return mods["mas"].LocalMAS(configs, **kw)

    return mods, mas


def _env_order(pkg):
    mods, _ = runtime(pkg)
    env = mods["environment"].Environment()
    log = []

    def proc(name, dt):
        while True:
            log.append((env.now, name))
            yield dt

    env.process(proc("a", 10.0))
    env.process(proc("b", 15.0))
    env.run(until=30.0)
    return log


def _call_at(pkg):
    mods, _ = runtime(pkg)
    env = mods["environment"].Environment()
    hits = []
    env.call_at(5.0, lambda: hits.append(("at", env.now)))
    env.call_in(7.0, lambda: hits.append(("in", env.now)))
    env.run(until=10.0)
    return hits + [("now", env.now)]


def _stop(pkg):
    mods, _ = runtime(pkg)
    env = mods["environment"].Environment()

    def stopper():
        yield 10.0
        env.stop()

    env.process(stopper())
    env.run(until=3600.0)
    return [env.now]


def _alias_source(pkg):
    mods, _ = runtime(pkg)
    AgentVariable, Source = (mods["variables"].AgentVariable,
                             mods["variables"].Source)
    broker = mods["broker"].DataBroker("agent1")
    got = []
    broker.register_callback("T", Source(agent_id="sim"),
                             lambda v: got.append((v.name, v.value)))
    broker.send_variable(AgentVariable(name="x", alias="other",
                                       source=Source("sim")))
    broker.send_variable(AgentVariable(name="T", alias="T",
                                       source=Source("other")))
    broker.send_variable(AgentVariable(name="T", alias="T", value=5.0,
                                       source=Source("sim")))
    return got


def _bus(pkg):
    mods, _ = runtime(pkg)
    AgentVariable, Source = (mods["variables"].AgentVariable,
                             mods["variables"].Source)
    bus = mods["broker"].BroadcastBus()
    b1, b2 = mods["broker"].DataBroker("a1"), mods["broker"].DataBroker("a2")
    bus.join(b1)
    bus.join(b2)
    got = []
    b2.register_callback("T", None, lambda v: got.append(v.value))
    b1.send_variable(AgentVariable(name="T", value=1.0, shared=False,
                                   source=Source("a1")))
    b1.send_variable(AgentVariable(name="T", value=2.0, shared=True,
                                   source=Source("a1")))
    return got


def _register_test_modules(pkg):
    mods, _ = runtime(pkg)
    BaseModule, register = (mods["module"].BaseModule,
                            mods["module"].register_module)

    @register("_rt_counter")
    class Counter(BaseModule):
        def __init__(self, config, agent):
            super().__init__(config, agent)
            self.log = []

        def process(self):
            while True:
                self.log.append(self.env.now)
                yield self.config.get("dt", 1.0)

    @register("_rt_sender")
    class Sender(BaseModule):
        variable_groups = ("outputs",)
        shared_groups = ("outputs",)

        def process(self):
            self.set("y", 42.0)
            return
            yield

    @register("_rt_receiver")
    class Receiver(BaseModule):
        variable_groups = ("inputs",)

    @register("_rt_shared_probe")
    class Probe(BaseModule):
        variable_groups = ("outputs",)
        shared_groups = ("outputs",)


def _local_mas(pkg):
    _register_test_modules(pkg)
    _, mas_of = runtime(pkg)
    mas = mas_of([{"id": "a1", "modules": [
        {"module_id": "c1", "type": "_rt_counter", "dt": 10.0}]}])
    mas.run(until=100.0)
    return mas.agents["a1"].get_module("c1").log


def _second_run(pkg):
    _register_test_modules(pkg)
    _, mas_of = runtime(pkg)
    mas = mas_of([{"id": "a1", "modules": [
        {"module_id": "c1", "type": "_rt_counter", "dt": 10.0}]}])
    mas.run(until=50.0)
    first = list(mas.agents["a1"].get_module("c1").log)
    mas.run(until=100.0)
    return [first, mas.agents["a1"].get_module("c1").log, mas.env.now]


def _variable_sharing(pkg):
    _register_test_modules(pkg)
    _, mas_of = runtime(pkg)
    mas = mas_of([
        {"id": "s", "modules": [
            {"module_id": "m", "type": "_rt_sender",
             "outputs": [{"name": "y", "alias": "meas"}]}]},
        {"id": "r", "modules": [
            {"module_id": "m", "type": "_rt_receiver",
             "inputs": [{"name": "y_in", "alias": "meas", "source": "s"}]}]},
    ])
    mas.run(until=1.0)
    var = mas.agents["r"].get_module("m").get("y_in")
    return [var.value, var.timestamp]


def _communicators_skipped(pkg):
    _register_test_modules(pkg)
    _, mas_of = runtime(pkg)
    mas = mas_of([{"id": "a", "modules": [
        {"module_id": "com", "type": "local_broadcast"},
        {"module_id": "c", "type": "_rt_counter"}]}])
    return list(mas.agents["a"].modules)


def _duplicate_agents(pkg):
    _, mas_of = runtime(pkg)
    with pytest.raises(ValueError, match="duplicate agent") as info:
        mas_of([{"id": "a", "modules": []}, {"id": "a", "modules": []}])
    return [str(info.value)]


def _shared_flag(pkg):
    _register_test_modules(pkg)
    mods, mas_of = runtime(pkg)
    AgentVariable = mods["variables"].AgentVariable
    mas = mas_of([{"id": "a", "modules": [
        {"module_id": "m", "type": "_rt_shared_probe",
         "outputs": [AgentVariable(name="private_y", shared=False),
                     {"name": "public_y"}]}]}])
    vars_ = mas.agents["a"].get_module("m").vars
    return [vars_["private_y"].shared, vars_["public_y"].shared]


SCENARIOS = {
    "event_order": _env_order,
    "call_at": _call_at,
    "stop_freezes_clock": _stop,
    "alias_and_source_matching": _alias_source,
    "bus_crosses_agents_only_when_shared": _bus,
    "local_mas_runs_modules": _local_mas,
    "second_run_continues": _second_run,
    "variable_store_and_sharing": _variable_sharing,
    "communicators_skipped": _communicators_skipped,
    "duplicate_agent_ids": _duplicate_agents,
    "shared_flag": _shared_flag,
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_runtime_event_logs_match(scenario):
    ref, port = (SCENARIOS[scenario](pkg) for pkg in PACKAGES)
    assert port == ref
    assert port, "the scenario recorded nothing"
