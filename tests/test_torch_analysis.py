"""The port's analysis tools: the determinism linter, scoped to the port's
own package, and the sim-time race detector, run on the port's replay
engine.  Lint findings must equal the reference linter's on the same
sources; the race detector must find its planted races and pass the
port's engine."""
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import lint as jlint  # noqa: E402
from repro_torch.analysis import lint, races  # noqa: E402
from repro_torch.sim import (ForkOnDemand, ReplayEngine,  # noqa: E402
                             SimFunction, spike_660323)
from repro_torch.sim.engine import build_cluster  # noqa: E402
from repro_torch.sim.events import EventLoop  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
PORT_SIM_CRITICAL = [str(REPO / "src/repro_torch" / p) for p in
                     ("sim", "net", "placement", "fork", "platform",
                      "memory")]

SOURCES = [
    "import time\nt = time.monotonic()\n",
    "import time\ndef f(clock=time.monotonic): pass\n",
    "from time import perf_counter\nx = perf_counter()\n",
    "import time\nt = time.monotonic()  # sim-ok: wall-clock -- host\n",
    "import time\n# sim-ok: wall-clock -- spans\n# more\nt = time.time()\n",
    "import time\na = 1  # sim-ok: wall-clock\nt = time.monotonic()\n",
    "import datetime\nts = datetime.datetime.now()\n",
    "import datetime\nts = datetime.datetime.now(tz)\n",
    "import random\nx = random.random()\ny = random.Random(7)\n",
    "import random\nx = random.Random()\nz = random.SystemRandom()\n",
    "import numpy as np\nx = np.random.rand(3)\nr = np.random.default_rng(0)\n",
    "import secrets\nk = secrets.token_bytes(8)\n",
    "for x in {1, 2}:\n    pass\ns = set()\nfor x in sorted(s):\n    pass\n",
    "s = {1}\nys = [x for x in s]\n",
    "s = {1.0}\nt = sum(x * 2 for x in s)\nu = sum([1.0])\n",
    "d = {}\nfor k, v in d.items():\n    pass\n",
    "for u in conn.users:\n    pass\n",
]


def _shape(findings):
    return [(f.line, f.col, f.rule, f.suppressed, f.message)
            for f in findings]


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("i", range(len(SOURCES)))
def test_lint_findings_match_reference(i, strict):
    src = SOURCES[i]
    kw = {"strict": strict, "extra_set_attrs": {"users"}}
    assert _shape(lint.lint_source(src, **kw)) == \
        _shape(jlint.lint_source(src, **kw))


def test_lint_scopes_the_port_package():
    """The port's linter treats ``repro_torch/<sim-critical>/`` as
    sim-critical, and the reference's tree as out of its scope."""
    assert lint.is_sim_critical(REPO / "src/repro_torch/net/transport.py")
    assert lint.is_sim_critical(REPO / "src/repro_torch/sim/events.py")
    assert lint.is_sim_critical(REPO / "src/repro_torch/placement/route.py")
    assert not lint.is_sim_critical(
        REPO / "src/repro_torch/core/instance.py")
    assert not lint.is_sim_critical(REPO / "src/repro/sim/events.py")
    assert not lint.is_sim_critical(REPO / "chip_smoke.py")


def test_lint_port_tree_is_clean():
    found, checked = lint.lint_paths(PORT_SIM_CRITICAL, everything=True)
    active = [f for f in found if not f.suppressed]
    assert active == [], "\n".join(f.format() for f in active)
    assert checked >= 30
    assert sum(1 for f in found if f.suppressed) >= 5
    # without --all, the same files are all sim-critical
    assert lint.lint_paths(PORT_SIM_CRITICAL)[1] == checked


def test_lint_flags_planted_wall_clock_in_the_port(tmp_path, capsys):
    """A wall-clock call planted in a copy of the port's sim package is
    found by default (the path is sim-critical); planted under the
    reference's package name it is out of scope."""
    port_copy = tmp_path / "repro_torch" / "sim"
    port_copy.mkdir(parents=True)
    src = (REPO / "src/repro_torch/sim/events.py").read_text()
    (port_copy / "events.py").write_text(
        src + "\n\ndef stamp():\n    import time\n    return time.time()\n")
    found, checked = lint.lint_paths([str(tmp_path)])
    active = [f for f in found if not f.suppressed]
    assert checked == 1
    assert [f.rule for f in active] == ["wall-clock"]
    assert lint.main(["--json", str(tmp_path)]) == 1
    out = json.loads(capsys.readouterr().out)
    assert out["active"] == 1 and out["files_checked"] == 1
    ref_copy = tmp_path / "other" / "repro" / "sim"
    ref_copy.mkdir(parents=True)
    (port_copy / "events.py").rename(ref_copy / "events.py")
    assert lint.lint_paths([str(tmp_path)]) == ([], 0)


def test_lint_cli_default_path_is_the_port():
    import inspect
    assert '"src/repro_torch"' in inspect.getsource(lint.main)


# ---------------------------------------------------------------------------
# race detector
# ---------------------------------------------------------------------------


def _planted_race_run(tiebreak_seed, *, cascade=False):
    loop = EventLoop(tiebreak_seed=tiebreak_seed)
    state = {}

    def write(v):
        first = "winner" not in state
        state["winner"] = v
        if cascade and first and v == "b":
            loop.after(1.0, lambda: None, label="b-followup")
    loop.at(1.0, write, "a", label="write-a")
    loop.at(1.0, write, "b", label="write-b")
    loop.run()
    return list(loop.log), {"winner": state["winner"],
                            "event_log_digest": "ignored"}


def test_race_detector_finds_planted_race():
    report = races.compare_runs(lambda ts: _planted_race_run(ts),
                                seeds=range(1, 6))
    assert report.racy
    assert report.changed_keys == ["winner"]
    assert report.first_divergence is None
    assert "RACE" in report.describe()
    cascade = races.compare_runs(
        lambda ts: _planted_race_run(ts, cascade=True), seeds=range(1, 6))
    assert cascade.racy and cascade.first_divergence["time"] == 2.0


def _spike_engine(device, tiebreak_seed=None, sanitize=False):
    fn = SimFunction("spike", state_bytes=16 * 128 * 4, touch_frac=0.1,
                     exec_s=0.030, coldstart_s=0.167, hold_s=60.0)
    net, nodes = build_cluster(8, page_elems=128, sanitize=sanitize,
                               device=device)
    return ReplayEngine(spike_660323(scale=1), ForkOnDemand(replicas=2),
                        [fn], network=net, nodes=nodes, seed=11,
                        page_elems=128, tiebreak_seed=tiebreak_seed)


@pytest.mark.parametrize("device", [None, "cpu"])
def test_race_detector_passes_the_port_engine(device):
    report = races.detect(lambda ts: _spike_engine(device, ts), seeds=(1, 2))
    assert not report.racy, report.describe()


def test_race_detector_digest_matches_reference():
    """The reference's detector on its own engine and the port's on the
    port's reach the same semantic digest."""
    from repro.analysis import races as jraces
    from repro.sim import ForkOnDemand as JFork, ReplayEngine as JEngine
    from repro.sim import SimFunction as JFn, spike_660323 as jspike
    from repro.sim.engine import build_cluster as jbuild

    def jfactory(ts):
        fn = JFn("spike", state_bytes=16 * 128 * 4, touch_frac=0.1,
                 exec_s=0.030, coldstart_s=0.167, hold_s=60.0)
        net, nodes = jbuild(8, page_elems=128)
        return JEngine(jspike(scale=1), JFork(replicas=2), [fn],
                       network=net, nodes=nodes, seed=11, page_elems=128,
                       tiebreak_seed=ts)
    ref = jraces.detect(jfactory, seeds=(1,))
    port = races.detect(lambda ts: _spike_engine("cpu", ts), seeds=(1,))
    assert port.baseline_digest == ref.baseline_digest


def test_simsan_replay_on_device_pools_is_digest_identical():
    plain = _spike_engine("cpu").run().summary()
    eng = _spike_engine("cpu", sanitize=True)
    assert eng.run().summary() == plain
    stats = eng.net.sanitizer.stats()
    assert stats["checks"] > 100 and stats["pending_payloads"] == 0


def test_races_cli_runs_on_torch_cpu_pools(capsys):
    rc = races.main(["--smoke", "--scale", "1", "--nodes", "4",
                     "--tiebreak-seeds", "1", "--device", "cpu", "--json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["racy"] is False and out["seeds_tried"] == [1]
