"""The port's trace sink and validator against the reference's, on the CPU.

``repro_torch.obs`` copies ``repro/obs/{sinks,validate,__main__}.py``
(``JsonlSink``, ``REQUIRED``, ``validate_manifest``, ``validate_trace``,
``python -m repro_torch.obs``) with the port's own ``MANIFEST_KEYS``
(``torch_version`` and ``cuda_version`` where the reference has
``jax_version``).  On the trace dicts of ``tests/test_obs.py``
(``TestExportAndValidate`` and ``TestTracedServe``, here made by the
port's tracer and engine) both validators give the same errors, apart from
the manifest keys; the JSONL streams are line for line the reference's;
the CLI's exit codes and lines are the reference's; and a trace exported
by ``repro_torch.launch.serve --engine --refresh-every 2 --trace`` passes
``--require serve``.
"""
from __future__ import annotations

import json
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.obs import sinks as jsinks
from repro.obs import validate as jvalidate
from repro_torch import _interop, core
from repro_torch import obs
from repro_torch.core import rng
from repro_torch.launch import serve as serve_launch
from repro_torch.models import get_model, tree_map
from repro_torch.obs import sinks, validate
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.engine import (RefreshScheduler, ServeEngine, SnapshotRegistry,
                                      synthetic_trace)

from test_serve_engine import member_stack, tiny_cfg

STUB = {k: (1 if k == "device_count" else "x") for k in sinks.MANIFEST_KEYS}
JSTUB = {k: (1 if k == "device_count" else "x") for k in jsinks.MANIFEST_KEYS}


@pytest.fixture(autouse=True)
def _tracing_off():
    yield
    obs_trace.disable()


def _manifest_errs(errs):
    return sorted(e for e in errs if e.startswith("manifest missing key"))


def _same_verdicts(obj, required=()):
    """Both validators on ``obj`` (its manifest the port's): the same errors
    apart from the reference's missing ``jax_version``; with the
    reference's manifest, the port's missing torch and CUDA versions."""
    got = validate.validate_trace(obj, required)
    want = jvalidate.validate_trace(obj, required)
    assert [e for e in got] == [e for e in want if "jax_version" not in e]
    if "manifest" in obj.get("otherData", {}) and isinstance(obj.get("traceEvents"), list):
        assert _manifest_errs(want) == ["manifest missing key 'jax_version'"]
        swapped = {**obj, "otherData": {**obj["otherData"], "manifest": JSTUB}}
        assert _manifest_errs(validate.validate_trace(swapped, required)) == [
            "manifest missing key 'cuda_version'", "manifest missing key 'torch_version'"]
        assert [e for e in validate.validate_trace(swapped, required)
                if "manifest" not in e] == [e for e in jvalidate.validate_trace(swapped, required)
                                           if "manifest" not in e]
    return got


def test_manifest_keys_and_profiles():
    assert sinks.MANIFEST_KEYS == tuple(
        k for key in jsinks.MANIFEST_KEYS
        for k in (("torch_version", "cuda_version") if key == "jax_version" else (key,)))
    assert validate.REQUIRED == jvalidate.REQUIRED
    m = sinks.run_manifest()
    assert validate.validate_manifest(m) == []
    assert isinstance(m["device_count"], int) and m["backend"] in ("cpu", "cuda")
    assert validate.validate_manifest([]) == jvalidate.validate_manifest([])
    bad = {**STUB, "device_count": "1"}
    assert validate.validate_manifest(bad) == ["manifest device_count not int"]
    assert jvalidate.validate_manifest({**JSTUB, "device_count": "1"}) == [
        "manifest device_count not int"]
    assert obs.JsonlSink is sinks.JsonlSink and obs.validate_trace is validate.validate_trace


def _chrome():
    tr = obs_trace.Tracer(capacity=16)
    with tr.span("serve.decode_tick", cat="serve", step=0):
        tr.instant("alloc.reserve", cat="alloc", slot=1)
    return tr.to_chrome(manifest=STUB)


def _executor_only():
    tr = obs_trace.Tracer(capacity=8)
    tr.instant("executor.chunk", cat="executor")
    return tr.to_chrome(manifest=STUB)


BAD = {
    "traceEvents": [
        {"ph": "Z", "name": "a", "pid": 0, "tid": 0},  # bad phase
        {"ph": "X", "name": "b", "pid": 0, "tid": 0, "ts": 0.0},  # no dur
        {"ph": "i", "pid": 0, "tid": 0, "ts": 1.0, "s": "t"},  # no name
        "not an event",
        {"ph": "X", "name": "c", "ts": "0", "dur": -1},  # no pid/tid, bad ts and dur
    ],
}


@pytest.mark.parametrize("case,profile,valid", [
    ("chrome", None, True), ("chrome", "serve", False), ("executor", "executor", True),
    ("executor", "serve", False), ("executor", "serve_ec", False), ("bad", None, False),
    ("bad", "executor", False), ("no_events", None, False)])
def test_validators_agree_on_test_obs_traces(case, profile, valid):
    obj = {"chrome": _chrome, "executor": _executor_only, "bad": lambda: BAD,
           "no_events": lambda: {"otherData": {"manifest": STUB}}}[case]()
    errs = _same_verdicts(obj, validate.REQUIRED[profile] if profile else ())
    assert (errs == []) == valid, errs
    if case == "chrome":
        evs = obj["traceEvents"]
        assert evs[0]["ph"] == "M" and evs[0]["name"] == "process_name"


def test_export_round_trip_through_path(tmp_path):
    tr = obs_trace.Tracer(capacity=4)
    tr.instant("serve.admit", cat="serve")
    path = tmp_path / "trace.json"
    tr.export(path, manifest=STUB)
    assert validate.validate_trace(str(path)) == [] == validate.validate_trace(path)


def _refresh_engine(sampler, sync_every=None, k=2):
    """``tests/test_obs.py::_refresh_engine`` on the port: the reference's
    tiny config and member stack, SGLD or EC-SGHMC refreshing every 2
    ticks in chunks of 4 steps."""
    jcfg = tiny_cfg()
    from repro.models import get_model as jget_model

    cfg = _interop.config_from(jcfg)
    model = get_model(cfg)
    stack = _interop.tree_from_numpy(jax.tree.map(np.asarray,
                                                  member_stack(jcfg, jget_model(jcfg), k)))
    center = tree_map(lambda x: x[0], stack)
    grad_fn = lambda p: tree_map(lambda x, c: 2500.0 * (x - c), p, center)  # noqa: E731
    start = tree_map(lambda x: x[0][None].expand(x.shape).clone(), stack)
    reg = SnapshotRegistry(stack)
    sched = RefreshScheduler(reg, sampler, grad_fn, start, key=rng.key(8), chunk_steps=4,
                             sync_every=sync_every)
    engine = ServeEngine(cfg, model, reg, num_slots=2, max_seq=24, refresher=sched,
                         refresh_every=2, device="cpu")
    reqs = synthetic_trace(6, vocab_size=cfg.vocab_size, prompt_lens=(5,), max_new=8,
                           mean_interarrival=1.5, seed=4)
    return engine, reqs


def test_traced_serve_with_live_refresh_is_valid(tmp_path):
    tr = obs_trace.enable(capacity=1 << 14)
    engine, reqs = _refresh_engine(core.sgld(step_size=8e-5))
    engine.run(reqs)
    obj = tr.export(tmp_path / "trace.json")
    assert _same_verdicts(obj, validate.REQUIRED["serve"]) == []
    # the EC profile wants the sync instants an SGLD run has none of
    errs = _same_verdicts(obj, validate.REQUIRED["serve_ec"])
    assert len(errs) == 1 and "sampler.sync_collective" in errs[0]


def test_traced_ec_serve_reconstructs_sync_collectives(tmp_path):
    tr = obs_trace.enable(capacity=1 << 14)
    engine, reqs = _refresh_engine(core.ec_sghmc(step_size=8e-5, alpha=1.0, sync_every=4),
                                   sync_every=4)
    engine.run(reqs)
    obj = tr.export(tmp_path / "trace.json")
    assert _same_verdicts(obj, validate.REQUIRED["serve_ec"]) == []
    steps = [e["args"]["step"] for e in obj["traceEvents"]
             if e.get("name") == "sampler.sync_collective"]
    assert steps and steps == sorted(steps) and all(s % 4 == 0 for s in steps)


def test_jsonl_sink_lines_match_reference(tmp_path):
    streams = {}
    for name, mod, manifest in (("port", sinks, STUB), ("ref", jsinks, STUB)):
        path = tmp_path / f"{name}.jsonl"
        sink = mod.JsonlSink(path)
        sink.header(manifest)
        sink.metrics({"a_total": 1, "h": {"count": 2}}, step=7)
        sink.metrics({"a_total": 3})
        sink.summary({"a_total": 2}, bench="x")
        streams[name] = path.read_text()
    assert streams["port"] == streams["ref"]
    # without a header the first write stamps the port's own manifest
    path = tmp_path / "run.jsonl"
    sink = sinks.JsonlSink(path)
    sink.metrics({"a_total": 1}, step=7)
    sink.summary({"a_total": 2}, bench="x")
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert [rec["kind"] for rec in lines] == ["manifest", "metrics", "summary"]
    assert validate.validate_manifest({k: v for k, v in lines[0].items() if k != "kind"}) == []
    assert lines[1]["step"] == 7 and lines[2]["bench"] == "x"


def _cli(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("case,require", [("valid", None), ("valid", "executor"),
                                          ("valid", "serve"), ("valid", "serve.admit,x.y"),
                                          ("bad", None)])
def test_cli_matches_reference(tmp_path, capsys, case, require):
    obj = _executor_only() if case == "valid" else BAD
    port_path, ref_path = tmp_path / "trace.json", tmp_path / "ref" / "trace.json"
    ref_path.parent.mkdir()
    port_path.write_text(json.dumps(obj))
    ref_obj = {**obj, "otherData": {"manifest": JSTUB}} if "otherData" in obj else obj
    ref_path.write_text(json.dumps(ref_obj))
    extra = ["--require", require] if require else []
    rc, out = _cli(validate.main, [str(port_path)] + extra, capsys)
    jrc, jout = _cli(jvalidate.main, [str(ref_path)] + extra, capsys)
    assert rc == jrc and rc == (0 if case == "valid" and require in (None, "executor") else 1)
    assert out == [line.replace(str(ref_path), str(port_path)) for line in jout]


def test_served_trace_passes_require_serve(tmp_path):
    """The launcher's engine with overlapped refresh on the CPU, traced,
    checked by ``python -m repro_torch.obs`` (a fresh interpreter)."""
    path = tmp_path / "serve_trace.json"
    serve_launch.main(["--arch", "qwen3-0.6b", "--smoke", "--engine", "--ensemble", "2",
                       "--refresh-every", "2", "--requests", "4", "--gen", "4",
                       "--prompt-len", "8", "--trace", str(path), "--device", "cpu"])
    obs_trace.disable()
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs", str(path), "--require",
                          "serve"], capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(sinks.__file__).rsplit("/repro_torch/", 1)[0],
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip() == f"OK: {path} valid (profile serve)"
    bad = subprocess.run([sys.executable, "-m", "repro_torch.obs", str(path), "--require",
                          "serve_ec"], capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(sinks.__file__).rsplit("/repro_torch/", 1)[0],
                              "PATH": "/usr/bin:/bin"})
    assert bad.returncode == 1 and bad.stdout.startswith(
        "INVALID: required event 'sampler.sync_collective' absent")
