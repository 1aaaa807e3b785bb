"""Schema validation for exported ``trace.json`` and run manifests.

``python -m repro_torch.obs trace.json --require serve`` (or ``python -m
repro_torch.obs.validate``) asserts that a traced run produced a loadable
Perfetto timeline with the span set a profile names.  Hand-rolled checks,
not jsonschema.  A copy of the reference's ``obs/validate.py``; the
manifest keys are the port's (``sinks.MANIFEST_KEYS``).
"""
from __future__ import annotations

import json

from repro_torch.obs.sinks import MANIFEST_KEYS

# required event-name sets per profile; "a|b" means any-of
REQUIRED = {
    "serve": (
        "serve.decode_tick",
        "serve.admit",
        "refresh.micro_chunk",
        "refresh.flip|refresh.flip_deferred",
    ),
    "serve_ec": (
        "serve.decode_tick",
        "refresh.micro_chunk",
        "refresh.flip|refresh.flip_deferred",
        "sampler.sync_collective",
    ),
    "executor": ("executor.chunk",),
}

_PHASES = {"X", "i", "M"}


def validate_manifest(manifest) -> list:
    errs = []
    if not isinstance(manifest, dict):
        return [f"manifest is {type(manifest).__name__}, not dict"]
    for key in MANIFEST_KEYS:
        if key not in manifest:
            errs.append(f"manifest missing key {key!r}")
    if not isinstance(manifest.get("device_count", 0), int):
        errs.append("manifest device_count not int")
    return errs


def validate_trace(obj, required: tuple = ()) -> list:
    """Return a list of schema violations (empty list == valid).

    ``obj`` is a parsed trace dict or a path to one.  ``required`` names
    must each appear among event names; a name containing ``|`` is
    satisfied by any alternative.
    """
    if isinstance(obj, (str, bytes)) or hasattr(obj, "read_text"):
        with open(obj) as f:
            obj = json.load(f)
    errs = []
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    names = set()
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errs.append(f"event {i} not an object")
            continue
        ph = ev.get("ph")
        if ph not in _PHASES:
            errs.append(f"event {i} ({ev.get('name')!r}): bad ph {ph!r}")
        if not isinstance(ev.get("name"), str):
            errs.append(f"event {i}: missing name")
        if "pid" not in ev or "tid" not in ev:
            errs.append(f"event {i} ({ev.get('name')!r}): missing pid/tid")
        if ph == "X":
            if not isinstance(ev.get("ts"), (int, float)):
                errs.append(f"event {i} ({ev.get('name')!r}): X without numeric ts")
            if not isinstance(ev.get("dur"), (int, float)) or ev.get("dur", -1) < 0:
                errs.append(f"event {i} ({ev.get('name')!r}): X without non-negative dur")
        if ph == "i" and not isinstance(ev.get("ts"), (int, float)):
            errs.append(f"event {i} ({ev.get('name')!r}): instant without numeric ts")
        if ph != "M":
            names.add(ev.get("name"))
    for req in required:
        if not any(alt in names for alt in req.split("|")):
            errs.append(f"required event {req!r} absent (have {sorted(n for n in names if n)})")
    other = obj.get("otherData", {})
    if "manifest" in other:
        errs.extend(validate_manifest(other["manifest"]))
    else:
        errs.append("otherData.manifest missing")
    return errs


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="validate a repro_torch trace.json")
    ap.add_argument("path")
    ap.add_argument("--require", default=None,
                    help="profile name (%s) or comma-list of event names"
                    % "/".join(sorted(REQUIRED)))
    ns = ap.parse_args(argv)
    required: tuple = ()
    if ns.require:
        required = REQUIRED.get(ns.require) or tuple(ns.require.split(","))
    errs = validate_trace(ns.path, required=required)
    if errs:
        for e in errs:
            print(f"INVALID: {e}")
        return 1
    print(f"OK: {ns.path} valid" + (f" (profile {ns.require})" if ns.require else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
