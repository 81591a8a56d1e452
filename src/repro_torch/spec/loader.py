"""Load WorkloadSpecs from JSON files (the ``--spec workload.json``
path every launch CLI shares, and what ``tools/validate_spec.py``
lints).  A loaded spec is validated immediately — a committed example
spec that drifted from the schema fails here with structured errors,
never deep inside a launcher.
"""
from __future__ import annotations

import json

from repro_torch.spec.workload import SpecError, WorkloadSpec


def load_spec(path: str) -> WorkloadSpec:
    """Read + strict-parse + validate one spec file."""
    with open(path) as f:
        raw = json.load(f)
    spec = WorkloadSpec.from_dict(raw)      # raises SpecError on drift
    return spec.validate()


def check_spec(path: str):
    """Lint one spec file: returns (spec_or_None, structured errors)."""
    try:
        with open(path) as f:
            raw = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return None, [{"field": path, "code": "unreadable",
                       "message": str(e)}]
    try:
        spec = WorkloadSpec.from_dict(raw)
    except SpecError as e:
        return None, e.errors
    errors = list(spec.errors())
    # round-trip: what we parsed must serialize back to an equal spec
    if WorkloadSpec.from_dict(spec.to_dict()) != spec:
        errors.append({"field": path, "code": "round-trip",
                       "message": "to_dict/from_dict round-trip drifted"})
    return spec, errors
